"""The factorization order of kernel K9 (``csrc/ba_solve.cu``: LU with partial
pivoting in panels of 8 columns, in float64), through its plain mirror
``dsopp_tpu_torch/testing/blocked_lu.py``, against the JAX package.

On the damped pose system of ``_solve_step``'s inputs (a window of 10 slots
with 7 frames and one of 17 slots with 13, so dead slots; 120×160; λ in {1e-5,
1e-2}; an empty and a filled ledger), assembled by the port in float64:

* the mirror's solution against ``jnp.linalg.solve`` (JAX on the CPU in
  float64) on the same system, 1e-10 relative to its norm, and the step it
  gives against JAX's ``_solve_step``, 1e-9;
* the same system with its live rows in a random order, so that partial
  pivoting swaps rows at nearly every column, the first included: the same
  solution, 1e-10;
* on both, the pivot rows and the bits of the solution equal to those of the
  column-by-column LU (the kernel's earlier order);
* on random systems of 16..168 unknowns (K9 takes up to 21 slots), the same
  equality and ``np.linalg.solve``'s solution within 1e-10.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.solvers import pba as jpba
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import build_test_window
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.testing import blocked_lu

from tests._torch_port import to_np, to_torch, window_fields

# name -> (slots, frames, landmarks per frame)
SIZES = {"k10": (10, [0, 2, 3, 5, 6, 8, 9], 24), "k17": (17, list(range(13)), 24)}


def _filled_ledger(window, rng):
    """The window with a positive semi-definite ledger on its valid frames."""
    kb = window.num_slots * jpba.BLOCK
    live = np.repeat(np.asarray(window.frame_valid), jpba.BLOCK)
    a = rng.normal(size=(kb, kb)) * live[None, :]
    zero = jnp.zeros_like
    return dataclasses.replace(
        window, h_marg=jnp.asarray(1e2 * (a.T @ a)), h_marg_lo=zero(window.h_marg),
        b_marg=jnp.asarray(10.0 * rng.normal(size=kb) * live), b_marg_lo=zero(window.b_marg))


@pytest.fixture(scope="module", params=list(SIZES))
def problem(request):
    slots, frames, n_lm = SIZES[request.param]
    seq = render_sequence(num_frames=max(frames) + 1, height=120, width=160)
    window = build_test_window(seq, frames, num_landmarks=n_lm, slots=slots,
                               pose_noise=3e-3, idepth_noise=0.05, seed=7)
    assert int(window.frame_valid.sum()) == len(frames) < slots      # dead slots
    rng = np.random.default_rng(23)
    eps = rng.normal(size=(slots, 8)) * np.array([2e-3] * 6 + [1e-2, 0.5])
    eps *= np.asarray(window.frame_valid & ~window.frame_fixed)[:, None]
    idepth = window.lm_idepth * jnp.asarray(1.0 + 0.02 * rng.normal(size=(slots, n_lm)))
    opts = jpba.PBAOptions()
    moved = dataclasses.replace(window, eps=jnp.asarray(eps))
    fej = jpba._fej_cache(moved, seq.camera)
    ev = jpba._evaluate(moved, seq.camera, moved.eps, idepth, jpba.active_lm_mask(moved), opts)
    sys = jpba._linearize_from_ev(moved, fej, ev, moved.eps, opts)
    return dict(windows={"empty": moved, "filled": _filled_ledger(moved, rng)}, sys=sys,
                idepth=idepth, slots=slots)


def _assembled(problem, ledger, lam):
    """The port's float64 assembly of the step system → (H, b, live, the
    JAX window, the port's window, the port's system)."""
    window = problem["windows"][ledger]
    tw = convert.window(window_fields(window))
    sys = convert.linear_system({k: np.asarray(v) for k, v in problem["sys"]._asdict().items()})
    h, b, live = tpba._assemble_step_system(tw, sys, tw.eps, lam)
    return h, b, live, window, tw, sys


def _rel(a, b):
    a, b = to_np(a), to_np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _shuffled_rows(h, b, live, seed):
    """(P h, P b) with P a random order of the live rows whose first live row
    moves."""
    rows = torch.nonzero(live).flatten()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(rows.numel())
    while perm[0] == 0:
        perm = rng.permutation(rows.numel())
    order = torch.arange(h.shape[0])
    order[rows] = rows[torch.as_tensor(perm)]
    return h[order], b[order]


@pytest.mark.parametrize("ledger", ["empty", "filled"])
@pytest.mark.parametrize("lam", [1e-5, 1e-2])
def test_blocked_lu_matches_jax_solve(problem, lam, ledger):
    h, b, live, window, tw, sys = _assembled(problem, ledger, lam)
    assert h.dtype == torch.float64 and not bool(live.all())
    x, _ = blocked_lu.blocked_solve(h, b)
    x_jax = jnp.linalg.solve(jnp.asarray(to_np(h)), jnp.asarray(to_np(b)))
    assert _rel(x, x_jax) <= 1e-10
    # the step the mirror gives, against JAX's _solve_step on the same inputs
    step = torch.where(torch.isfinite(x) & live, -x, torch.zeros_like(x))
    eps_j = jpba._solve_step(window, problem["sys"], window.eps, problem["idepth"], lam,
                             jpba.PBAOptions())[0]
    step_j = to_torch(eps_j).reshape(-1) - tw.eps.reshape(-1)
    assert float(step_j.abs().max()) > 0
    assert _rel(step, step_j) <= 1e-9
    assert not bool(step[~live].any())


@pytest.mark.parametrize("case", ["assembled", "rows shuffled"])
def test_blocked_lu_pivots_like_the_unblocked_lu(problem, case):
    h, b, live, _, _, _ = _assembled(problem, "filled", 1e-5)
    x_ref = np.linalg.solve(to_np(h), to_np(b))
    if case == "rows shuffled":
        h, b = _shuffled_rows(h, b, live, problem["slots"])
    x, pivots = blocked_lu.blocked_solve(h, b)
    x_u, pivots_u = blocked_lu.unblocked_solve(h, b)
    assert pivots == pivots_u
    assert torch.equal(x, x_u)
    swaps = sum(p != i for i, p in enumerate(pivots))
    if case == "rows shuffled":
        assert pivots[0] != 0 and swaps > h.shape[0] // 2, swaps
        x_jax = jnp.linalg.solve(jnp.asarray(to_np(h)), jnp.asarray(to_np(b)))
        assert _rel(x, x_jax) <= 1e-10
    assert _rel(x, x_ref) <= 1e-10


@pytest.mark.parametrize("kb", [16, 80, 136, 168])
def test_blocked_lu_on_random_systems(kb):
    rng = np.random.default_rng(kb)
    a = rng.normal(size=(kb, kb))
    h = torch.tensor(a @ a.T / kb + 0.1 * np.eye(kb))[torch.as_tensor(rng.permutation(kb))]
    b = torch.tensor(rng.normal(size=kb))
    x, pivots = blocked_lu.blocked_solve(h, b)
    x_u, pivots_u = blocked_lu.unblocked_solve(h, b)
    assert pivots == pivots_u and torch.equal(x, x_u)
    assert _rel(x, np.linalg.solve(to_np(h), to_np(b))) <= 1e-10
