"""The order of summation of kernel K8 (``csrc/ba_linearize.cu``: f64 sums
on the tensor cores, the pair blocks per (pair, tile) and warp, the Schur
sums per anchor frame, an 8-lane tree per output entry), through its plain
mirror ``dsopp_tpu_torch/testing/linearize_order.py``, against the port's
plain version and the JAX package.

On a 4-frame window (136 landmarks a frame: two pair tiles, a ragged chunk)
and on the dense operating point's 17 slots with 13 frames (dead slots, three
frames a reduction lane), moved off the linearization point, with and
without ``marg_pass``:

* with float64 operands the mirror against ``_linearize_from_ev_plain`` in
  float64 and against JAX's ``_linearize_from_ev`` (CPU, x64): every output
  within 1e-12 of its largest entry.  Both compute the same float64
  arithmetic; only the order of the long sums differs, and those cancel
  down to no less than ~1e-4 of the largest entry here, so 1e-12 leaves
  room for their rounding (~1e-16 relative a term) and catches any misplaced
  or missing term;
* with float32 operands (the card's), against the plain version in float64 on
  the same float32 inputs: every output within 5e-7 relative (Frobenius).
  The mirror rounds each Jacobian entry, ``w J``, the 8-point sums and its
  outputs in float32 (~6e-8 each), as the kernel does, and its long sums
  add nothing measurable: it lands within 8e-8 here, the plain float32
  version (float32 sums) within 2.2e-7.  The card's gate (1e-4 against the
  plain float32 version) is wider still.
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
from dsopp_tpu_torch.testing import linearize_order, parity

from tests._torch_port import window_fields

# name -> (slots, frames, landmarks per frame)
SIZES = {"k4": (4, [0, 2, 4, 6], 136), "k17": (17, list(range(13)), 40)}


def _fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module", params=list(SIZES))
def problem(request):
    slots, frames, n_lm = SIZES[request.param]
    seq = render_sequence(num_frames=max(frames) + 1, height=120, width=160)
    window = build_test_window(seq, frames, num_landmarks=n_lm, slots=slots,
                               pose_noise=3e-3, idepth_noise=0.05, seed=11)
    rng = np.random.default_rng(5)
    eps = rng.normal(size=(slots, 8)) * np.array([2e-3] * 6 + [1e-2, 0.5])
    eps *= np.asarray(window.frame_valid & ~window.frame_fixed)[:, None]
    marg = np.zeros(slots, bool)
    marg[1] = True
    window = dataclasses.replace(
        window, eps=jnp.asarray(eps), frame_marg=jnp.asarray(marg),
        affine0=jnp.asarray(rng.normal(size=(slots, 2)) * [0.02, 1.0]),
        lm_valid=window.lm_valid & jnp.asarray(rng.random((slots, n_lm)) < 0.9))
    idepth = window.lm_idepth * jnp.asarray(1.0 + 0.02 * rng.normal(size=(slots, n_lm)))
    opts = jpba.PBAOptions()
    fej = jpba._fej_cache(window, seq.camera)
    ev = jpba._evaluate(window, seq.camera, window.eps, idepth, jpba.active_lm_mask(window), opts)
    jax_sys = {m: jpba._linearize_from_ev(window, fej, ev, window.eps, opts, marg_pass=m)
               for m in (False, True)}
    return dict(window=window_fields(window), fej=_fields(fej), ev=_fields(ev),
                jax_sys={m: _fields(s) for m, s in jax_sys.items()})


def _port(problem, dtype):
    tw = convert.window(problem["window"], dtype=dtype)
    return (tw, convert.fej_cache(problem["fej"], dtype=dtype),
            convert.evaluation(problem["ev"], dtype=dtype), tw.eps)


def _within(got, want, tol, name):
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert scale > 0, name
    assert err <= tol * scale, (name, err / scale)


@pytest.mark.parametrize("marg_pass", [False, True])
def test_mirror_matches_plain_and_jax_in_f64(problem, marg_pass):
    args = _port(problem, torch.float64)
    opts = tpba.PBAOptions()
    mirror = linearize_order.linearize(*args, opts, marg_pass)
    plain = tpba._linearize_from_ev_plain(*args, opts, marg_pass)
    jax = convert.linear_system(problem["jax_sys"][marg_pass])
    assert int((plain.inv_hdd > 0).sum()) > 100
    for name in tpba.LinearSystem._fields:
        got = getattr(mirror, name)
        assert got.shape == getattr(plain, name).shape and got.dtype == torch.float64, name
        _within(got, getattr(plain, name), 1e-12, name)
        _within(got, getattr(jax, name), 1e-12, name)


@pytest.mark.parametrize("marg_pass", [False, True])
def test_mirror_in_f32_matches_plain_f64(problem, marg_pass):
    args = _port(problem, torch.float32)
    opts = tpba.PBAOptions()
    mirror = linearize_order.linearize(*args, opts, marg_pass)
    tw, fej, ev, eps = args
    ref = tpba._linearize_from_ev_plain(parity.to_f64(tw), parity.to_f64(fej),
                                        parity.to_f64(ev), eps.double(), opts, marg_pass)
    for name in tpba.LinearSystem._fields:
        got, want = getattr(mirror, name), getattr(ref, name)
        assert got.dtype == torch.float32, name
        rel = float((got.double() - want).norm() / want.norm())
        assert rel <= 5e-7, (name, rel)
