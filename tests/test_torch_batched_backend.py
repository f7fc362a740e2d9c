"""Port parity: the keyframe backend's solver half over a sequence axis
(``solvers/pba.py``'s ``solve_loop_sequences`` and ``marginalize_sequences``,
``tracker/marginalization.py::flags_sequences`` and
``parallel/sharded.py::solve_and_marginalize_sequences``).

The JAX package runs B windows' solve and fold as ``jax.vmap`` of one
program (``tests/parallel/test_sharded_solver.py``'s ``solve_and_marginalize``:
the LM solve, then slot 1 and its live landmarks folded into the ledger).  The
port takes S of B stacked windows, named by a host list, in one call a step
(on the card one launch a kernel for the S sequences); on the CPU each step
runs its plain version once per sequence.  The problems are
``__graft_entry__._tiny_problem``'s (4 frames, 64 landmarks, 48×48, f64), B =
3 with the inverse depths scaled by 1, 1.01 and 1.02, and S = 2 of them in
the order (2, 0).

Tolerances: against JAX's vmap those of ``tests/test_torch_parallel.py``'s
single-process solve and fold (``test_solve_loop_matches``'s 1e-7 relative,
1e-12 of the largest entry absolute, counts and statuses equal); against the
port's own per-window calls equal to the bit.  The whole file takes ~25 s on
one worker, most of it the JAX vmap's compile.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu_torch import convert
from dsopp_tpu_torch.parallel.sharded import (solve_and_marginalize,
                                              solve_and_marginalize_sequences)
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.tracker import marginalization as tmarg

from tests._torch_port import assert_close, assert_equal, window_fields

SCALES = (1.0, 1.01, 1.02)      # each sequence's inverse depths
SEQS = (2, 0)                   # S = 2 of the B = 3 sequences
SOLVE_RTOL = 1e-7
STATUS_FIELDS = ("res_status", "lm_outlier", "lm_inliers", "lm_opt_count")
CLOSE_FIELDS = ("eps", "affine0", "t_lin_q", "t_lin_t", "lm_idepth", "lm_baseline", "h_marg",
                "b_marg", "energy_marg")


def _jax_solve_and_marginalize(cam):
    """``tests/parallel/test_sharded_solver.py``'s ``solve_and_marginalize``."""
    from dsopp_tpu.solvers.pba import PBAOptions, _marginalize_device, _solve_loop_device
    from dsopp_tpu.tracker.marginalization import kept_first_perm

    opts = PBAOptions()

    def fn(w):
        w, e, n = _solve_loop_device(w, cam, opts)
        frame_flags = jnp.zeros(w.frame_valid.shape, bool).at[1].set(True)
        w = dataclasses.replace(w, frame_marg=frame_flags,
                                lm_marg_flag=w.lm_valid & frame_flags[:, None])
        perm = kept_first_perm(w.frame_valid, frame_flags)
        return _marginalize_device(w, cam, perm, opts, True, True), e, n
    return fn


@pytest.fixture(scope="module")
def problem():
    """The JAX windows, their port counterparts stacked [B], the camera, and
    JAX's vmap of the solve and fold over the S selected windows."""
    import __graft_entry__ as ge
    from dsopp_tpu.parallel.sharded import stack_windows as jax_stack

    window, cam = ge._tiny_problem(dtype=jnp.float64, landmarks=64, size=48)
    jax_windows = [dataclasses.replace(window, lm_idepth=window.lm_idepth * s) for s in SCALES]
    ref = jax.jit(jax.vmap(_jax_solve_and_marginalize(cam)))(
        jax_stack([jax_windows[b] for b in SEQS]))
    windows = pba.stack_windows([convert.window(window_fields(w)) for w in jax_windows])
    tcam = convert.pinhole(*(float(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy")),
                           np.asarray(cam.image_size))
    return dict(windows=windows, cam=tcam, ref=ref, opts=pba.PBAOptions())


@pytest.fixture(scope="module")
def batched(problem):
    return solve_and_marginalize_sequences(problem["windows"], problem["cam"], problem["opts"],
                                           SEQS)


def test_batched_solve_and_fold_matches_jax(problem, batched):
    """S = 2 of B = 3 stacked windows solved and folded in one call each
    against JAX's vmap over the same two windows."""
    w_j, e_j, n_j = problem["ref"]
    w_t, e_t, n_t = batched
    assert_equal(n_t, np.asarray(n_j))
    assert int(n_t.min()) > 0
    assert_close(e_t, np.asarray(e_j), rtol=SOLVE_RTOL)
    for z in range(len(SEQS)):
        want = convert.window({k: v[z] for k, v in window_fields(w_j).items()})
        got = pba.window_at(w_t, z)
        for name in CLOSE_FIELDS:
            assert_close(getattr(got, name), getattr(want, name), rtol=SOLVE_RTOL,
                         atol=1e-12 * max(1.0, float(getattr(want, name).abs().max())),
                         err_msg=f"{z} {name}")
        for name in STATUS_FIELDS + ("lm_valid", "frame_valid", "frame_id"):
            assert_equal(getattr(got, name), getattr(want, name), err_msg=f"{z} {name}")
        assert float(got.h_marg.abs().max()) > 0
    assert not torch.equal(w_t.lm_idepth[0], w_t.lm_idepth[1])


def _assert_windows_equal(got: pba.Window, want: pba.Window, msg):
    for f in dataclasses.fields(pba.Window):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), (msg, f.name)
        if a is not None:
            assert a.shape == b.shape and torch.equal(a, b), (msg, f.name)


def test_batched_call_equals_the_per_window_loop(problem, batched):
    """The same call on the CPU equals the per-window loop of
    ``solve_and_marginalize`` to the bit: every window field, energy, count."""
    windows, cam, opts = problem["windows"], problem["cam"], problem["opts"]
    w_t, e_t, n_t = batched
    for z, b in enumerate(SEQS):
        w, e, n = solve_and_marginalize(pba.window_at(windows, b), cam, opts)
        _assert_windows_equal(pba.window_at(w_t, z), w, b)
        assert torch.equal(e_t[z], e) and int(n_t[z]) == int(n), b


def test_each_step_equals_its_solo_call(problem):
    """The solve (with its LM log), the policy and the fold over S
    sequences, each against its solo plain call, to the bit."""
    windows, cam, opts = problem["windows"], problem["cam"], problem["opts"]
    logs = []
    solved, energy, count = pba.solve_loop_sequences(windows, cam, opts, SEQS, log=logs)
    solo = []
    for z, b in enumerate(SEQS):
        log = []
        w, e, n = pba._solve_loop_plain(pba.window_at(windows, b), cam, opts, log=log)
        solo.append(w)
        for name in pba.SOLVED_FIELDS:
            assert torch.equal(solved[name][z], getattr(w, name)), (b, name)
        assert torch.equal(energy[z], e) and int(count[z]) == int(n)
        assert logs[z] == log
    stack = pba.stack_windows(solo)
    k, m = stack.t_lin_q.shape[1], 24
    valid = torch.Generator().manual_seed(3)
    imm_valid = torch.rand((len(SEQS), k, m), generator=valid, dtype=torch.float64) < 0.5
    flags = tmarg.flags_sequences(stack, imm_valid, 1, 2, 0.5)
    for z in range(len(SEQS)):
        want = tmarg.flags_device_plain(solo[z], imm_valid[z], 1, 2, 0.5)
        for x, y in zip(flags, want):
            assert torch.equal(x[z], y), z
    frame_flags, lm_flags, new_outliers, perm = flags
    assert bool(frame_flags.any())
    flagged = stack.replace(lm_outlier=stack.lm_outlier | new_outliers, frame_marg=frame_flags,
                            lm_marg_flag=lm_flags)
    folded = pba.marginalize_sequences(flagged, cam, perm, opts)
    for z in range(len(SEQS)):
        want = pba._marginalize_device(pba.window_at(flagged, z), cam, perm[z], opts)
        _assert_windows_equal(pba.window_at(folded, z), want, z)


@pytest.mark.parametrize("seqs,what", [((3,), "out of range"), ((-1, 0), "out of range"),
                                       ((1, 1), "twice"), ((), "empty")])
@pytest.mark.parametrize("step", ["solve", "policy", "fold"])
def test_sequence_list_is_checked(problem, seqs, what, step):
    """Each batched step refuses a list with a sequence out of range, a
    duplicate, or no sequence."""
    windows, cam, opts = problem["windows"], problem["cam"], problem["opts"]
    k = windows.t_lin_q.shape[1]
    with pytest.raises(ValueError, match=what):
        if step == "solve":
            pba.solve_loop_sequences(windows, cam, opts, seqs)
        elif step == "policy":
            tmarg.flags_sequences(windows, torch.zeros((3, k, 8), dtype=torch.bool), 1, 2, 0.5,
                                  seqs)
        else:
            perm = torch.arange(k).expand(max(len(seqs), 1), k)
            pba.marginalize_sequences(windows, cam, perm, opts, seqs)


def test_mixed_shapes_are_refused(problem):
    """Windows of different landmark slots do not stack, and a stack whose
    fields disagree on the sequence axis or a sequence's shape is refused."""
    windows, cam, opts = problem["windows"], problem["cam"], problem["opts"]
    one = pba.window_at(windows, 0)
    narrow = one.replace(**{name: getattr(one, name)[..., :32] for name in (
        "lm_idepth", "lm_valid", "lm_marg_flag", "lm_outlier", "lm_inliers", "lm_opt_count",
        "lm_baseline", "res_status")}, lm_uv=one.lm_uv[:, :32], lm_patch=one.lm_patch[:, :32])
    with pytest.raises(ValueError, match="shape"):
        pba.stack_windows([one, narrow])
    with pytest.raises(ValueError, match="mixed shapes"):
        pba.solve_loop_sequences(windows.replace(lm_idepth=windows.lm_idepth[:2]), cam, opts,
                                 (0,))
    with pytest.raises(ValueError, match="mixed shapes"):
        pba.marginalize_sequences(windows.replace(res_status=windows.res_status[..., :32]), cam,
                                  torch.zeros((1, 4), dtype=torch.int64), opts, (0,))
