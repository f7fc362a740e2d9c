"""The window's pose covariances and the BA's host wrappers against the JAX
package (both f64 on the CPU), on the window of a known-pose run at 120×160
(6 frames, keyframes 0, 3 and 5) with ``estimate_uncertainty``:

* ``TrackerConfig.estimate_uncertainty`` fills ``track.connections`` for
  the same ordered pairs of keyframe ids as the JAX tracker's, after every
  keyframe but the first, with symmetric 6×6 blocks;
* ``pose_covariances`` on the JAX run's window (converted): ``cov`` and
  ``cov_rel`` within 1e-9 of their largest live entry of JAX's with moderate
  priors, and within ``parity.COV_F64_ULPS`` · ε · the system's condition
  (~2.5e10) with the default ones, where the two packages' f64
  decompositions part by ~3e-6 (each is ~1e-6 from a 40-digit one);
  ``tests/solvers/test_pba.py::test_pose_covariances_sane``'s properties;
* ``solve_window`` with ``test_torch_ba_solve.py``'s tolerances (energy,
  eps, poses, idepths and baselines 1e-7 relative, statuses and counts
  exact) and ``marginalize`` with ``test_torch_marginalization.py``'s (the
  ledger within 1e-9 of its largest entry, the compacted slots exact),
  with the flags given and read from the window, and nothing flagged.

The file runs in ~35 s on one worker, most of it the JAX run's compiles.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.solvers import pba as jpba
from dsopp_tpu.testing import render_sequence as jrender
from dsopp_tpu.tracker.monocular import MonocularTracker as JTracker
from dsopp_tpu.tracker.monocular import TrackerConfig as JConfig
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.testing import parity
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests._torch_port import assert_close, assert_equal, to_np, window_fields

CFG = dict(num_frame_slots=7, landmarks_per_frame=128, immature_per_frame=256,
           desired_points=600, frontend_points=800, keyframe_factor=3.0, window_min=3,
           window_max=5, use_rotation_perturbations=False, estimate_uncertainty=True)
FRAMES, FORCED = 6, (3, 5)
COV_RTOL = 1e-9        # of the largest live entry
SOLVE_RTOL = 1e-7      # tests/test_torch_ba_solve.py
LEDGER_RTOL = 1e-9     # tests/test_torch_marginalization.py


@pytest.fixture(scope="module")
def runs():
    seq = jrender(num_frames=FRAMES, height=120, width=160)
    cam = seq.camera
    tcam = convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size)
    jt = JTracker(cam, JConfig(**CFG), dtype=jnp.float64)
    tt = MonocularTracker(tcam, TrackerConfig(**CFG), dtype=torch.float64, device="cpu")
    keys = []
    for i in range(FRAMES):
        pose = seq.pose_t_wc(i)
        jt.tick(i, float(seq.timestamps[i]), seq.images[i],
                known_pose=JSE3(jnp.asarray(pose.q), jnp.asarray(pose.t)),
                force_keyframe=i in FORCED)
        tt.tick(i, float(seq.timestamps[i]), np.asarray(seq.images[i]),
                known_pose=convert.se3(pose.q, pose.t), force_keyframe=i in FORCED)
        keys.append((sorted(jt.track.connections), sorted(tt.track.connections)))
    return dict(seq=seq, cam=cam, tcam=tcam, jt=jt, tt=tt, keys=keys)


def test_estimate_uncertainty_fills_the_same_connections(runs):
    jt, tt = runs["jt"], runs["tt"]
    assert jt.num_keyframes == tt.num_keyframes == 3
    for i, (ref, port) in enumerate(runs["keys"]):
        assert port == ref, f"frame {i}"
    ids = [0, 3, 5]
    assert runs["keys"][-1][1] == sorted((a, b) for a in ids for b in ids if a != b)
    for key, cov in tt.track.connections.items():
        assert cov.shape == (6, 6) and np.isfinite(cov).all()
        np.testing.assert_allclose(cov, cov.T, rtol=0, atol=1e-9 * np.abs(cov).max())
        assert np.abs(cov).max() > 0


def _rel_max(a, b):
    a, b = to_np(a), np.asarray(b)
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


# moderate priors (the fixed frame's 1e8, the affine ones' 1e6) keep the
# reduced system's condition near 5e4; the default ones (1e16, 1e12, 1e8) put
# it near 2.5e10, where an f64 decomposition rounds the covariance by ~ε·cond
PRIORS = {"moderate": dict(fixed_reg=1e8, affine_reg_a=1e6, affine_reg_b=1e6), "default": {}}


@pytest.mark.parametrize("priors", list(PRIORS))
def test_pose_covariances_match_jax(runs, priors):
    """``cov`` and ``cov_rel`` against JAX's: within 1e-9 of their largest live
    entry with moderate priors; with the default ones within
    ``parity.COV_F64_ULPS`` · ε · the system's condition (the two packages'
    decompositions part there by ~3e-6, the system itself within 1e-18 of
    its largest entry)."""
    jwin = runs["jt"].window
    out_j = jpba.pose_covariances(jwin, runs["cam"], jpba.PBAOptions(**PRIORS[priors]))
    win = convert.window(window_fields(jwin))
    opts = tpba.PBAOptions(**PRIORS[priors])
    out = tpba.pose_covariances(win, runs["tcam"], opts)
    k = win.num_slots
    live = to_np(win.frame_valid)
    assert 2 <= live.sum() < k                       # a dead slot
    cond = parity.pose_system_condition(tpba.pose_information(win, runs["tcam"], opts),
                                        win.frame_valid)
    tol = COV_RTOL if priors == "moderate" else (
        parity.COV_F64_ULPS * float(np.finfo(np.float64).eps) * cond)
    assert (cond < 1e5) == (priors == "moderate")
    errs = parity.covariance_errors(out, [torch.as_tensor(np.array(x)) for x in out_j],
                                    win.frame_valid)
    assert max(errs.values()) <= tol, (errs, tol, cond)

    # tests/solvers/test_pba.py::test_pose_covariances_sane
    c, r = to_np(out[0]).reshape(k, 8, k, 8), to_np(out[1])
    for i in np.where(live)[0]:
        d = np.diagonal(c[i, :, i, :])
        assert np.isfinite(d).all() and np.all(d >= -1e-8), d
    for i in np.where(~live)[0]:
        assert np.abs(c[i]).max() < 1e-9
    i, j = np.where(live)[0][:2]
    np.testing.assert_allclose(r[i, j], r[i, j].T, atol=1e-5)
    assert np.abs(r[i, j]).max() > 0


def test_solve_window_matches_jax(runs):
    jwin = runs["jt"].window
    out_j, stats_j = jpba.solve_window(jwin, runs["cam"])
    out_t, stats_t = tpba.solve_window(convert.window(window_fields(jwin)), runs["tcam"])
    assert stats_t["num_valid"] == stats_j["num_valid"] > 0
    assert stats_t["energy"] == pytest.approx(stats_j["energy"], rel=SOLVE_RTOL)
    poses_j = out_j.poses()
    assert_close(out_t.poses().q, poses_j.q, rtol=SOLVE_RTOL, atol=1e-10)
    assert_close(out_t.poses().t, poses_j.t, rtol=SOLVE_RTOL, atol=1e-10)
    for name in ("eps", "affine0", "lm_idepth", "lm_baseline"):
        assert_close(getattr(out_t, name), getattr(out_j, name), rtol=SOLVE_RTOL, atol=1e-12,
                     err_msg=name)
    for name in ("res_status", "lm_outlier", "lm_inliers", "lm_opt_count"):
        assert_equal(getattr(out_t, name), getattr(out_j, name), err_msg=name)
    # readback=False: the device scalars, nothing read
    _, (e, n) = tpba.solve_window(convert.window(window_fields(jwin)), runs["tcam"],
                                  readback=False)
    assert isinstance(e, torch.Tensor) and float(e) == stats_t["energy"]
    assert int(n) == stats_t["num_valid"]


@pytest.mark.parametrize("flags_given", [True, False])
def test_marginalize_matches_jax(runs, flags_given):
    jwin = runs["jt"].window
    k, n = jwin.num_slots, jwin.num_landmark_slots
    rng = np.random.default_rng(3)
    lm = jnp.asarray(rng.random((k, n)) < 0.2) & jwin.lm_valid
    frames = np.zeros(k, bool)
    frames[1] = True
    jwin = dataclasses.replace(jwin, lm_marg_flag=lm, frame_marg=jnp.asarray(frames))
    out_j = jpba.marginalize(jwin, runs["cam"])
    win = convert.window(window_fields(jwin))
    kw = (dict(frame_flags=frames & to_np(win.frame_valid), lm_any=True) if flags_given
          else {})
    out_t = tpba.marginalize(win, runs["tcam"], **kw)
    for name, a, hi, lo in (("H", out_t.h_marg, out_j.h_marg, out_j.h_marg_lo),
                            ("b", out_t.b_marg, out_j.b_marg, out_j.b_marg_lo),
                            ("E", out_t.energy_marg, out_j.energy_marg, out_j.energy_marg_lo)):
        want = np.asarray(hi) + np.asarray(lo)
        assert np.abs(want).max() > 0
        assert _rel_max(a, want) <= LEDGER_RTOL, name
    for name in ("frame_valid", "frame_id", "lm_valid", "lm_marg_flag", "frame_marg",
                 "res_status"):
        assert_equal(getattr(out_t, name), getattr(out_j, name), err_msg=name)
    assert_close(out_t.lm_idepth, out_j.lm_idepth, rtol=0, atol=0)
    assert int(out_t.frame_valid.sum()) == int(win.frame_valid.sum()) - 1


def test_marginalize_without_flags_returns_the_window(runs):
    win = convert.window(window_fields(runs["jt"].window))
    assert not bool(win.lm_marg_flag.any()) and not bool(win.frame_marg.any())
    assert tpba.marginalize(win, runs["tcam"]) is win
    k = win.num_slots
    assert tpba.marginalize(win, runs["tcam"], frame_flags=np.zeros(k, bool),
                            lm_any=False) is win
