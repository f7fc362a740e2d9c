"""Port parity: the windowed-BA functions that hold the kernels K7 and K8
(K8 with the FEJ Jacobians, once kernel K6's cache, formed inside), in plain
PyTorch (f64 on the CPU) against the JAX package, each on the same inputs
(K = 4 frames, N = 40 landmarks, 120×160), with C = 1 channel (intensity) and
with C = 2 and 3 frame-embedder channels (the JAX package's filter bank and
its first two filters; the JAX window's channels converted from its patch
tables):

* ``_fej_cache``, ``_evaluate``, ``_linearize_from_ev`` (the port's FEJ of
  the window against JAX's ``_linearize_from_ev`` on JAX's cache; also with
  ``marg_pass=True``): floats 1e-9 relative to the array's largest entry,
  statuses and masks exact;
* the dispatchers run the plain versions on CPU tensors, every ``*_cuda``
  wrapper refuses CPU tensors without launching, and ``_fej_cache`` refuses a
  window on the card (no FEJ cache exists there);
* the default-device rule: no entry point picks the CPU quietly.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsopp_tpu_torch
from dsopp_tpu.features.embedder import FilterBankEmbedder
from dsopp_tpu.solvers import pba as jpba
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import build_test_window
from dsopp_tpu_torch import convert, kernels
from dsopp_tpu_torch.core.camera import Pinhole
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.solvers import pose_alignment as tpa
from dsopp_tpu_torch.testing import render_sequence as torch_render
from dsopp_tpu_torch.tracker import depth_map as tdm
from dsopp_tpu_torch.tracker import marginalization as tmarg
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests._torch_port import assert_close, assert_equal, to_torch, window_fields

FRAMES = [0, 2, 4, 6]
N_LM = 40


def embedder(channels: int):
    """The JAX embedder of ``channels`` channels (None: the intensity)."""
    if channels == 1:
        return None
    return FilterBankEmbedder(np.asarray(FilterBankEmbedder().filters)[:channels])


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda c: f"C{c}")
def problem(request):
    """A perturbed window of C channels with non-zero eps, mixed statuses,
    exposures, one fixed and one flagged frame; the JAX results on it."""
    seq = render_sequence(num_frames=8, height=120, width=160)
    window = build_test_window(seq, FRAMES, num_landmarks=N_LM, slots=len(FRAMES),
                               pose_noise=3e-3, idepth_noise=0.05, seed=3,
                               embedder=embedder(request.param))
    assert window.num_channels == request.param
    rng = np.random.default_rng(8)
    k = window.num_slots
    eps = rng.normal(size=(k, 8)) * np.array([2e-3] * 6 + [1e-2, 0.5])
    eps[0] = 0.0
    status = rng.choice([jpba.RES_OK, jpba.RES_OOB, jpba.RES_OUTLIER],
                        size=(k, k, N_LM), p=[0.85, 0.1, 0.05]).astype(np.int32)
    window = dataclasses.replace(
        window, eps=jnp.asarray(eps), res_status=jnp.asarray(status),
        exposure=jnp.asarray([1.0, 1.1, 0.95, 1.02]),
        affine0=jnp.asarray(rng.normal(size=(k, 2)) * [0.02, 1.0]),
        frame_marg=jnp.asarray([False, True, False, False]),
        lm_valid=window.lm_valid & jnp.asarray(rng.random((k, N_LM)) < 0.9))
    cam = seq.camera
    opts = jpba.PBAOptions()
    lm_mask = jpba.active_lm_mask(window)
    idepth = window.lm_idepth * jnp.asarray(1.0 + 0.02 * rng.normal(size=(k, N_LM)))
    fej = jpba._fej_cache(window, cam)
    ev = jpba._evaluate(window, cam, window.eps, idepth, lm_mask, opts)
    tcam = convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size)
    tw = convert.window(window_fields(window))
    assert tw.num_channels == request.param
    return dict(window=window, cam=cam, idepth=idepth, lm_mask=lm_mask, fej=fej, ev=ev,
                tw=tw, tcam=tcam)


def _fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _close(actual, expected, name):
    scale = float(np.max(np.abs(np.asarray(expected))))
    assert_close(actual, expected, rtol=1e-9, atol=1e-9 * scale, err_msg=name)


def test_fej_cache_matches(problem):
    ref = convert.fej_cache(_fields(problem["fej"]))
    out = tpba._fej_cache(problem["tw"], problem["tcam"])
    assert_equal(out.geom_valid, ref.geom_valid)
    assert 0 < int(out.geom_valid.sum()) < out.geom_valid.numel()
    for name in ("d_uv_ref", "d_uv_tgt", "d_uv_idepth", "corrected_ref", "scale0"):
        assert getattr(out, name).shape == getattr(ref, name).shape, name
        _close(getattr(out, name), getattr(ref, name), name)


def test_evaluate_matches(problem):
    ref = convert.evaluation(_fields(problem["ev"]))
    tw = problem["tw"]
    out = tpba._evaluate(tw, problem["tcam"], tw.eps, to_torch(problem["idepth"]),
                         to_torch(problem["lm_mask"]), tpba.PBAOptions())
    assert_equal(out.ok, ref.ok)
    assert_equal(out.status_candidate, ref.status_candidate)
    assert int(out.ok.sum()) > 100
    assert int((out.status_candidate != tw.res_status).sum()) > 0
    for name in ("residuals", "energy_patch", "weight"):
        _close(getattr(out, name), getattr(ref, name), name)
    # gradients are defined on every live group; compare where the patch is ok
    m = ref.ok[..., None, None]
    for name in ("gx", "gy"):
        _close(torch.where(m, getattr(out, name), 0.0), torch.where(m, getattr(ref, name), 0.0),
               name)


@pytest.mark.parametrize("marg_pass", [False, True])
def test_linearize_from_ev_matches(problem, marg_pass):
    window = problem["window"]
    ref = jpba._linearize_from_ev(window, problem["fej"], problem["ev"], window.eps,
                                  jpba.PBAOptions(), marg_pass=marg_pass)
    tw = problem["tw"]
    out = tpba._linearize_from_ev(tw, problem["tcam"], convert.evaluation(_fields(problem["ev"])),
                                  tw.eps, tpba.PBAOptions(), marg_pass=marg_pass)
    ref = convert.linear_system(_fields(ref))
    assert float(ref.h_schur.abs().max()) > 0
    for name in tpba.LinearSystem._fields:
        assert getattr(out, name).shape == getattr(ref, name).shape, name
        _close(getattr(out, name), getattr(ref, name), name)


def test_marg_pass_regularizes_fixed_anchor_landmarks(problem):
    """The scale-nullspace regularizer reaches only landmarks of fixed frames."""
    tw, cam = problem["tw"], problem["tcam"]
    ev = convert.evaluation(_fields(problem["ev"]))
    plain = tpba._linearize_from_ev(tw, cam, ev, tw.eps, tpba.PBAOptions())
    marg = tpba._linearize_from_ev(tw, cam, ev, tw.eps, tpba.PBAOptions(), marg_pass=True)
    fixed = tw.frame_fixed
    assert bool(fixed.any()) and not bool(fixed.all())
    assert_equal(marg.inv_hdd[~fixed], plain.inv_hdd[~fixed])
    live = plain.inv_hdd[fixed] > 0
    assert bool(live.any())
    assert bool((marg.inv_hdd[fixed][live] < plain.inv_hdd[fixed][live]).all())


# dispatcher -> (stem of its _plain / _cuda versions, arguments after the window)
_DISPATCHERS = {"_fej_cache": ("_fej_cache", 1), "_evaluate": ("_evaluate", 5),
                "_linearize_from_ev": ("_linearize_from_ev", 5), "_solve_step": ("_solve_step", 5),
                "_solve_loop_device": ("_solve_loop", 2),
                "_point_status_kernel": ("_point_status", 2)}


@pytest.mark.parametrize("name", list(_DISPATCHERS))
def test_ba_dispatchers_run_plain_on_cpu(problem, monkeypatch, name):
    """``_fej_cache`` has no CUDA version left (K8 forms the FEJ itself); on
    CPU tensors it runs the plain one as the others do, and the plain
    linearization takes the plain FEJ."""
    calls = []
    stem, nargs = _DISPATCHERS[name]
    if name == "_linearize_from_ev":
        monkeypatch.setattr(tpba, "_fej_cache_plain", lambda *a, **k: None)
    monkeypatch.setattr(tpba, stem + "_plain", lambda *a, **k: calls.append("plain"))
    if name != "_fej_cache":
        monkeypatch.setattr(tpba, stem + "_cuda", lambda *a, **k: calls.append("cuda"))
    getattr(tpba, name)(problem["tw"], *([None] * nargs))
    assert calls == ["plain"]


def test_fej_cache_refuses_a_card_window(problem, monkeypatch):
    """A window whose maps lie on the card gets no FEJ cache: ``_fej_cache``
    raises before anything runs (K8 forms the Jacobians from the window)."""
    calls = []
    monkeypatch.setattr(tpba, "_fej_cache_plain", lambda *a, **k: calls.append("plain"))
    on_card = problem["tw"].replace(maps=types.SimpleNamespace(is_cuda=True))
    with pytest.raises(ValueError, match="K8"):
        tpba._fej_cache(on_card, problem["tcam"])
    assert calls == []


def test_flow_dispatcher_runs_plain_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(tdm, "mean_square_flows_plain", lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(tdm, "mean_square_flows_cuda", lambda *a, **k: calls.append("cuda"))
    pts = tpa.LevelPoints(torch.zeros(8, 2), torch.ones(8), torch.ones(8),
                          torch.ones(8, dtype=torch.bool))
    tdm.mean_square_flows(pts, None, None)
    assert calls == ["plain"]


def test_align_level_dispatcher_runs_plain_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(tpa, "align_level_plain", lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(tpa, "align_level_cuda", lambda *a, **k: calls.append("cuda"))
    tpa.align_level(None, torch.zeros(3, 4, 4), None, None, None, None, 1.0)
    assert calls == ["plain"]


def _f32_window(tw):
    return tw.replace(**{f.name: getattr(tw, f.name).float()
                         for f in dataclasses.fields(tw)
                         if getattr(tw, f.name) is not None
                         and getattr(tw, f.name).dtype == torch.float64
                         and f.name not in ("h_marg", "b_marg", "energy_marg")})


@pytest.mark.parametrize("kernel", ["align_level", "marg_policy", "ba_evaluate",
                                    "ba_linearize_schur", "flow_statistic", "ba_solve_step",
                                    "ba_lm", "ba_point_status"])
def test_new_kernel_wrappers_refuse_cpu_tensors(problem, kernel):
    tw = _f32_window(problem["tw"])
    tcam = problem["tcam"]
    f32 = lambda nt: type(nt)(*(x.float() if x.dtype == torch.float64 else x for x in nt))  # noqa: E731
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "align_level":
            pts = tpa.LevelPoints(torch.zeros(8, 2), torch.ones(8), torch.ones(8),
                                  torch.ones(8, dtype=torch.bool))
            tpa.align_level_cuda(pts, tw.maps[0], tcam,
                                 tpa.SE3(tw.t_lin_q[:1], tw.t_lin_t[:1]), tw.affine0[:1],
                                 tw.affine0[0], 1.0)
        elif kernel == "marg_policy":
            tmarg.flags_device_cuda(tw, torch.ones((tw.num_slots, 16), dtype=torch.bool),
                                    2, 3, 0.95)
        elif kernel == "ba_evaluate":
            tpba._evaluate_cuda(tw, tcam, tw.eps, tw.lm_idepth, tpba.active_lm_mask(tw),
                                tpba.PBAOptions())
        elif kernel == "flow_statistic":
            pts = tpa.LevelPoints(tw.lm_uv[0], tw.lm_idepth[0], tw.lm_idepth[0], tw.lm_valid[0])
            tdm.mean_square_flows_cuda(pts, tcam, tpa.SE3(tw.t_lin_q[1], tw.t_lin_t[1]))
        elif kernel == "ba_solve_step":
            sys = tpba._linearize_from_ev_plain(
                tw, f32(convert.fej_cache(_fields(problem["fej"]))),
                f32(convert.evaluation(_fields(problem["ev"]))), tw.eps, tpba.PBAOptions())
            tpba._solve_step_cuda(tw, sys, tw.eps, tw.lm_idepth, 1e-5, tpba.PBAOptions())
        elif kernel == "ba_lm":
            tpba._solve_loop_cuda(tw, tcam, tpba.PBAOptions())
        elif kernel == "ba_point_status":
            tpba._point_status_from_ev_cuda(tw, f32(convert.evaluation(_fields(problem["ev"]))),
                                            tpba.active_lm_mask(tw), tpba.PBAOptions())
        else:
            tpba._linearize_from_ev_cuda(tw, tcam, f32(convert.evaluation(_fields(problem["ev"]))),
                                         tw.eps, tpba.PBAOptions())
    assert kernels.counts() == before
    assert kernel in before


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        dsopp_tpu_torch.default_device()
    assert dsopp_tpu_torch.default_device("cpu") == torch.device("cpu")


def test_entry_points_do_not_pick_the_cpu_quietly(monkeypatch):
    _no_card(monkeypatch)
    cam = Pinhole.create((40.0, 30.0), (50.0, 50.0), (19.5, 14.5))
    cfg = TrackerConfig(num_frame_slots=4, landmarks_per_frame=8, immature_per_frame=8,
                        pyramid_levels=2)
    with pytest.raises(RuntimeError):
        MonocularTracker(cam, cfg)
    with pytest.raises(RuntimeError):
        torch_render(num_frames=1, height=30, width=40, focal=50.0)
    with pytest.raises(RuntimeError):
        tpba.empty_window(2, 4, (3, 30, 40))


def test_entry_points_run_on_the_cpu_when_asked():
    cam = Pinhole.create((96.0, 64.0), (80.0, 80.0), (47.5, 31.5))
    cfg = TrackerConfig(num_frame_slots=4, landmarks_per_frame=8, immature_per_frame=8,
                        pyramid_levels=2)
    tracker = MonocularTracker(cam, cfg, device="cpu")
    assert tracker.window.maps.device.type == "cpu"
    seq = torch_render(num_frames=2, height=64, width=96, focal=80.0, device="cpu")
    assert seq.images.device.type == "cpu"
    assert seq.pose(1).q.device.type == "cpu"
    tracker.tick(0, 0.0, seq.images[0], known_pose=seq.pose(0))
    assert tracker.num_keyframes == 1
    assert tpba.empty_window(2, 4, (3, 30, 40), device="cpu").eps.device.type == "cpu"
