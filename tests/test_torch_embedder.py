"""Port parity of the frame embedder and of the slice that runs it: the
embedders, the C-channel pixel map, and the tracker with
``embedder="filter_bank"`` (C = 3) against the JAX package, f64 on the CPU.

* ``IdentityEmbedder``, ``FilterBankEmbedder`` (the default bank and an
  asymmetric Scharr bank, so that a flipped kernel shows) and
  ``make_embedder``: both convolve in float32 and cast back, so the f64
  outputs hold float32 values, and they agree within 1e-4 absolute on
  intensities 0..255 (two float32 convolutions summing in other orders); a
  direct float64 cross-correlation with zero padding lands within 2e-4;
* ``build_pixel_map`` of C channels: [3C, H, W] in the group layout, equal
  to JAX's to 1e-12; K1's channel map (``build_channel_map``) runs the plain
  version on the CPU;
* the slice, at ``tests/tracker/test_embedder_tracker.py``'s configuration
  (120×160, window 2..3 of 7 slots, so that most keyframes fold a frame):
  the last bootstrap keyframe from the same converted JAX state, then the
  16 ticks of frames 6..21, each from the JAX state before it (the frontend
  from the JAX state, the backend from the JAX frontend's, as
  ``tests/test_torch_tracker.py`` does): the keyframe decision, the tracked pose and the whole state after
  each tick (the window's C-channel ``lm_patch`` and ``lm_idepth`` among it),
  1e-7 relative across a BA solve, flags exact; at least two keyframes and
  one fold among the ticks;
* JAX's C > 1 gate on the port's free runs (bootstrap, then
  ``PipelinedTracker`` over frames 6..21): the C = 3 run's per-frame
  translation RMSE below max(1.5 × C = 1's, C = 1's + 0.01 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core.interpolate import build_pixel_map as jbuild_pixel_map
from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.features import embedder as jemb
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.tracker import device_loop as jdl
from dsopp_tpu.tracker.monocular import MonocularTracker as JTracker
from dsopp_tpu.tracker.monocular import TrackerConfig as JConfig
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.core.interpolate import build_pixel_map
from dsopp_tpu_torch.features import embedder as temb
from dsopp_tpu_torch.features.pyramid import build_channel_map
from dsopp_tpu_torch.tracker import device_loop as tdl
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests._torch_port import assert_close, assert_equal, state_fields, to_np, to_torch
from tests.test_torch_tracker import (RTOL, RTOL_SOLVE, _close, _compare_state, _copy, _force,
                                      _jax_state, _jax_tracker_fields)

SCHARR = np.stack([[[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]],
                   [[-3.0, -10.0, -3.0], [0.0, 0.0, 0.0], [3.0, 10.0, 3.0]]]) / 16.0
NUM_FRAMES = 22
INIT_FRAMES = 6
TICKS = NUM_FRAMES - INIT_FRAMES
H, W = 120, 160
CFG = dict(num_frame_slots=7, landmarks_per_frame=128, immature_per_frame=256,
           desired_points=600, frontend_points=800, keyframe_factor=3.0,
           window_min=2, window_max=3, use_rotation_perturbations=False,
           embedder="filter_bank")


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(3).uniform(0.0, 255.0, (24, 32))


def test_identity_embedder(image):
    out = temb.make_embedder("identity")(to_torch(image))
    assert out.shape == (1, 24, 32)
    assert_equal(out[0], image)
    assert temb.IdentityEmbedder.channels == 1


@pytest.mark.parametrize("bank", ["default", "scharr"])
def test_filter_bank_matches_jax(image, bank):
    filters = None if bank == "default" else SCHARR
    ref = np.asarray(jemb.FilterBankEmbedder(filters)(jnp.asarray(image)))
    out = temb.FilterBankEmbedder(filters)(to_torch(image))
    assert out.dtype == torch.float64 and out.shape == ref.shape
    assert_equal(out, out.float().double())              # computed in float32
    assert_close(out, ref, atol=1e-4)
    # a direct float64 cross-correlation with zero padding ("SAME")
    k = np.asarray(jemb.FilterBankEmbedder(filters).filters, np.float64)
    pad = np.pad(image, 1)
    direct = np.stack([sum(k[c, dy, dx] * pad[dy:dy + 24, dx:dx + 32]
                           for dy in range(3) for dx in range(3)) for c in range(k.shape[0])])
    assert_close(out, direct, atol=2e-4)


def test_make_embedder():
    emb = temb.make_embedder("filter_bank")
    assert emb.channels == 3 and isinstance(emb, temb.FilterBankEmbedder)
    assert_equal(emb.filters, np.asarray(jemb.FilterBankEmbedder().filters))
    with pytest.raises(ValueError, match="gn_net"):
        temb.make_embedder("gn_net")
    with pytest.raises(ValueError):
        temb.FilterBankEmbedder(np.zeros((3, 5, 5)))


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_pixel_map_of_channels_matches_jax(image, channels):
    chans = np.stack([image * (c + 1) for c in range(channels)])
    ref = np.asarray(jbuild_pixel_map(jnp.asarray(chans)))
    out = build_pixel_map(to_torch(chans))
    assert out.shape == (3 * channels, 24, 32)
    assert_close(out, ref, rtol=1e-12, atol=1e-12)
    assert_equal(build_channel_map(to_torch(chans)), out)
    if channels == 1:
        assert_equal(build_pixel_map(to_torch(image)), out)


@pytest.fixture(scope="module")
def slice_runs():
    seq = render_sequence(num_frames=NUM_FRAMES, height=H, width=W)
    cam = convert.pinhole(seq.camera.fx, seq.camera.fy, seq.camera.cx, seq.camera.cy,
                          seq.camera.image_size)
    jposes = [JSE3(jnp.asarray(seq.pose_t_wc(i).q), jnp.asarray(seq.pose_t_wc(i).t))
              for i in range(INIT_FRAMES)]
    jt = JTracker(seq.camera, JConfig(**CFG), dtype=jnp.float64)
    forced = MonocularTracker(cam, TrackerConfig(**CFG), dtype=torch.float64, device="cpu")
    for i in range(INIT_FRAMES - 1):
        jt.tick(i, 0.0, seq.images[i], known_pose=jposes[i])
    # the last bootstrap keyframe from the same converted JAX state
    last = INIT_FRAMES - 1
    _force(forced, _jax_tracker_fields(jt), jt)
    jt.tick(last, 0.0, seq.images[last], known_pose=jposes[last], force_keyframe=True)
    forced.tick(last, 0.0, seq.images[last],
                known_pose=convert.se3(jposes[last].q, jposes[last].t), force_keyframe=True)
    boot = (forced.window, _jax_tracker_fields(jt))
    # the ticks, each from the JAX state before it
    jpipe = jdl.PipelinedTracker(jt, flush_every=1000)
    models, cfg = tuple(forced.models), forced.loop_config()
    exposure = torch.tensor(1.0, dtype=torch.float64)
    ticks = []
    for i in range(INIT_FRAMES, INIT_FRAMES + TICKS):
        before = _copy(state_fields(jpipe.state))
        j_base, j_need, _ = jdl._frontend_core(
            _jax_state(before), jnp.asarray(seq.images[i]), jnp.asarray(False),
            jpipe.models, jpipe.cfg, jnp.asarray(1.0))
        j_base = _copy(state_fields(j_base))
        jpipe.tick(i, float(seq.timestamps[i]), seq.images[i])
        j_diag = _copy(jpipe.pending[-1][2]._asdict())
        after = _copy(state_fields(jpipe.state))
        _, need, front = tdl._frontend_core(convert.device_tracker_state(before),
                                            torch.as_tensor(seq.images[i]), False, models, cfg,
                                            exposure)
        state, diag = tdl._backend_core(convert.device_tracker_state(j_base), front, need, i,
                                        models, cfg, exposure)
        ticks.append((bool(j_need), need, j_diag, diag, after, state))
    jpipe.finalize()
    return dict(seq=seq, cam=cam, boot=boot, ticks=ticks)


def test_slice_bootstrap_keyframe_matches(slice_runs):
    window, ref = slice_runs["boot"]
    exp = convert.window(ref["window"])
    assert window.num_channels == exp.num_channels == 3
    for name in ("lm_patch", "lm_idepth", "lm_valid", "t_lin_q", "t_lin_t", "frame_id",
                 "channel_maps"):
        _close(getattr(window, name), getattr(exp, name), name, RTOL_SOLVE)


def test_slice_ticks_match(slice_runs):
    keyframes = folds = 0
    for j_need, need, j_diag, diag, after, state in slice_runs["ticks"]:
        assert need == j_need == bool(j_diag["is_keyframe"])
        rtol = RTOL_SOLVE if need else RTOL
        for name in ("pose_q", "pose_t", "affine", "rmse", "num_valid_align"):
            _close(getattr(diag, name), j_diag[name], f"diag.{name}", rtol)
        _compare_state(state, after, rtol)
        exp = convert.window(after["window"])
        assert exp.num_channels == 3
        _close(state.window.channel_maps, exp.channel_maps, "channel_maps", rtol)
        keyframes += int(need)
        folds += int(need and bool(np.asarray(j_diag["frame_flags"]).any()))
    assert keyframes >= 2 and folds >= 1, (keyframes, folds)


def _free_run(seq, cam, embedder):
    cfg = TrackerConfig(**{**CFG, "embedder": embedder})
    tt = MonocularTracker(cam, cfg, dtype=torch.float64, device="cpu")
    tt.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                    convert.se3(seq.pose_t_wc(i).q, seq.pose_t_wc(i).t))
                   for i in range(INIT_FRAMES)])
    pipe = tdl.PipelinedTracker(tt, flush_every=8)
    errs = [float(np.linalg.norm(to_np(pipe.tick(i, float(seq.timestamps[i]),
                                                  seq.images[i]).pose_t)
                                 - np.asarray(seq.pose_t_wc(i).t)))
            for i in range(INIT_FRAMES, NUM_FRAMES)]
    pipe.finalize()
    return tt, np.asarray(errs)


def test_slice_meets_the_jax_channel_gate(slice_runs):
    """tests/tracker/test_embedder_tracker.py's gate on the port's runs."""
    seq, cam = slice_runs["seq"], slice_runs["cam"]
    tt3, errs3 = _free_run(seq, cam, "filter_bank")
    _, errs1 = _free_run(seq, cam, "identity")
    assert tt3.window.num_channels == 3 and tt3.window.lm_patch.shape[-1] == 24
    assert int((tt3.window.lm_valid & ~tt3.window.lm_outlier).sum()) > 100
    assert len(tt3.track.marginalized) >= 1
    rmse3, rmse1 = (float(np.sqrt(np.mean(e ** 2))) for e in (errs3, errs1))
    assert rmse3 < max(1.5 * rmse1, rmse1 + 1e-2), (rmse3, rmse1)
