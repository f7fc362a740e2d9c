"""The CameraMask in the port's tracking path (counterpart of
``tests/tracker/test_mask.py``), f64 on the CPU.

* ``select_candidates`` places no candidate where the mask is false;
* a tracker built with a mask never holds a valid immature point or a valid
  landmark in the masked region, through the bootstrap and the tracked frames;
* one forced-keyframe ``device_tick`` with the mask, from the same converted
  JAX state: the frontend from the JAX state, the backend from the JAX
  frontend's state (as ``tests/test_torch_tracker.py`` does), state and
  diagnostics 1e-9 relative (1e-7 across the BA solve), ints and bools exact;
* a tracker given no mask hands none to the candidate selection.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.tracker import device_loop as jdl
from dsopp_tpu.tracker.monocular import MonocularTracker as JTracker
from dsopp_tpu.tracker.monocular import TrackerConfig as JConfig
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.features.extractor import select_candidates
from dsopp_tpu_torch.tracker import device_loop as tdl
from dsopp_tpu_torch.tracker import fused_keyframe
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests._torch_port import state_fields
from tests.test_torch_tracker import RTOL, RTOL_SOLVE, _close, _compare_state, _copy, _jax_state

H, W = 120, 160
INIT = 8
CFG = dict(num_frame_slots=7, landmarks_per_frame=100, immature_per_frame=250,
           desired_points=400, frontend_points=600, keyframe_factor=3.0,
           window_min=3, window_max=5, use_rotation_perturbations=False)


def _mask_left_half():
    mask = np.ones((H, W), bool)
    mask[:, : W // 2] = False  # left half invalid
    return mask


def test_select_candidates_respects_mask():
    rng = np.random.default_rng(0)
    pm = torch.tensor(np.stack([rng.uniform(0, 255, (H, W)), rng.normal(0, 20, (H, W)),
                                rng.normal(0, 20, (H, W))]))
    cands = select_candidates(pm, 200, mask=convert.camera_mask(_mask_left_half()))
    uv = cands.uv[cands.valid].numpy()
    assert uv.shape[0] > 0
    assert np.all(uv[:, 0] >= W // 2), "candidate selected inside masked region"


@pytest.fixture(scope="module")
def seq():
    return render_sequence(num_frames=20, height=H, width=W, focal=130.0, advance=0.06)


def _camera(seq):
    c = seq.camera
    return convert.pinhole(c.fx, c.fy, c.cx, c.cy, c.image_size)


def _jposes(seq, count):
    return [JSE3(jnp.asarray(seq.pose_t_wc(i).q, jnp.float64),
                 jnp.asarray(seq.pose_t_wc(i).t, jnp.float64)) for i in range(count)]


def test_tracker_never_places_points_in_masked_region(seq):
    tracker = MonocularTracker(_camera(seq), TrackerConfig(**CFG), dtype=torch.float64,
                               device="cpu", mask=_mask_left_half())
    assert tracker.mask.dtype == torch.bool and tracker.mask is tracker.base_mask
    poses = _jposes(seq, INIT)
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                         convert.se3(poses[i].q, poses[i].t)) for i in range(INIT)])
    pipe = tdl.PipelinedTracker(tracker, flush_every=4)
    keyframes = 0
    for i in range(INIT, 20):
        keyframes += int(pipe.tick(i, float(seq.timestamps[i]), seq.images[i]).is_keyframe)
    pipe.finalize()
    assert keyframes >= 1 and tracker.mask is pipe.mask

    # immature banks: every valid point sits in the allowed half
    imm_uv, imm_valid = tracker.immature.uv.numpy(), tracker.immature.valid.numpy()
    assert imm_valid.any()
    assert np.all(imm_uv[imm_valid][:, 0] >= W // 2)
    # active landmarks too (born from immature candidates)
    lm_uv, lm_valid = tracker.window.lm_uv.numpy(), tracker.window.lm_valid.numpy()
    assert lm_valid.any()
    assert np.all(lm_uv[lm_valid][:, 0] >= W // 2)


def test_masked_device_tick_matches(seq):
    """A forced keyframe at frame 8 under the mask, from the JAX state."""
    mask = _mask_left_half()
    jt = JTracker(seq.camera, JConfig(**CFG), dtype=jnp.float64, mask=jnp.asarray(mask))
    poses = _jposes(seq, INIT)
    jt.initialize([(i, float(seq.timestamps[i]), seq.images[i], poses[i]) for i in range(INIT)])
    jpipe = jdl.PipelinedTracker(jt, flush_every=1000)
    before = _copy(state_fields(jpipe.state))
    j_base, _, _ = jdl._frontend_core(_jax_state(before), jnp.asarray(seq.images[INIT]),
                                      jnp.asarray(True), jpipe.models, jpipe.cfg,
                                      jnp.asarray(1.0))
    j_base = _copy(state_fields(j_base))
    jpipe.tick(INIT, float(seq.timestamps[INIT]), seq.images[INIT], force_keyframe=True)
    j_diag = _copy(jpipe.pending[-1][2]._asdict())
    after = _copy(state_fields(jpipe.state))
    assert bool(j_diag["is_keyframe"])

    port = MonocularTracker(_camera(seq), TrackerConfig(**CFG), dtype=torch.float64,
                            device="cpu", mask=mask)
    models, cfg = tuple(port.models), port.loop_config()
    exposure = torch.tensor(1.0, dtype=torch.float64)
    base, need, front = tdl._frontend_core(convert.device_tracker_state(before),
                                           torch.as_tensor(seq.images[INIT]), True, models, cfg,
                                           exposure)
    assert need
    _compare_state(base, j_base, RTOL)
    state, diag = tdl._backend_core(convert.device_tracker_state(j_base), front, True, INIT,
                                    models, cfg, exposure, mask=port.mask)
    for name in ("energy", "num_valid_solve", "n_active", "n_activated", "min_distance",
                 "frame_flags", "kf_frame_id", "lm_valid", "lm_outlier"):
        _close(getattr(diag, name), j_diag[name], f"diag.{name}", RTOL_SOLVE)
    _compare_state(state, after, RTOL_SOLVE)
    # the new keyframe's bank lies in the allowed half, in both packages
    newest = int(state.window.frame_valid.sum()) - 1
    bank_valid = state.immature.valid[newest].numpy()
    assert bank_valid.sum() > 20
    assert np.all(state.immature.uv[newest].numpy()[bank_valid][:, 0] >= W // 2)
    # ... and without the mask the same tick places candidates in the left half
    state_open, _ = tdl._backend_core(convert.device_tracker_state(j_base), front, True, INIT,
                                      models, cfg, exposure)
    open_valid = state_open.immature.valid[newest].numpy()
    assert np.any(state_open.immature.uv[newest].numpy()[open_valid][:, 0] < W // 2)


def test_no_mask_hands_none_to_the_candidate_selection(seq, monkeypatch):
    seen = []
    real = fused_keyframe.select_candidates_sequences

    def spy(maps, seqs, num_points, mask=None, **kwargs):
        seen.append(mask)
        return real(maps, seqs, num_points, mask=mask, **kwargs)

    monkeypatch.setattr(fused_keyframe, "select_candidates_sequences", spy)
    tracker = MonocularTracker(_camera(seq), TrackerConfig(**CFG), dtype=torch.float64,
                               device="cpu")
    poses = _jposes(seq, 3)
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                         convert.se3(poses[i].q, poses[i].t)) for i in range(3)])
    assert tracker.mask is None and len(seen) >= 2 and all(m is None for m in seen)
    with pytest.raises(ValueError):
        MonocularTracker(_camera(seq), TrackerConfig(**CFG), device="cpu",
                         mask=np.ones((H, W + 1), bool))
