"""The active population keyframe by keyframe at the dense operating point's
17 frame slots (f64 on the CPU, 120×160): the JAX package runs 6 consecutive
forced keyframes after the bootstrap; from the JAX state before each of them
the port runs the same tick (the frontend from the JAX state, the backend from
the JAX frontend's state) and must count the same active landmarks, activate
the same number of points and move the spacing ``min_distance`` alike
(integers exact, the spacing 1e-9), with the window's landmark masks equal
after every keyframe.
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
from dsopp_tpu_torch.tracker import device_loop as tdl
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests._torch_port import assert_equal, state_fields, to_np
from tests.test_torch_tracker import _copy, _jax_state

H, W = 120, 160
INIT, KEYFRAMES = 6, 6
# dense.yaml's window (5..15 of 17 slots) and factor, the point counts cut to the image
CFG = dict(num_frame_slots=17, landmarks_per_frame=48, immature_per_frame=120,
           desired_points=300, frontend_points=600, keyframe_factor=2.0,
           window_min=5, window_max=15, use_rotation_perturbations=False)


@pytest.fixture(scope="module")
def keyframes():
    seq = render_sequence(num_frames=INIT + KEYFRAMES, height=H, width=W)
    cam = seq.camera
    jt = JTracker(cam, JConfig(**CFG), dtype=jnp.float64)
    jt.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                    JSE3(jnp.asarray(seq.pose_t_wc(i).q), jnp.asarray(seq.pose_t_wc(i).t)))
                   for i in range(INIT)])
    jpipe = jdl.PipelinedTracker(jt, flush_every=1000)
    port = MonocularTracker(convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size),
                            TrackerConfig(**CFG), dtype=torch.float64, device="cpu")
    models, cfg = tuple(port.models), port.loop_config()
    exposure = torch.tensor(1.0, dtype=torch.float64)
    rows = []
    for i in range(INIT, INIT + KEYFRAMES):
        before = _copy(state_fields(jpipe.state))
        j_base, _, _ = jdl._frontend_core(_jax_state(before), jnp.asarray(seq.images[i]),
                                          jnp.asarray(True), jpipe.models, jpipe.cfg,
                                          jnp.asarray(1.0))
        j_base = _copy(state_fields(j_base))
        jpipe.tick(i, float(seq.timestamps[i]), seq.images[i], force_keyframe=True)
        j_diag = _copy(jpipe.pending[-1][2]._asdict())
        j_after = _copy(state_fields(jpipe.state))
        _, need, front = tdl._frontend_core(convert.device_tracker_state(before),
                                            torch.as_tensor(seq.images[i]), True, models, cfg,
                                            exposure)
        state, diag = tdl._backend_core(convert.device_tracker_state(j_base), front, need, i,
                                        models, cfg, exposure)
        rows.append((j_diag, j_after, diag, state))
    return rows


@pytest.mark.parametrize("index", range(KEYFRAMES))
def test_population_matches_keyframe_by_keyframe(keyframes, index):
    j_diag, j_after, diag, state = keyframes[index]
    assert bool(j_diag["is_keyframe"]) and diag.is_keyframe
    assert int(diag.n_active) == int(j_diag["n_active"])
    assert int(diag.n_activated) == int(j_diag["n_activated"])
    np.testing.assert_allclose(float(diag.min_distance), float(j_diag["min_distance"]),
                               rtol=1e-9, atol=1e-12)
    for name in ("frame_valid", "lm_valid", "lm_outlier"):
        assert_equal(getattr(state.window, name), j_after["window"][name], err_msg=name)
    assert_equal(state.immature.valid.sum(dim=1), j_after["immature"]["valid"].sum(axis=1))


def test_population_grows_and_the_controller_moves(keyframes):
    """The run is not degenerate: the population changes from keyframe to
    keyframe, points activate at each, and the spacing leaves its start."""
    n_active = [int(d.n_active) for _, _, d, _ in keyframes]
    assert len(set(n_active)) > 3 and max(n_active) > 150
    assert all(int(d.n_activated) > 0 for _, _, d, _ in keyframes)
    spacing = [float(d.min_distance) for _, _, d, _ in keyframes]
    assert len({round(s, 6) for s in spacing}) > 1
    frames = int(to_np(keyframes[-1][3].window.frame_valid).sum())
    assert frames >= 8          # a window beyond the standart point's
