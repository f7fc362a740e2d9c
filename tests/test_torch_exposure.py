"""The exposure path of the port tick by tick against the JAX package's, f64
on the CPU: the brightness model's exposure ratios through the bootstrap, the
frontend and the keyframe backend (the end-to-end exposure gate is in
``tests/test_torch_e2e.py``)."""

import jax.numpy as jnp
import numpy as np
import torch

from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.tracker import device_loop as jdl
from dsopp_tpu.tracker.monocular import MonocularTracker as JTracker
from dsopp_tpu.tracker.monocular import TrackerConfig as JConfig
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.testing import paths
from dsopp_tpu_torch.tracker import device_loop as tdl
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests._torch_port import state_fields
from tests.test_torch_tracker import (CFG, RTOL, RTOL_SOLVE, H, W, _close, _compare_state, _copy,
                                      _jax_state)


def test_exposure_ticks_match_jax():
    """The exposure path tick by tick: the JAX tracker under the oscillation
    (bootstrap and ticks with their exposure times, keyframes forced at ticks
    7 and 10), and before every tick the port's frontend and backend from the
    JAX state, at test_torch_tracker.py's size in f64: decisions equal, state
    and diagnostics 1e-9 relative (1e-7 across a BA solve)."""
    cfg = dict(CFG, use_rotation_perturbations=False)
    seq = render_sequence(num_frames=12, height=H, width=W)

    def exposed(i):
        e = paths.oscillating_exposure(i)
        return np.clip(np.asarray(seq.images[i]) * e - 4.0, 0.0, 255.0), e

    jt = JTracker(seq.camera, JConfig(**cfg), dtype=jnp.float64)
    for j in range(6):
        img, e = exposed(j)
        jt.tick(j, float(seq.timestamps[j]), img, force_keyframe=j == 5, exposure=e,
                known_pose=JSE3(jnp.asarray(seq.pose_t_wc(j).q), jnp.asarray(seq.pose_t_wc(j).t)))
    jpipe = jdl.PipelinedTracker(jt, flush_every=1000)
    cam = convert.pinhole(seq.camera.fx, seq.camera.fy, seq.camera.cx, seq.camera.cy,
                          seq.camera.image_size)
    port = MonocularTracker(cam, TrackerConfig(**cfg), dtype=torch.float64, device="cpu")
    models, lcfg = tuple(port.models), port.loop_config()
    keyframes = 0
    for i in range(6, 12):
        img, e = exposed(i)
        force = i in (7, 10)
        before = _copy(state_fields(jpipe.state))
        j_base, j_need, _ = jdl._frontend_core(
            _jax_state(before), jnp.asarray(img), jnp.asarray(force), jpipe.models, jpipe.cfg,
            jnp.asarray(e))
        j_base = _copy(state_fields(j_base))
        jpipe.tick(i, float(seq.timestamps[i]), img, force_keyframe=force, exposure=e)
        j_diag, after = _copy(jpipe.pending[-1][2]._asdict()), _copy(state_fields(jpipe.state))
        exposure = torch.tensor(e, dtype=torch.float64)
        base, need, front = tdl._frontend_core(convert.device_tracker_state(before),
                                               torch.as_tensor(img), force, models, lcfg,
                                               exposure)
        assert need == bool(j_need) == bool(j_diag["is_keyframe"])
        _compare_state(base, j_base, RTOL)
        state, diag = tdl._backend_core(convert.device_tracker_state(j_base), front, need, i,
                                        models, lcfg, exposure)
        rtol = RTOL_SOLVE if need else RTOL
        for name in ("pose_t", "affine", "rmse", "energy", "n_active", "kf_exposure",
                     "kf_affine", "frame_flags"):
            _close(getattr(diag, name), j_diag[name], f"tick {i}: diag.{name}", rtol)
        _compare_state(state, after, rtol)
        keyframes += int(need)
    assert keyframes >= 2
