"""Checkpoint and resume of the port's tracker
(``tests/output/test_checkpoint.py`` on the port, f64 on the CPU at 120×160, with
more keyframes than there):
a run tracked straight through with ``PipelinedTracker`` and a run saved at
frame 14 (after ``finalize``), loaded into a fresh tracker and resumed give
the same poses to the bit, the same keyframes and the same track history;
the loaded state equals the saved one to the bit, the frontend's level and
flow points rebuilt from the depth maps included.

The file runs in ~26 s on one worker.
"""

import copy

import numpy as np
import torch

from dsopp_tpu_torch.output.checkpoint import load_checkpoint, save_checkpoint
from dsopp_tpu_torch.testing.synthetic import render_sequence
from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests import _torch_port  # noqa: F401  (one torch thread a worker)

# keyframes at frames 6, 12 and 19: one marginalized before the save, one after
CFG = TrackerConfig(landmarks_per_frame=128, immature_per_frame=256, desired_points=600,
                    frontend_points=800, keyframe_factor=5.0, window_min=2, window_max=3,
                    use_rotation_perturbations=False)
FRAMES, INIT, SAVE_AT = 22, 6, 14


def _bootstrap(seq):
    tracker = MonocularTracker(seq.camera, CFG, dtype=torch.float64, device="cpu")
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i], seq.pose(i))
                        for i in range(INIT)])
    return tracker


def _track(tracker, seq, frames):
    pipe = PipelinedTracker(tracker, flush_every=4)
    poses = [pipe.tick(i, float(seq.timestamps[i]), seq.images[i]).pose_t.clone()
             for i in frames]
    pipe.finalize()
    return poses


def _equal(a, b, name):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{name}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, name
    else:
        assert torch.equal(a, b), name


def test_checkpoint_resume_continues_identically(tmp_path):
    seq = render_sequence(num_frames=FRAMES, height=120, width=160, dtype=torch.float64,
                          device="cpu")
    saved = _bootstrap(seq)
    straight = copy.deepcopy(saved)
    poses_a = _track(straight, seq, range(INIT, FRAMES))
    poses_b = _track(saved, seq, range(INIT, SAVE_AT))
    path = str(tmp_path / "state.npz")
    assert len(saved.track.marginalized) >= 1
    save_checkpoint(path, saved)
    resumed = load_checkpoint(path, seq.camera, CFG, dtype=torch.float64, device="cpu")

    # the loaded state is the saved one, the rebuilt frontend points included
    assert resumed.num_keyframes == saved.num_keyframes and resumed.kf_id == saved.kf_id
    for name in saved.window.__dataclass_fields__:
        _equal(getattr(resumed.window, name), getattr(saved.window, name), f"window.{name}")
    _equal(tuple(resumed.immature), tuple(saved.immature), "immature")
    _equal(resumed.depth_maps, saved.depth_maps, "depth_maps")
    _equal(resumed.level_points, saved.level_points, "level_points")
    _equal(resumed.flow_points, saved.flow_points, "flow_points")
    _equal((resumed.t_w_last.q, resumed.t_w_last.t, resumed.t_prev_rel.q,
            resumed.t_prev_rel.t, resumed.last_affine),
           (saved.t_w_last.q, saved.t_w_last.t, saved.t_prev_rel.q, saved.t_prev_rel.t,
            saved.last_affine), "poses and affine")
    assert (resumed.rmse_last, resumed.kf_rmse, resumed.min_distance) == (
        saved.rmse_last, saved.kf_rmse, saved.min_distance)

    poses_b += _track(resumed, seq, range(SAVE_AT, FRAMES))
    assert len(poses_a) == len(poses_b) == FRAMES - INIT
    for i, (a, b) in enumerate(zip(poses_a, poses_b)):
        assert torch.equal(a, b), f"the resumed run parts at frame {INIT + i}"
    assert resumed.num_keyframes == straight.num_keyframes
    assert len(resumed.track.marginalized) == len(straight.track.marginalized) >= 2
    traj_a = straight.track.trajectory(straight.window)
    traj_b = resumed.track.trajectory(resumed.window)
    assert [t for t, _ in traj_a] == [t for t, _ in traj_b] and len(traj_a) == FRAMES
    for (_, a), (_, b) in zip(traj_a, traj_b):
        np.testing.assert_array_equal(a, b)
