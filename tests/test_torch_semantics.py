"""Semantics through the port's tracker (counterpart of
``tests/tracker/test_semantics.py``), f64 on the CPU: the class ids label the
landmarks of each marginalized keyframe from its own class-id image, and the
filtered classes leave the candidate mask, through the known-pose bootstrap
and through ``PipelinedTracker``.  (The track.bin round trip waits for the
port of ``output/*``.)"""

import numpy as np
import pytest
import torch

from dsopp_tpu.track.state import sample_semantics as jax_sample_semantics
from dsopp_tpu_torch.testing import render_sequence
from dsopp_tpu_torch.track.state import sample_semantics
from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

import tests._torch_port  # noqa: F401  (one torch thread per worker)

H, W = 120, 160
NUM_FRAMES = 24
INIT_FRAMES = 8
CFG = TrackerConfig(
    num_frame_slots=7, landmarks_per_frame=100, immature_per_frame=250,
    desired_points=400, frontend_points=600, keyframe_factor=3.0,
    window_min=3, window_max=4, use_rotation_perturbations=False)
F64 = dict(dtype=torch.float64, device="cpu")


def _semantic_image(flip=False):
    """Class 7 on the left half, class 3 on the right (swapped with ``flip``)."""
    sem = np.full((H, W), 7 if flip else 3, np.uint8)
    sem[:, : W // 2] = 3 if flip else 7
    return sem


def _sequence(num_frames):
    return render_sequence(num_frames=num_frames, height=H, width=W, focal=130.0,
                           advance=0.06, **F64)


@pytest.fixture(scope="module")
def tracked():
    """Bootstrap and tracked frames with the class image; frames of odd id
    carry the swapped image, so that each keyframe's own image must be the
    one that labels its landmarks."""
    seq = _sequence(NUM_FRAMES)
    tracker = MonocularTracker(seq.camera, CFG, **F64)
    for i in range(INIT_FRAMES):
        tracker.tick(i, float(seq.timestamps[i]), seq.images[i], known_pose=seq.pose(i),
                     force_keyframe=i == INIT_FRAMES - 1, semantics=_semantic_image(i % 2))
    pipe = PipelinedTracker(tracker, flush_every=4)
    for i in range(INIT_FRAMES, NUM_FRAMES):
        pipe.tick(i, float(seq.timestamps[i]), seq.images[i], semantics=_semantic_image(i % 2))
    return pipe.finalize()


def test_semantics_attached_on_marginalization(tracked):
    margs = tracked.track.marginalized
    assert len(margs) >= 1, "no marginalized keyframes in run"
    for kf in margs:
        assert kf.lm_semantic is not None
        valid = np.asarray(kf.lm_valid)
        sem = np.asarray(kf.lm_semantic)[valid]
        u = np.rint(np.asarray(kf.lm_uv)[valid][:, 0])
        # the class follows the image half the landmark sits in, in the
        # keyframe's own class image
        left, right = (3, 7) if kf.frame_id % 2 else (7, 3)
        np.testing.assert_array_equal(sem, np.where(u < W // 2, left, right))
    # the images of the keyframes still in the window stay with the tracker
    ids = {int(i) for i in tracked.window.frame_id[tracked.window.frame_valid]}
    assert set(tracked._kf_semantics) == ids


def test_sample_semantics_matches_jax():
    rng = np.random.default_rng(2)
    sem = rng.integers(0, 20, (H, W)).astype(np.uint8)
    uv = rng.uniform(-3.0, W + 3.0, (200, 2))
    np.testing.assert_array_equal(sample_semantics(sem, uv), jax_sample_semantics(sem, uv))


@pytest.mark.parametrize("loop", ["bootstrap", "pipelined"])
def test_semantic_filter_masks_candidates(loop):
    seq = _sequence(14)
    tracker = MonocularTracker(seq.camera, CFG, **F64)
    tracker.semantic_filter = (7,)   # mask the left-half class out
    sem = _semantic_image()
    last = 10 if loop == "bootstrap" else 4
    for i in range(last):
        tracker.tick(i, float(seq.timestamps[i]), seq.images[i], known_pose=seq.pose(i),
                     force_keyframe=i == last - 1, semantics=sem)
    if loop == "pipelined":
        pipe = PipelinedTracker(tracker)
        for i in range(last, 14):
            pipe.tick(i, float(seq.timestamps[i]), seq.images[i], force_keyframe=i % 3 == 0,
                      semantics=sem)
        tracker = pipe.finalize()
    imm_valid = tracker.immature.valid.numpy()
    assert imm_valid.any()
    assert np.all(tracker.immature.uv.numpy()[imm_valid][:, 0] >= W // 2), (
        "candidate extracted inside the semantically filtered class")
    lm = (tracker.window.lm_valid & tracker.window.frame_valid[:, None]).numpy()
    assert lm.any()
    assert np.all(tracker.window.lm_uv.numpy()[lm][:, 0] >= W // 2), (
        "landmark activated inside the semantically filtered class")
