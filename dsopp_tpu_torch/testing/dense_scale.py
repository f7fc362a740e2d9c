"""The active population at the configuration of
``tests/tracker/test_dense_scale.py`` (the JAX package's dense-scale test:
240×320, 104 frames of the corridor with seed 9 and advance 0.07, 17 frame
slots × 340 landmarks, 1000 immature points and 5000 frontend points per
keyframe, keyframe factor 3.0, no re-track, 8 known-pose frames), run by the
port on the card in f32.

    python -m dsopp_tpu_torch.testing.dense_scale [out.json]

Prints one JSON object: per keyframe the active landmarks the activation
counted, the points it activated and the spacing after it; at the end the
count of ``lm_valid & ~lm_outlier`` as that test takes it, the same over the
valid frames only, keyframes and marginalized frames, with the card's name and
power limit.  That test's own count is the population this configuration is
known by; the bench's dense path (``testing/paths.py``) is another
configuration (VGA, advance 0.08, seed 7, factor 2.0, 1200 immature points).
Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import torch

from dsopp_tpu_torch.testing.paths import card_line
from dsopp_tpu_torch.testing.synthetic import render_sequence
from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

NUM_FRAMES, INIT_FRAMES = 104, 8


def run():
    seq = render_sequence(num_frames=NUM_FRAMES, height=240, width=320, seed=9, advance=0.07,
                          dtype=torch.float32, device="cuda")
    cfg = TrackerConfig(num_frame_slots=17, landmarks_per_frame=340, immature_per_frame=1000,
                        desired_points=5000, frontend_points=5000, keyframe_factor=3.0,
                        window_min=5, window_max=15, use_rotation_perturbations=False)
    tracker = MonocularTracker(seq.camera, cfg, dtype=torch.float32, device="cuda")
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                         seq.pose(i, torch.float32, "cuda")) for i in range(INIT_FRAMES)])
    pipe = PipelinedTracker(tracker, flush_every=16)
    keyframes = []
    for i in range(INIT_FRAMES, NUM_FRAMES):
        diag = pipe.tick(i, float(seq.timestamps[i]), seq.images[i])
        if diag.is_keyframe:
            keyframes.append((i, diag.n_active, diag.n_activated, diag.min_distance))
    pipe.finalize()
    win = tracker.window
    live = win.lm_valid & ~win.lm_outlier
    return dict(card=card_line(), keyframes=tracker.num_keyframes,
                marginalized=len(tracker.track.marginalized),
                window_frames=int(win.frame_valid.sum()),
                active_as_the_test_counts=int(live.sum()),
                active_in_valid_frames=int((live & win.frame_valid[:, None]).sum()),
                per_keyframe=[(i, int(a), int(b), round(float(c), 3))
                              for i, a, b, c in keyframes])


def main(argv):
    if not torch.cuda.is_available():
        print("dense_scale: no CUDA device", file=sys.stderr)
        return 2
    out = run()
    print(json.dumps(out))
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
