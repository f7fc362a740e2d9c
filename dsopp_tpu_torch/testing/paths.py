"""The five paths that ``chip_smoke.py`` and ``profile_track`` drive on the
card, so that both run the same configuration: the corridor of the JAX
package's bench and its fast-motion corridor at the bench's standart.yaml
operating point, the corridor again at its dense.yaml operating point (17
frame slots × 340 landmarks), and the first 66 frames of the corridor at the
standart point under a static CameraMask whose lower quarter is invalid (a
rig that sees a part of itself, such as a vehicle's bonnet), all at VGA,
and the long-horizon ledger case of
``tests/tracker/test_ledger_drift_tracker.py`` (150 frames at 120×160, a
window of 3..4 frames, so the ledger is folded at most keyframes), each after
a known-pose bootstrap."""

from __future__ import annotations

import subprocess

import torch

from dsopp_tpu_torch.testing.synthetic import render_sequence
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

HEIGHT, WIDTH, FOCAL = 480, 640, 520.0
INIT_FRAMES = 6
# arguments of render_sequence; "fast" is the bench's fast-motion corridor
# (beyond ~frame 107 its camera passes the back wall)
SEQUENCES = {
    "standart": dict(num_frames=120, advance=0.08, seed=7),
    "fast": dict(num_frames=96, advance=0.13, seed=11),
    "ledger": dict(num_frames=150, advance=0.07, seed=5),
}
# (height, width, focal) of a sequence that is not rendered at VGA
# (tests/tracker/test_ledger_drift_tracker.py: 120x160, render_sequence's focal)
SIZES = {"ledger": (120, 160, 260.0)}


def standart_config() -> TrackerConfig:
    """bench.py::standart_config: standart.yaml at VGA."""
    return TrackerConfig(
        num_frame_slots=10, landmarks_per_frame=250, immature_per_frame=800,
        desired_points=2000, frontend_points=2000, keyframe_factor=1.25,
        window_min=5, window_max=8, use_rotation_perturbations=True)


def dense_config() -> TrackerConfig:
    """bench.py::dense_config: dense.yaml at VGA (window 5..15 of 17 slots,
    ~5000 active points)."""
    return TrackerConfig(
        num_frame_slots=17, landmarks_per_frame=340, immature_per_frame=1200,
        desired_points=5000, frontend_points=2000, keyframe_factor=2.0,
        window_min=5, window_max=15, use_rotation_perturbations=True)


def ledger_config() -> TrackerConfig:
    """tests/tracker/test_ledger_drift_tracker.py's CFG: a small window (3..4
    of 7 slots) at 120x160, so that most keyframes fold a frame into the
    ledger."""
    return TrackerConfig(
        num_frame_slots=7, landmarks_per_frame=96, immature_per_frame=192,
        desired_points=400, frontend_points=600, keyframe_factor=3.0,
        window_min=3, window_max=4, use_rotation_perturbations=False)


# path -> (its sequence, its operating point)
PATHS = {
    "standart": ("standart", standart_config),
    "fast": ("fast", standart_config),
    "dense": ("standart", dense_config),
    "masked": ("standart", standart_config),
    "ledger": ("ledger", ledger_config),
}
MASK_FIRST_INVALID_ROW = 360   # the masked path: rows 360..479 hold no candidate
MASKED_FRAMES = 66             # ... and it runs the first 66 frames (60 tracked)


def render_path(name: str, dtype=torch.float32, device="cuda"):
    """The sequence of path ``name``, f32 on the card unless asked otherwise."""
    seq = PATHS[name][0]
    height, width, focal = SIZES.get(seq, (HEIGHT, WIDTH, FOCAL))
    return render_sequence(height=height, width=width, focal=focal, dtype=dtype,
                           device=device, **SEQUENCES[seq])


def path_config(name: str) -> TrackerConfig:
    return PATHS[name][1]()


def path_mask(name: str):
    """The CameraMask of path ``name``: [H, W] bool on the card, or None."""
    if name != "masked":
        return None
    mask = torch.ones((HEIGHT, WIDTH), dtype=torch.bool, device="cuda")
    mask[MASK_FIRST_INVALID_ROW:] = False
    return mask


def path_frames(name: str) -> int:
    """Frames of its sequence that path ``name`` runs, the bootstrap's included."""
    return MASKED_FRAMES if name == "masked" else SEQUENCES[PATHS[name][0]]["num_frames"]


def bootstrap(seq, cfg: TrackerConfig, mask=None, dtype=torch.float32,
              device="cuda") -> MonocularTracker:
    """A tracker (f32 on the card unless asked otherwise), initialized on the
    first ``INIT_FRAMES`` frames of ``seq`` at their ground-truth poses."""
    tracker = MonocularTracker(seq.camera, cfg, dtype=dtype, device=device, mask=mask)
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i].to(device, dtype),
                         seq.pose(i, dtype, device)) for i in range(INIT_FRAMES)])
    return tracker


def closed_gate(state):
    """``state`` (a ``DeviceTrackerState``) with the re-track gate closed: the
    last reliable rmse is tiny, so the base hypotheses of the next frame fail
    the gate and the perturbed hypotheses (chunks 1..21) run."""
    return state._replace(rmse_last0=torch.full_like(state.rmse_last0, 1e-3))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()
