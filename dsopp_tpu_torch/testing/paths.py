"""The four paths that ``chip_smoke.py`` and ``profile_track`` drive on the
card, so that both run the same configuration: the corridor of the JAX
package's bench and its fast-motion corridor at the bench's standart.yaml
operating point, the corridor again at its dense.yaml operating point (17
frame slots × 340 landmarks), and the first 66 frames of the corridor at the
standart point under a static CameraMask whose lower quarter is invalid (a
rig that sees a part of itself, such as a vehicle's bonnet), all at VGA, each
after a known-pose bootstrap."""

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
}


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


# path -> (its sequence, its operating point)
PATHS = {
    "standart": ("standart", standart_config),
    "fast": ("fast", standart_config),
    "dense": ("standart", dense_config),
    "masked": ("standart", standart_config),
}
MASK_FIRST_INVALID_ROW = 360   # the masked path: rows 360..479 hold no candidate
MASKED_FRAMES = 66             # ... and it runs the first 66 frames (60 tracked)


def render_path(name: str):
    """The sequence of path ``name``, f32 on the card."""
    return render_sequence(height=HEIGHT, width=WIDTH, focal=FOCAL, dtype=torch.float32,
                           device="cuda", **SEQUENCES[PATHS[name][0]])


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


def bootstrap(seq, cfg: TrackerConfig, mask=None) -> MonocularTracker:
    """A tracker on the card, initialized on the first ``INIT_FRAMES`` frames
    of ``seq`` at their ground-truth poses."""
    tracker = MonocularTracker(seq.camera, cfg, dtype=torch.float32, device="cuda", mask=mask)
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                         seq.pose(i, torch.float32, "cuda")) for i in range(INIT_FRAMES)])
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
