"""The paths that ``chip_smoke.py`` and ``profile_track`` drive on the
card, so that both run the same configuration: the corridor of the JAX
package's bench and its fast-motion corridor at the bench's standart.yaml
operating point, the corridor again at its dense.yaml operating point (17
frame slots × 340 landmarks), and the first 66 frames of the corridor at the
standart point under a static CameraMask whose lower quarter is invalid (a
rig that sees a part of itself, such as a vehicle's bonnet), all at VGA,
and the long-horizon ledger case of
``tests/tracker/test_ledger_drift_tracker.py`` (150 frames at 120×160, a
window of 3..4 frames, so the ledger is folded at most keyframes), each after
a known-pose bootstrap; and the camera sensor path: the corridor written to a
folder as a camera would store it (raw u8 frames through a gamma response, a
radial vignette and an oscillating exposure, with class-id images), read back
through the provider and the camera at the standart point; and the
frame-embedder path: the corridor at the standart point with
``embedder="filter_bank"`` (C = 3 channels in the windowed BA).

Beside them, the runs of ``tests/tracker/test_monocular_e2e.py`` (240×320, 40
frames, an 8-frame known-pose bootstrap), plain and under an exposure
oscillation, which the CPU tests and ``chip_smoke.py`` both gate."""

from __future__ import annotations

import dataclasses
import math
import os
import subprocess

import numpy as np
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


def embedder_config() -> TrackerConfig:
    """The standart point with the JAX package's filter-bank embedder (C = 3),
    the C > 1 configuration a user asks for with ``frame_embedder: {type:
    filter_bank}``."""
    return dataclasses.replace(standart_config(), embedder="filter_bank")


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
    "sensor": ("standart", standart_config),
    "embedder": ("standart", embedder_config),
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


def e2e_config() -> TrackerConfig:
    """tests/tracker/test_monocular_e2e.py's configuration."""
    return TrackerConfig(
        landmarks_per_frame=200, immature_per_frame=400, desired_points=1200,
        frontend_points=1500, keyframe_factor=3.0, window_min=3, window_max=5,
        use_rotation_perturbations=False)


E2E_FRAMES, E2E_INIT_FRAMES, E2E_SIZE = 40, 8, (240, 320)


def oscillating_exposure(i: int) -> float:
    """The exposure of frame ``i`` in the JAX package's exposure test."""
    return 1.0 + 0.12 * math.sin(0.35 * i)


def e2e_run(dtype=torch.float32, device="cuda", exposure=False, replay=None):
    """tests/tracker/test_monocular_e2e.py's run on the port: the corridor at
    240×320, the known-pose bootstrap of 8 frames through
    ``MonocularTracker.tick``, then ``PipelinedTracker`` over frames 8..39.
    ``exposure``: each frame's intensities times ``oscillating_exposure(i)``
    less 4, clipped to [0, 255], with that exposure handed to the tick.
    ``replay``: called after each tick of the loop as ``replay(pipe, state,
    image, frame_id, exposure, diag)`` with the state before that tick.
    → (sequence, finalized tracker, per-frame ``TickDiag`` of frames 8..39)."""
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker

    seq = render_sequence(num_frames=E2E_FRAMES, height=E2E_SIZE[0], width=E2E_SIZE[1],
                          dtype=dtype, device=device)

    def frame(i):
        if not exposure:
            return seq.images[i], 1.0
        e = oscillating_exposure(i)
        return torch.clamp(seq.images[i] * e - 4.0, 0.0, 255.0), e

    tracker = MonocularTracker(seq.camera, e2e_config(), dtype=dtype, device=device)
    for i in range(E2E_INIT_FRAMES):
        img, e = frame(i)
        tracker.tick(i, float(seq.timestamps[i]), img, known_pose=seq.pose(i, dtype, device),
                     force_keyframe=i == E2E_INIT_FRAMES - 1, exposure=e)
    pipe = PipelinedTracker(tracker, flush_every=16)
    diags = []
    for i in range(E2E_INIT_FRAMES, E2E_FRAMES):
        img, e = frame(i)
        state = pipe.state
        diags.append(pipe.tick(i, float(seq.timestamps[i]), img, exposure=e))
        if replay is not None:
            replay(pipe, state, img, i, e, diags[-1])
    return seq, pipe.finalize(), diags


# the sensor path's camera files: raw = round(clip(G(e_i · I · V), 0, 255))
# with G the gamma response 255 (x / 255)^(1 / GAMMA), V a radial vignette
# falling to VIGNETTE_MIN in the corners, e_i = oscillating_exposure(i);
# class SEMANTIC_FILTERED on rows >= SEMANTIC_FIRST_ROW (filtered out of the
# candidates), SEMANTIC_LEFT / SEMANTIC_RIGHT above them
GAMMA, VIGNETTE_MIN = 2.2, 0.6
SEMANTIC_FIRST_ROW, SEMANTIC_FILTERED, SEMANTIC_LEFT, SEMANTIC_RIGHT = 400, 7, 3, 5


def sensor_vignette(height: int, width: int) -> np.ndarray:
    """[H, W] f32 radial attenuation: 1 at the centre, VIGNETTE_MIN at the
    corners, quadratic in the radius."""
    ys, xs = np.meshgrid(np.arange(height) - (height - 1) / 2.0,
                         np.arange(width) - (width - 1) / 2.0, indexing="ij")
    r2 = (xs ** 2 + ys ** 2) / ((height - 1) ** 2 / 4.0 + (width - 1) ** 2 / 4.0)
    return (1.0 - (1.0 - VIGNETTE_MIN) * r2).astype(np.float32)


def inverse_response() -> np.ndarray:
    """G⁻¹ at the 256 raw values: 255 (y / 255)^GAMMA."""
    return (255.0 * (np.arange(256) / 255.0) ** GAMMA).astype(np.float32)


def semantic_classes(height: int, width: int) -> np.ndarray:
    sem = np.full((height, width), SEMANTIC_RIGHT, np.uint8)
    sem[:, : width // 2] = SEMANTIC_LEFT
    sem[SEMANTIC_FIRST_ROW:] = SEMANTIC_FILTERED
    return sem


def write_sensor_folder(seq, folder: str) -> dict:
    """Write ``seq`` into ``folder`` as a camera's files: ``images/<i>.npy``
    raw u8 frames, ``times.txt`` (id timestamp exposure), ``pcalib.txt`` (G⁻¹),
    a pinhole ``calib.txt`` and ``semantics/<i>.npy`` class-id images; numpy
    and torch only.  → (the camera's config section, the count of raw pixels
    that clipped at 0 or 255); the vignette is handed to the camera as an
    array (``load_vignetting`` needs cv2)."""
    h, w = seq.images.shape[1:]
    os.makedirs(os.path.join(folder, "images"), exist_ok=True)
    os.makedirs(os.path.join(folder, "semantics"), exist_ok=True)
    vignette = torch.as_tensor(sensor_vignette(h, w), dtype=seq.images.dtype,
                               device=seq.images.device)
    sem = semantic_classes(h, w)
    clipped, lines = 0, []
    for i in range(seq.images.shape[0]):
        e = oscillating_exposure(i)
        x = seq.images[i] * e * vignette
        g = 255.0 * torch.clamp(x / 255.0, min=0.0) ** (1.0 / GAMMA)
        clipped += int(((x <= 0.0) | (g > 255.0)).sum())
        raw = torch.round(torch.clamp(g, 0.0, 255.0)).to(torch.uint8).cpu().numpy()
        np.save(os.path.join(folder, "images", f"{i}.npy"), raw)
        np.save(os.path.join(folder, "semantics", f"{i}.npy"), sem)
        lines.append(f"{i} {float(seq.timestamps[i])!r} {e!r}\n")
    with open(os.path.join(folder, "times.txt"), "w") as f:
        f.writelines(lines)
    with open(os.path.join(folder, "pcalib.txt"), "w") as f:
        f.write(" ".join(repr(float(v)) for v in inverse_response()))
    cam = seq.camera
    with open(os.path.join(folder, "calib.txt"), "w") as f:
        f.write(f"pinhole\n{w} {h}\n{cam.fx!r} {cam.fy!r} {cam.cx!r} {cam.cy!r}\n")
    return {"provider": {"type": "npy_folder", "folder": "images", "timestamps": "times.txt"},
            "model": {"calibration": "calib.txt", "photometric_calibration": "pcalib.txt"},
            "semantics": {"folder": "semantics", "filter": [SEMANTIC_FILTERED]}}, clipped


def app_config(frames_folder: str = "images", desired_points: int = 2000,
               window=(5, 8), factor: float = 1.25) -> dict:
    """The config tree of ``write_app_folder``'s files: one camera reading
    the ``.npy`` frames, no poses file (the feature-based bootstrap runs),
    the tracker at standart.yaml's point (2000 points, window 5..8, factor
    1.25) unless asked otherwise."""
    return {
        "sensors": [{"id": "camera_1", "type": "camera",
                     "provider": {"type": "npy_folder", "folder": frames_folder,
                                  "timestamps": "times.txt"},
                     "model": {"calibration": "calib.txt"}}],
        "time": {"type": "no_synchronization"},
        "tracker": {"type": "monocular", "sensor_id": "camera_1",
                    "number_of_desired_points": desired_points,
                    "keyframe_strategy": {"strategy": "mean_square_optical_flow",
                                          "factor": factor},
                    "marginalization_strategy": {"strategy": "sparse",
                                                 "minimum_size": window[0],
                                                 "maximum_size": window[1]}},
    }


def write_app_folder(seq, folder: str, config: dict, frames: int = None) -> str:
    """Write the first ``frames`` frames of ``seq`` (all by default) into
    ``folder`` as an application's input: ``images/<i>.npy`` u8 frames
    (the rendered intensities rounded and clipped to 0..255), ``times.txt``
    (id timestamp), a pinhole ``calib.txt`` and ``config`` as the JSON file
    ``mono.json``; numpy, torch and json only → the config file's path."""
    import json

    frames = seq.images.shape[0] if frames is None else frames
    h, w = seq.images.shape[1:]
    os.makedirs(os.path.join(folder, "images"), exist_ok=True)
    lines = []
    for i in range(frames):
        raw = torch.round(torch.clamp(seq.images[i], 0.0, 255.0)).to(torch.uint8)
        np.save(os.path.join(folder, "images", f"{i}.npy"), raw.cpu().numpy())
        lines.append(f"{i} {float(seq.timestamps[i])!r}\n")
    with open(os.path.join(folder, "times.txt"), "w") as f:
        f.writelines(lines)
    cam = seq.camera
    with open(os.path.join(folder, "calib.txt"), "w") as f:
        f.write(f"pinhole\n{w} {h}\n{cam.fx!r} {cam.fy!r} {cam.cx!r} {cam.cy!r}\n")
    path = os.path.join(folder, "mono.json")
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    return path


def sensor_camera(folder: str, params: dict, device="cuda"):
    """The camera of a folder written by :func:`write_sensor_folder`, with
    the path's vignette."""
    from dsopp_tpu_torch.sensors.camera import Camera

    camera = Camera.from_config("camera_1", params, base_dir=folder, device=device)
    h, w = int(camera.camera_model().height), int(camera.camera_model().width)
    camera.settings.vignetting = sensor_vignette(h, w)
    return camera


def sensor_bootstrap(camera, seq, cfg: TrackerConfig, device="cuda"):
    """An f32 tracker on ``camera``'s model with its semantic filter, bootstrapped
    on the first ``INIT_FRAMES`` frames the camera reads, at their ground-
    truth poses, with their exposures and class-id images."""
    tracker = MonocularTracker(camera.camera_model(), cfg, dtype=torch.float32,
                               device=device, mask=camera.processed_mask())
    tracker.semantic_filter = camera.semantic_filter
    for i in range(INIT_FRAMES):
        frame = camera.next_frame()
        tracker.tick(frame.frame_id, frame.timestamp, frame.image,
                     known_pose=seq.pose(frame.frame_id, torch.float32, device),
                     force_keyframe=i == INIT_FRAMES - 1, semantics=frame.semantics,
                     exposure=frame.exposure)
    return tracker


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
