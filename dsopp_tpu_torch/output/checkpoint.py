"""Checkpoint and resume of the live tracker (counterpart of
``dsopp_tpu/output/checkpoint.py``).

The whole state of a :class:`~dsopp_tpu_torch.tracker.monocular.MonocularTracker`
— the PBA window with its float64 marginalization ledger, the immature
banks, the frontend's depth maps and the track history — goes through one
``.npz``, so that a run continues where it stopped: track with
``PipelinedTracker``, ``finalize`` it, ``save_checkpoint``; later
``load_checkpoint`` and a new ``PipelinedTracker`` on the tracker it
returns.

The file keeps the JAX package's keys for every field the port holds, and
the loader reads a checkpoint the JAX package wrote as well:

* the ledger is one float64 array here; the JAX package's double-float
  pairs (``window_h_marg`` + ``window_h_marg_lo``, and so for ``b_marg``
  and ``energy_marg``) are summed on load;
* a window of C > 1 embedder channels keeps each slot's [C, H, W] channels
  as ``window_patch_channels`` (the port's in slot order; the JAX
  package's in the order of its patch table, read through the saved
  ``window_patch_map``), and the channel bank is rebuilt from them with
  ``features.pyramid.build_channel_map``; the JAX package's patch table is
  not rebuilt;
* the frontend's per-level points and flow points are rebuilt from the saved
  depth maps and the newest keyframe's pyramid, as the JAX package's loader
  rebuilds them (``tracker/depth_map.py::depth_map_level_points``);
* the keyframe strategy's rmse memory is ``MonocularTracker.kf_rmse``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from dsopp_tpu_torch import default_device, settings
from dsopp_tpu_torch.convert import tensor
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features.pyramid import build_channel_map, build_pyramid_maps
from dsopp_tpu_torch.solvers.pba import LEDGER_DTYPE, Window, frame_count
from dsopp_tpu_torch.track.state import AttachedFrame, MarginalizedKeyframe
from dsopp_tpu_torch.tracker.depth_estimation import ImmaturePoints
from dsopp_tpu_torch.tracker.depth_map import FLOW_CAP, depth_map_level_points

_WINDOW_FIELDS = [
    "t_lin_q", "t_lin_t", "affine0", "eps", "exposure", "frame_valid",
    "frame_fixed", "frame_marg", "frame_id", "lm_uv", "lm_patch",
    "lm_idepth", "lm_valid", "lm_marg_flag", "lm_outlier", "lm_inliers",
    "lm_opt_count", "lm_baseline", "res_status", "h_marg", "b_marg",
    "energy_marg", "maps",
]
_LEDGER_FIELDS = ("h_marg", "b_marg", "energy_marg")
_IMM_FIELDS = list(ImmaturePoints._fields)
_MARG_LANDMARK_FIELDS = ("uv", "idepth", "valid", "outlier", "baseline")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_checkpoint(path, tracker):
    """Write a :class:`MonocularTracker` to ``path`` (.npz).  A tracker that
    ``PipelinedTracker`` drove must be ``finalize``d first: its state lives
    in the pipeline until then."""
    win = tracker.window
    arrays = {f"window_{f}": _host(getattr(win, f)) for f in _WINDOW_FIELDS}
    c = win.num_channels
    if c > 1:
        arrays["window_patch_channels"] = _host(win.channel_maps[:, :c])
    if tracker.immature is not None:
        for f in _IMM_FIELDS:
            arrays[f"imm_{f}"] = _host(getattr(tracker.immature, f))
    if tracker.depth_maps is not None:
        for lvl, (i, w) in enumerate(zip(*tracker.depth_maps)):
            arrays[f"dmap_i_{lvl}"] = _host(i)
            arrays[f"dmap_w_{lvl}"] = _host(w)

    track = tracker.track
    meta = {
        "num_keyframes": tracker.num_keyframes,
        "rmse_last": [float(v) for v in tracker.rmse_last],
        "last_affine": _host(tracker.last_affine).tolist(),
        "t_w_last": None if tracker.t_w_last is None else
            [_host(tracker.t_w_last.q).tolist(), _host(tracker.t_w_last.t).tolist()],
        "t_prev_rel": [_host(tracker.t_prev_rel.q).tolist(),
                       _host(tracker.t_prev_rel.t).tolist()],
        "min_distance": float(tracker.min_distance),
        "keyframe_timestamps": {str(k): v for k, v in track.keyframe_timestamps.items()},
        "num_levels": 0 if tracker.depth_maps is None else len(tracker.depth_maps[0]),
        "keyframe_rmse": float(tracker.kf_rmse),
    }
    marg = []
    for i, kf in enumerate(track.marginalized):
        marg.append({
            "frame_id": kf.frame_id, "timestamp": kf.timestamp, "exposure": kf.exposure,
            "attached": [{"frame_id": a.frame_id, "timestamp": a.timestamp,
                          "keyframe_id": a.keyframe_id, "exposure": a.exposure}
                         for a in kf.attached]})
        for f in _MARG_LANDMARK_FIELDS:
            arrays[f"marg_lm_{i}_{f}"] = getattr(kf, f"lm_{f}")
        if kf.lm_semantic is not None:
            arrays[f"marg_lm_{i}_semantic"] = kf.lm_semantic
        for j, a in enumerate(kf.attached):
            arrays[f"marg_att_{i}_{j}"] = a.t_keyframe_frame
    meta["marginalized"] = marg
    arrays["marg_t_wc"] = (np.stack([kf.t_wc for kf in track.marginalized])
                           if track.marginalized else np.zeros((0, 4, 4)))
    arrays["marg_affine"] = (np.stack([kf.affine for kf in track.marginalized])
                             if track.marginalized else np.zeros((0, 2)))
    live = []
    for kf_id, frames in track.attached.items():
        for j, a in enumerate(frames):
            arrays[f"live_att_{kf_id}_{j}"] = a.t_keyframe_frame
            live.append({"keyframe_id": kf_id, "frame_id": a.frame_id,
                         "timestamp": a.timestamp, "j": j, "exposure": a.exposure})
    meta["live_attached"] = live
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def _window(data, dtype, device) -> Window:
    """The saved window → the port's, the ledger summed in float64 and the
    channel bank rebuilt (see the module notes)."""
    fields = {}
    for f in _WINDOW_FIELDS:
        if f in _LEDGER_FIELDS:
            ledger = data[f"window_{f}"].astype(np.float64)
            if f"window_{f}_lo" in data:
                ledger = ledger + data[f"window_{f}_lo"].astype(np.float64)
            fields[f] = torch.as_tensor(ledger, dtype=LEDGER_DTYPE, device=device)
        else:
            fields[f] = tensor(data[f"window_{f}"], dtype, device)
    fields["channel_maps"] = None
    if "window_patch_channels" in data:
        planes = data["window_patch_channels"]                      # [K, C, H, W]
        if "window_patch_map" in data:          # the JAX package's patch-table order
            planes = planes[data["window_patch_map"].astype(np.int64)]
        if planes.shape[1] > 1:
            fields["channel_maps"] = torch.stack(
                [build_channel_map(tensor(p, dtype, device)) for p in planes])
    return Window(**fields)


def load_checkpoint(path, camera, config=None, dtype=None, device=None):
    """A :class:`MonocularTracker` from a checkpoint the port or the JAX
    package wrote, in ``dtype`` (default ``settings.dtype``) on ``device``
    (``None``: the CUDA card).  ``config``: the run's ``TrackerConfig``; by
    default one sized from the saved window."""
    from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    dtype = settings.dtype if dtype is None else dtype
    device = default_device(device)
    window = _window(data, dtype, device)
    if config is None:
        config = TrackerConfig(num_frame_slots=window.num_slots,
                               landmarks_per_frame=window.num_landmark_slots,
                               embedder="identity" if window.num_channels == 1
                               else "filter_bank")
    tracker = MonocularTracker(camera, config, dtype=dtype, device=device)
    tracker.window = window
    if "imm_uv" in data:
        tracker.immature = ImmaturePoints(*(tensor(data[f"imm_{f}"], dtype, device)
                                            for f in _IMM_FIELDS))
    levels = meta["num_levels"]
    newest = frame_count(window) - 1
    if levels:
        idepth = tuple(tensor(data[f"dmap_i_{l}"], dtype, device) for l in range(levels))
        weight = tuple(tensor(data[f"dmap_w_{l}"], dtype, device) for l in range(levels))
        tracker.depth_maps = (idepth, weight)
        # the newest keyframe's pyramid, from its level-0 intensity
        maps = build_pyramid_maps(window.maps[newest][0].contiguous(), levels)
        tracker.level_points = [
            depth_map_level_points(idepth[l], weight[l], maps[l], config.frontend_points)
            for l in range(levels)]
        tracker.flow_points = depth_map_level_points(idepth[0], weight[0], maps[0], FLOW_CAP)

    d = dict(dtype=dtype, device=device)
    tracker.num_keyframes = meta["num_keyframes"]
    tracker.kf_id = int(window.frame_id[newest]) if newest >= 0 else -1
    tracker.rmse_last = list(meta["rmse_last"])
    tracker.last_affine = torch.tensor(meta["last_affine"], **d)
    if meta["t_w_last"] is not None:
        tracker.t_w_last = SE3(torch.tensor(meta["t_w_last"][0], **d),
                               torch.tensor(meta["t_w_last"][1], **d))
    tracker.t_prev_rel = SE3(torch.tensor(meta["t_prev_rel"][0], **d),
                             torch.tensor(meta["t_prev_rel"][1], **d))
    tracker.min_distance = float(meta["min_distance"])
    tracker.kf_rmse = float(meta["keyframe_rmse"])

    track = tracker.track
    track.keyframe_timestamps = {int(k): v for k, v in meta["keyframe_timestamps"].items()}
    for i, kfm in enumerate(meta["marginalized"]):
        attached = [AttachedFrame(a["frame_id"], a["timestamp"], a["keyframe_id"],
                                  data[f"marg_att_{i}_{j}"], exposure=a["exposure"])
                    for j, a in enumerate(kfm["attached"])]
        semantic = data[f"marg_lm_{i}_semantic"] if f"marg_lm_{i}_semantic" in data else None
        track.marginalized.append(MarginalizedKeyframe(
            frame_id=kfm["frame_id"], timestamp=kfm["timestamp"], t_wc=data["marg_t_wc"][i],
            affine=data["marg_affine"][i], exposure=kfm["exposure"],
            **{f"lm_{f}": data[f"marg_lm_{i}_{f}"] for f in _MARG_LANDMARK_FIELDS},
            attached=attached, lm_semantic=semantic))
    for a in meta["live_attached"]:
        track.attached.setdefault(a["keyframe_id"], []).append(AttachedFrame(
            a["frame_id"], a["timestamp"], a["keyframe_id"],
            data[f"live_att_{a['keyframe_id']}_{a['j']}"], exposure=a["exposure"]))
    return tracker
