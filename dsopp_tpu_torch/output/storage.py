"""The saved track (counterpart of ``dsopp_tpu/output/storage.py``): one
``.npz`` with every keyframe's pose, affine brightness, exposure and
landmarks (the marginalized ones and the window's), the attached frames
and JSON metadata, in the JAX package's format, so that either package
reads what the other wrote.  ``save_track`` reads the port's ``Window``
(its tensors copied to the host once)."""

from __future__ import annotations

import json

import numpy as np


def save_track(path, track, window=None, camera_info=None):
    """Serialize an OdometryTrack (+ the live window's keyframes)."""
    kf_ids, kf_ts, kf_pose, kf_affine, kf_exposure = [], [], [], [], []
    lm_uv, lm_idepth, lm_valid, lm_slice = [], [], [], []
    attached = []

    def add_kf(fid, ts, pose, affine, exposure, uv, idep, valid, atts):
        kf_ids.append(fid)
        kf_ts.append(ts)
        kf_pose.append(np.asarray(pose, np.float64))
        kf_affine.append(np.asarray(affine, np.float64))
        kf_exposure.append(exposure)
        start = sum(len(u) for u in lm_uv)
        lm_uv.append(np.asarray(uv, np.float32))
        lm_idepth.append(np.asarray(idep, np.float32))
        lm_valid.append(np.asarray(valid, bool))
        lm_slice.append((start, start + len(uv)))
        for a in atts:
            attached.append((fid, a.frame_id, a.timestamp,
                             np.asarray(a.t_keyframe_frame, np.float64)))

    for kf in track.marginalized:
        add_kf(kf.frame_id, kf.timestamp, kf.t_wc, kf.affine, kf.exposure,
               kf.lm_uv, kf.lm_idepth, kf.lm_valid & ~kf.lm_outlier,
               kf.attached)

    if window is not None:
        mats = window.poses().matrix().cpu().numpy().astype(np.float64)
        ids = window.frame_id.cpu().numpy()
        affine = window.affine().cpu().numpy()
        exposure = window.exposure.cpu().numpy()
        uv = window.lm_uv.cpu().numpy()
        idepth = window.lm_idepth.cpu().numpy()
        live = (window.lm_valid & ~window.lm_outlier).cpu().numpy()
        for pos in range(int(window.frame_valid.sum())):
            fid = int(ids[pos])
            add_kf(fid, track.keyframe_timestamps.get(fid, 0.0), mats[pos], affine[pos],
                   float(exposure[pos]), uv[pos], idepth[pos], live[pos],
                   track.attached.get(fid, []))

    meta = {
        "format": "dsopp_tpu_track/v1",
        "camera": camera_info or {},
        "num_keyframes": len(kf_ids),
    }
    np.savez_compressed(
        path,
        meta=json.dumps(meta),
        kf_ids=np.asarray(kf_ids, np.int64),
        kf_timestamps=np.asarray(kf_ts, np.float64),
        kf_poses=np.stack(kf_pose) if kf_pose else np.zeros((0, 4, 4)),
        kf_affine=np.stack(kf_affine) if kf_affine else np.zeros((0, 2)),
        kf_exposure=np.asarray(kf_exposure, np.float64),
        lm_uv=np.concatenate(lm_uv) if lm_uv else np.zeros((0, 2), np.float32),
        lm_idepth=np.concatenate(lm_idepth) if lm_idepth else np.zeros(0, np.float32),
        lm_valid=np.concatenate(lm_valid) if lm_valid else np.zeros(0, bool),
        lm_slices=np.asarray(lm_slice, np.int64).reshape(-1, 2),
        attached_kf=np.asarray([a[0] for a in attached], np.int64),
        attached_id=np.asarray([a[1] for a in attached], np.int64),
        attached_ts=np.asarray([a[2] for a in attached], np.float64),
        attached_pose=np.stack([a[3] for a in attached])
        if attached else np.zeros((0, 4, 4)),
    )


def load_track(path):
    """→ dict with keyframes, landmarks and attached frames."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    keyframes = []
    for i in range(len(data["kf_ids"])):
        s, e = data["lm_slices"][i]
        keyframes.append({
            "frame_id": int(data["kf_ids"][i]),
            "timestamp": float(data["kf_timestamps"][i]),
            "t_wc": data["kf_poses"][i],
            "affine": data["kf_affine"][i],
            "exposure": float(data["kf_exposure"][i]),
            "lm_uv": data["lm_uv"][s:e],
            "lm_idepth": data["lm_idepth"][s:e],
            "lm_valid": data["lm_valid"][s:e],
        })
    attached = [
        {
            "keyframe_id": int(data["attached_kf"][i]),
            "frame_id": int(data["attached_id"][i]),
            "timestamp": float(data["attached_ts"][i]),
            "t_keyframe_frame": data["attached_pose"][i],
        }
        for i in range(len(data["attached_kf"]))
    ]
    return {"meta": meta, "keyframes": keyframes, "attached": attached}


def point_cloud(track_data, min_idepth=1e-3):
    """World-frame [N, 3] point cloud from a loaded track (pydsopp
    las/json exporter analog)."""
    points = []
    for kf in track_data["keyframes"]:
        valid = kf["lm_valid"] & (kf["lm_idepth"] > min_idepth)
        if not valid.any():
            continue
        uv = kf["lm_uv"][valid]
        idep = kf["lm_idepth"][valid]
        cam = track_data["meta"].get("camera", {})
        fx = cam.get("fx", 1.0)
        fy = cam.get("fy", 1.0)
        cx = cam.get("cx", 0.0)
        cy = cam.get("cy", 0.0)
        rays = np.stack([
            (uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv)),
        ], axis=1)
        pts_cam = rays / idep[:, None]
        t = kf["t_wc"]
        pts_w = pts_cam @ t[:3, :3].T + t[:3, 3]
        points.append(pts_w)
    return np.concatenate(points) if points else np.zeros((0, 3))
