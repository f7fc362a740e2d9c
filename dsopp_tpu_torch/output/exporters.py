"""Track exporters: JSON, point clouds, COLMAP, NeRF-style transforms
(counterpart of ``dsopp_tpu/output/exporters.py``, a numpy copy of it).

They mirror pydsopp's export tools (json, colmap, instant-ngp NeRF
transforms, a point cloud) and read the loaded track dict
(``output.storage.load_track``), so their files are byte-equal to the JAX
package's on the same track.
"""

from __future__ import annotations

import json
import os

import numpy as np

from dsopp_tpu_torch.output.storage import point_cloud
from dsopp_tpu_torch.output.tum import _matrix_to_quat


def export_json(track_data, path):
    """Human-readable JSON track (pydsopp json exporter analog)."""
    out = {
        "meta": track_data["meta"],
        "keyframes": [
            {
                "frame_id": kf["frame_id"],
                "timestamp": kf["timestamp"],
                "t_wc": np.asarray(kf["t_wc"]).tolist(),
                "affine": np.asarray(kf["affine"]).tolist(),
                "exposure": kf["exposure"],
                "landmarks": [
                    {"u": float(u), "v": float(v), "idepth": float(d)}
                    for (u, v), d, ok in zip(
                        kf["lm_uv"], kf["lm_idepth"], kf["lm_valid"]) if ok
                ],
            }
            for kf in track_data["keyframes"]
        ],
        "attached": [
            {
                "keyframe_id": a["keyframe_id"],
                "frame_id": a["frame_id"],
                "timestamp": a["timestamp"],
                "t_keyframe_frame": np.asarray(a["t_keyframe_frame"]).tolist(),
            }
            for a in track_data["attached"]
        ],
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def export_xyz(track_data, path, min_idepth=1e-3):
    """World-frame point cloud as an ``x y z`` text file (LAS-exporter
    analog; plain text keeps it dependency-free)."""
    pts = point_cloud(track_data, min_idepth)
    np.savetxt(path, pts, fmt="%.6f")
    return len(pts)


def export_ply(track_data, path, min_idepth=1e-3):
    """Binary-less ASCII PLY point cloud (opens in Meshlab/CloudCompare)."""
    pts = point_cloud(track_data, min_idepth)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    return len(pts)


def export_colmap(track_data, out_dir):
    """COLMAP sparse-model text files (cameras.txt, images.txt, points3D.txt).

    pydsopp colmap exporter analog: keyframe poses become COLMAP images
    (world→cam convention), landmarks become 3D points.
    """
    os.makedirs(out_dir, exist_ok=True)
    cam = track_data["meta"].get("camera", {})
    fx = cam.get("fx", 1.0)
    fy = cam.get("fy", 1.0)
    cx = cam.get("cx", 0.0)
    cy = cam.get("cy", 0.0)
    width = int(cam.get("width", 2 * cx))
    height = int(cam.get("height", 2 * cy))

    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        f.write(f"1 PINHOLE {width} {height} {fx} {fy} {cx} {cy}\n")

    point_id = 1
    points_lines = []
    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for i, kf in enumerate(track_data["keyframes"], start=1):
            t_wc = np.asarray(kf["t_wc"])
            r_cw = t_wc[:3, :3].T
            t_cw = -r_cw @ t_wc[:3, 3]
            q = _matrix_to_quat(r_cw)
            f.write(
                f"{i} {q[0]} {q[1]} {q[2]} {q[3]} "
                f"{t_cw[0]} {t_cw[1]} {t_cw[2]} 1 {kf['frame_id']}.png\n\n")
            rays = np.stack([
                (kf["lm_uv"][:, 0] - cx) / fx,
                (kf["lm_uv"][:, 1] - cy) / fy,
                np.ones(len(kf["lm_uv"])),
            ], axis=1)
            ok = kf["lm_valid"] & (kf["lm_idepth"] > 1e-3)
            pts_w = (rays[ok] / kf["lm_idepth"][ok][:, None]) @ t_wc[:3, :3].T \
                + t_wc[:3, 3]
            for p in pts_w:
                points_lines.append(
                    f"{point_id} {p[0]} {p[1]} {p[2]} 128 128 128 0.0\n")
                point_id += 1

    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        f.writelines(points_lines)
    return point_id - 1


def export_nerf_transforms(track_data, path):
    """instant-ngp ``transforms.json`` (pydsopp NeRF exporter analog)."""
    cam = track_data["meta"].get("camera", {})
    fx = cam.get("fx", 1.0)
    fy = cam.get("fy", 1.0)
    cx = cam.get("cx", 0.0)
    cy = cam.get("cy", 0.0)
    # OpenCV → NeRF/OpenGL camera convention: flip y and z axes
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    frames = []
    for kf in track_data["keyframes"]:
        t = np.asarray(kf["t_wc"]) @ flip
        frames.append({
            "file_path": f"images/{kf['frame_id']}.png",
            "transform_matrix": t.tolist(),
        })
    out = {
        "fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy,
        "w": int(cam.get("width", 2 * cx)), "h": int(cam.get("height", 2 * cy)),
        "camera_model": "OPENCV",
        "frames": frames,
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return len(frames)
