"""Offline track viewer (counterpart of ``dsopp_tpu/app/viewer.py``, the
reference's ``viewer_main``): it renders a saved ``track.bin`` (the semi-dense
cloud, coloured by height, and the trajectory) from an orbiting virtual
camera by a software z-buffered projection in numpy, and writes the views
as PNG files (``.npy`` where cv2 is missing).

Usage::

    python -m dsopp_tpu_torch.app.viewer --track track.bin --output_dir view/ \\
        [--frames 1] [--image_size 960 720] [--point_radius 1]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

from dsopp_tpu_torch.output.debug_images import _jet, save_debug_image
from dsopp_tpu_torch.output.protobuf_track import load_track_bin


def _landmark_points(track: dict) -> np.ndarray:
    """World-space 3D points from all keyframes' landmarks ([M, 3])."""
    pts = []
    for kf in track["keyframes"]:
        t_wc = kf["t_world_agent"]
        if t_wc is None:
            continue
        for sensor in kf["landmarks"]:
            for lm in sensor["points"]:
                idep = lm["idepth"]
                if idep <= 1e-9:
                    continue
                d = np.asarray(lm["direction"])
                p_c = d / idep
                pts.append(t_wc[:3, :3] @ p_c + t_wc[:3, 3])
    return np.asarray(pts).reshape(-1, 3)


def _trajectory(track: dict) -> np.ndarray:
    return np.asarray([
        kf["t_world_agent"][:3, 3] for kf in track["keyframes"]
        if kf["t_world_agent"] is not None
    ]).reshape(-1, 3)


def _look_at(eye, center, up):
    f = center - eye
    f = f / max(np.linalg.norm(f), 1e-12)
    s = np.cross(f, up)
    s = s / max(np.linalg.norm(s), 1e-12)
    u = np.cross(s, f)
    r = np.stack([s, u, f])           # world → camera rows
    t = -r @ eye
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = t
    return m


def render_cloud(points, trajectory, width=960, height=720, azimuth=0.6,
                 elevation=0.4, point_radius=1, frustum_scale=0.3):
    """Software-render the cloud + trajectory from an orbit camera → BGR."""
    img = np.zeros((height, width, 3), np.uint8)
    zbuf = np.full((height, width), np.inf, np.float32)
    if len(points) == 0 and len(trajectory) == 0:
        return img

    all_pts = points if len(points) else trajectory
    center = np.median(all_pts, axis=0)
    radius = max(np.percentile(
        np.linalg.norm(all_pts - center, axis=1), 95), 1e-3)
    eye = center + 2.8 * radius * np.asarray([
        math.cos(elevation) * math.sin(azimuth),
        -math.sin(elevation),
        -math.cos(elevation) * math.cos(azimuth),
    ])
    view = _look_at(eye, center, np.asarray([0.0, -1.0, 0.0]))
    f = 0.9 * width
    cx, cy = width / 2.0, height / 2.0

    def project(pw):
        pc = view[:3, :3] @ pw.T + view[:3, 3:4]     # [3, M]
        z = pc[2]
        ok = z > 1e-6
        u = f * pc[0] / np.maximum(z, 1e-6) + cx
        v = f * pc[1] / np.maximum(z, 1e-6) + cy
        return u, v, z, ok

    # landmark cloud, colored by height (JET)
    if len(points):
        u, v, z, ok = project(points)
        hvals = points[:, 1]
        lo, hi = np.percentile(hvals, 5), np.percentile(hvals, 95)
        colors = _jet((hvals - lo) / max(hi - lo, 1e-9))
        order = np.argsort(-z)       # far first
        r = point_radius
        for i in order:
            if not ok[i]:
                continue
            x, y = int(round(u[i])), int(round(v[i]))
            if not (0 <= x < width and 0 <= y < height):
                continue
            if z[i] >= zbuf[y, x]:
                continue
            y0, y1 = max(0, y - r), min(height, y + r + 1)
            x0, x1 = max(0, x - r), min(width, x + r + 1)
            img[y0:y1, x0:x1] = colors[i]
            zbuf[y0:y1, x0:x1] = z[i]

    # trajectory polyline + frusta
    if len(trajectory):
        u, v, z, ok = project(trajectory)
        pts2d = np.stack([u, v], -1)
        for i in range(len(pts2d) - 1):
            if ok[i] and ok[i + 1]:
                _line(img, pts2d[i], pts2d[i + 1], (0, 255, 0))
    return img


def _line(img, p0, p1, color):
    """Integer Bresenham-ish line draw (avoids a hard cv2 dependency)."""
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    for t in np.linspace(0.0, 1.0, n + 1):
        x = int(round(p0[0] + t * (p1[0] - p0[0])))
        y = int(round(p0[1] + t * (p1[1] - p0[1])))
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def render_track(track: dict, output_dir: str, frames: int = 1,
                 width: int = 960, height: int = 720, point_radius: int = 1):
    """Render ``frames`` orbit views of the track → list of file paths."""
    os.makedirs(output_dir, exist_ok=True)
    points = _landmark_points(track)
    trajectory = _trajectory(track)
    paths = []
    for i in range(frames):
        az = 0.6 + 2.0 * math.pi * i / max(frames, 1)
        img = render_cloud(points, trajectory, width, height, azimuth=az,
                           point_radius=point_radius)
        path = os.path.join(output_dir, f"view_{i:04d}.png")
        save_debug_image(path, img)
        paths.append(path)
    return paths


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser(description="offline track viewer")
    parser.add_argument("--track", required=True, help="track.bin path")
    parser.add_argument("--output_dir", default="view")
    parser.add_argument("--frames", type=int, default=1,
                        help="number of orbit views to render")
    parser.add_argument("--image_size", type=int, nargs=2, default=(960, 720))
    parser.add_argument("--point_radius", type=int, default=1)
    args = parser.parse_args(argv)

    track = load_track_bin(args.track)
    paths = render_track(track, args.output_dir, frames=args.frames,
                         width=args.image_size[0], height=args.image_size[1],
                         point_radius=args.point_radius)
    n_pts = len(_landmark_points(track))
    print(f"rendered {len(paths)} view(s) of {len(track['keyframes'])} "
          f"keyframes / {n_pts} landmarks to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
