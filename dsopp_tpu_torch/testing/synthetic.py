"""Synthetic ground-truth corridor sequence (counterpart of
``dsopp_tpu/testing/synthetic.py``), rendered with PyTorch on any device.

Scene: a corridor of five textured planes (multi-octave value noise around
intensity 128); camera: pinhole flying forward with a lateral sinusoid and
yaw/pitch/roll wobble.  The texture grids and the trajectory are the
reference's (numpy, from the same seed), so the frames match the JAX
package's renders to rounding of the working dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dsopp_tpu_torch import default_device
from dsopp_tpu_torch.core.camera import Pinhole
from dsopp_tpu_torch.core.lie import SE3, quat_to_matrix

_OCTAVES = (0.7, 1.9, 4.3, 9.1)
_TILE = 64


def _corridor_planes(seed: int = 7):
    """(point, normal, e1, e2, noise grids [octaves, 64, 64]) per plane."""
    ex, ey, ez = np.eye(3)
    specs = [
        (np.array([0, 1.5, 0.0]), -ey, ex, ez),    # floor
        (np.array([0, -1.5, 0.0]), ey, ex, ez),    # ceiling
        (np.array([-2.0, 0, 0.0]), ex, ey, ez),    # left wall
        (np.array([2.0, 0, 0.0]), -ex, ey, ez),    # right wall
        (np.array([0, 0, 14.0]), -ez, ex, ey),     # back wall
    ]
    planes = []
    for i, (p, n, e1, e2) in enumerate(specs):
        rng = np.random.default_rng(seed + i)
        grids = np.stack([rng.standard_normal((_TILE, _TILE)) for _ in _OCTAVES])
        planes.append((p, n, e1, e2, grids))
    return planes


def _so3_exp_quat_np(omega):
    omega = np.asarray(omega, np.float64)
    theta = np.linalg.norm(omega)
    if theta < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    return np.concatenate([[np.cos(0.5 * theta)], np.sin(0.5 * theta) * omega / theta])


def corridor_trajectory(num_frames: int, advance: float = 0.08):
    """(q [F, 4], t [F, 3]) numpy float64 camera-to-world poses."""
    qs, ts = [], []
    for i in range(num_frames):
        x = 0.35 * np.sin(0.05 * i)
        y = 0.12 * np.sin(0.083 * i + 1.0)
        yaw = 0.06 * np.sin(0.041 * i + 0.5)
        pitch = 0.025 * np.sin(0.071 * i)
        roll = 0.02 * np.sin(0.031 * i + 2.0)
        qs.append(_so3_exp_quat_np([pitch, yaw, roll]))
        ts.append([x, y, advance * i])
    return np.asarray(qs), np.asarray(ts, np.float64)


def _noise(grid, u, v):
    iu, iv = torch.floor(u), torch.floor(v)
    fu, fv = u - iu, v - iv
    fu = fu * fu * (3.0 - 2.0 * fu)
    fv = fv * fv * (3.0 - 2.0 * fv)
    iu = torch.remainder(iu.long(), _TILE)
    iv = torch.remainder(iv.long(), _TILE)
    iu1 = torch.remainder(iu + 1, _TILE)
    iv1 = torch.remainder(iv + 1, _TILE)
    return (grid[iv, iu] * (1 - fu) * (1 - fv) + grid[iv, iu1] * fu * (1 - fv)
            + grid[iv1, iu] * (1 - fu) * fv + grid[iv1, iu1] * fu * fv)


def _render_view(rays_c, q, t, planes):
    r_wc = quat_to_matrix(q)
    rays_w = rays_c @ r_wc.T
    best = torch.full(rays_c.shape[:2], float("inf"), dtype=rays_c.dtype, device=rays_c.device)
    image = torch.zeros_like(best)
    for p0, n, e1, e2, grids in planes:
        denom = rays_w @ n
        t_hit = torch.dot(p0 - t, n) / denom
        valid = (denom < -1e-9) & (t_hit > 1e-6) & (t_hit < best)
        t_safe = torch.where(valid, t_hit, torch.zeros_like(t_hit))
        rel = t + t_safe[..., None] * rays_w - p0
        s, r = rel @ e1, rel @ e2
        tex = torch.zeros_like(s)
        amp = 1.0
        for grid, f in zip(grids, _OCTAVES):
            tex = tex + amp * _noise(grid, s * f, r * f)
            amp *= 0.55
        image = torch.where(valid, 128.0 + 45.0 * tex / 1.8, image)
        best = torch.where(valid, t_hit, best)
    return image, best * rays_c[..., 2]


@dataclass
class SyntheticSequence:
    camera: Pinhole
    images: torch.Tensor     # [F, H, W] intensities 0..255
    depths: torch.Tensor     # [F, H, W] camera-frame z depth
    poses_q: np.ndarray      # [F, 4] T_wc rotation (float64)
    poses_t: np.ndarray      # [F, 3]
    timestamps: np.ndarray   # [F] seconds

    def pose(self, i, dtype=torch.float64, device=None) -> SE3:
        """T_wc of frame ``i`` on ``device`` (``None``: where the images are)."""
        device = self.images.device if device is None else device
        return SE3(torch.tensor(self.poses_q[i], dtype=dtype, device=device),
                   torch.tensor(self.poses_t[i], dtype=dtype, device=device))


def render_sequence(num_frames: int = 24, height: int = 240, width: int = 320,
                    focal: float = 260.0, seed: int = 7, advance: float = 0.08,
                    dtype=torch.float64, device=None) -> SyntheticSequence:
    """Render the corridor sequence on ``device`` (``None``: the CUDA card)
    in ``dtype``."""
    device = default_device(device)
    camera = Pinhole.create((float(width), float(height)), (focal, focal),
                            (width / 2.0 - 0.5, height / 2.0 - 0.5))
    kw = dict(dtype=dtype, device=device)
    planes = [tuple(torch.as_tensor(a, **kw) for a in plane)
              for plane in _corridor_planes(seed)]
    ys, xs = torch.meshgrid(torch.arange(height, **kw), torch.arange(width, **kw),
                            indexing="ij")
    rays_c = camera.unproject(torch.stack([xs, ys], dim=-1))
    qs, ts = corridor_trajectory(num_frames, advance)
    images = torch.empty((num_frames, height, width), **kw)
    depths = torch.empty_like(images)
    for i in range(num_frames):
        images[i], depths[i] = _render_view(rays_c, torch.as_tensor(qs[i], **kw),
                                            torch.as_tensor(ts[i], **kw), planes)
    return SyntheticSequence(camera, images, depths, qs, ts, np.arange(num_frames) / 30.0)
