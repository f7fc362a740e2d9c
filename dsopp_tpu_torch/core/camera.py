"""Pinhole camera model with its analytic projection Jacobian (counterpart
of ``dsopp_tpu/core/camera.py``; pinhole only).

Intrinsics are plain Python floats: they are fixed per run, broadcast into
tensor arithmetic as weak scalars (so an f32 tensor stays f32 and an f64 one
f64), and the CUDA kernels take them by value without a device readback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BORDER_SIZE = 4.0
MIN_DEPTH = 1e-3
MIN_IDEPTH = -1e-4
MAX_IDEPTH = 1.0 / MIN_DEPTH + 10.0


def _inside_roi(uv, width, height, border):
    """uv [..., 2] within [border, size - border - 1]."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= border) & (v >= border)
            & (u <= width - border - 1.0) & (v <= height - border - 1.0))


def valid_idepth(idepth):
    return (idepth > MIN_IDEPTH) & (idepth < MAX_IDEPTH)


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


class Pinhole(NamedTuple):
    """Pinhole model uv = f * xy / z + c; ``width``/``height`` in pixels."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: float
    height: float

    @staticmethod
    def create(image_size, focal, principal) -> "Pinhole":
        return Pinhole(float(focal[0]), float(focal[1]), float(principal[0]),
                       float(principal[1]), float(image_size[0]),
                       float(image_size[1]))

    def scaled(self, scale) -> "Pinhole":
        """Model for a pyramid level downscaled by ``scale`` (2**level)."""
        s = float(scale)
        return Pinhole(self.fx / s, self.fy / s, self.cx / s, self.cy / s,
                       self.width / s, self.height / s)

    def project(self, p3d, border=BORDER_SIZE):
        """[..., 3] → (uv [..., 2], valid [...])."""
        z = p3d[..., 2]
        z_safe = _safe_z(z)
        u = self.fx * p3d[..., 0] / z_safe + self.cx
        v = self.fy * p3d[..., 1] / z_safe + self.cy
        uv = torch.stack([u, v], dim=-1)
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.width, self.height, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        """[..., 3] → (uv, J = d(uv)/d(p3d) [..., 2, 3], valid)."""
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        iz = 1.0 / _safe_z(z)
        iz2 = iz * iz
        uv = torch.stack([self.fx * x * iz + self.cx, self.fy * y * iz + self.cy], -1)
        zero = torch.zeros_like(x)
        j = torch.stack(
            [self.fx * iz, zero, -self.fx * x * iz2,
             zero, self.fy * iz, -self.fy * y * iz2],
            dim=-1,
        ).reshape(x.shape + (2, 3))
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.width, self.height, border)
        return uv, j, valid

    def unproject(self, uv):
        """[..., 2] → ray [..., 3] with z = 1."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)
