"""Undistortion (counterpart of ``dsopp_tpu/sensors/undistorter.py``): a
pinhole target model and remap tables from its pixels to the pixels of a
distorted source model; each frame is remapped once, after which the whole
pipeline runs on the pinhole model.

The JAX package builds the tables through its models and remaps on the host
with ``cv2.remap``.  Here both run in torch ops on the camera's device: the
tables in float64 through the port's models, the remap as a bilinear
interpolation with a replicated border (``cv2.INTER_LINEAR`` with
``cv2.BORDER_REPLICATE``, without cv2's 1/32-pixel weight table), so that a
TumFov camera (TUM-mono's model) runs on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from dsopp_tpu_torch import default_device
from dsopp_tpu_torch.core.camera import Pinhole


def remap_bilinear(image, map_x, map_y):
    """``out[y, x] = image(map_x[y, x], map_y[y, x])``, bilinear, indices
    outside the image clamped to its border; computes in ``image``'s dtype."""
    h, w = image.shape
    map_x, map_y = map_x.to(image.dtype), map_y.to(image.dtype)
    x0f, y0f = torch.floor(map_x), torch.floor(map_y)
    fx, fy = map_x - x0f, map_y - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    x_lo, x_hi = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    y_lo, y_hi = y0.clamp(0, h - 1) * w, (y0 + 1).clamp(0, h - 1) * w
    flat = image.reshape(-1)
    top = flat[y_lo + x_lo] * (1.0 - fx) + flat[y_lo + x_hi] * fx
    bottom = flat[y_hi + x_lo] * (1.0 - fx) + flat[y_hi + x_hi] * fx
    return top * (1.0 - fy) + bottom * fy


@dataclass
class Undistorter:
    """Remap tables mapping target (pinhole) pixels → source pixels."""

    target_model: Pinhole
    map_x: Optional[torch.Tensor] = None   # [H, W]; None: the identity
    map_y: Optional[torch.Tensor] = None
    _maps32: tuple = field(default=None, repr=False)

    @property
    def identity(self) -> bool:
        return self.map_x is None

    def maps32(self):
        """The tables in f32 (map_x, map_y), made once: what the remap reads."""
        if self._maps32 is None:
            self._maps32 = (self.map_x.to(torch.float32), self.map_y.to(torch.float32))
        return self._maps32

    def undistort(self, image):
        """[H, W] image (any dtype, on the tables' device) → f32 remapped image."""
        if self.identity:
            return image
        return remap_bilinear(image.to(torch.float32), *self.maps32())


def build_remaps(source_model, device=None) -> Undistorter:
    """Pinhole target and float64 remap tables for a distorted source model: the
    target keeps the source's focal length (for both axes) and principal
    point; each target pixel is unprojected through it and projected through
    the source model."""
    device = default_device(device)
    w, h = int(source_model.width), int(source_model.height)
    focal = float(source_model.f if hasattr(source_model, "f") else source_model.fx)
    cx, cy = float(source_model.cx), float(source_model.cy)
    target = Pinhole.create((float(w), float(h)), (focal, focal), (cx, cy))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    rays = target.unproject(torch.stack([xs, ys], -1).reshape(-1, 2))
    src_uv, _valid = source_model.project(rays)
    src = src_uv.reshape(h, w, 2)
    return Undistorter(target, src[..., 0].contiguous(), src[..., 1].contiguous())
