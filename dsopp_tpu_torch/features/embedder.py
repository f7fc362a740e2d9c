"""Frame embedders: [H, W] intensity → [C, H, W] feature channels
(counterpart of ``dsopp_tpu/features/embedder.py``).

The embedded keyframe feeds the windowed BA: its ``[3C, H, W]`` pixel map
(:func:`~dsopp_tpu_torch.core.interpolate.build_pixel_map`) is the window's
channel bank, the BA residuals run per channel with whole-patch Huber at
σ·√C, and the frontend alignment and the epipolar tracer stay C = 1, as in
the JAX package.  ``make_embedder("filter_bank")`` is the open C = 3
stand-in for the reference's learned embedder.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _default_bank():
    """The JAX package's default bank: the identity and two lightly
    smoothed mixtures, [3, 3, 3]."""
    ident = torch.zeros((3, 3), dtype=torch.float64)
    ident[1, 1] = 1.0
    blur = torch.ones((3, 3), dtype=torch.float64) / 9.0
    return torch.stack([ident, 0.85 * ident + 0.15 * blur, 0.7 * ident + 0.3 * blur])


class IdentityEmbedder:
    """C = 1: the raw photometric frame."""

    channels = 1

    def __call__(self, image):
        return image[None] if image.dim() == 2 else image


class FilterBankEmbedder:
    """C channels by a depthwise 3×3 cross-correlation with zero padding
    ("SAME"), computed in float32 and cast back to the image's type, as the
    JAX package does even in a float64 run.  ``filters``: [C, 3, 3] (array
    or tensor); by default the JAX package's bank."""

    def __init__(self, filters=None):
        bank = _default_bank() if filters is None else torch.as_tensor(filters)
        if bank.dim() != 3 or tuple(bank.shape[1:]) != (3, 3):
            raise ValueError(f"filters: expected [C, 3, 3], got {tuple(bank.shape)}")
        self.filters = bank
        self.channels = int(bank.shape[0])
        self._kernels = {}                  # device -> the f32 [C, 1, 3, 3] bank there

    def __call__(self, image):
        """[H, W] → [C, H, W]; [S, H, W] (S frames) → [S, C, H, W] in one
        convolution."""
        k = self._kernels.get(image.device)
        if k is None:
            k = self.filters[:, None].to(device=image.device, dtype=torch.float32)
            self._kernels[image.device] = k
        x = image.reshape((-1, 1) + tuple(image.shape[-2:])).to(torch.float32)  # [S, 1, H, W]
        out = F.conv2d(x, k, padding=1).to(image.dtype)                       # [S, C, H, W]
        return out[0] if image.dim() == 2 else out


def make_embedder(name: str = "identity", **kw):
    """The embedder called ``name`` ("identity" or "filter_bank")."""
    if name == "identity":
        return IdentityEmbedder()
    if name == "filter_bank":
        return FilterBankEmbedder(**kw)
    raise ValueError(f"unknown embedder '{name}'")
