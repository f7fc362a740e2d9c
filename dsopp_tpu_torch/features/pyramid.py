"""Image pyramids of (intensity, dx, dy) pixel maps (counterpart of
``dsopp_tpu/features/pyramid.py``) — kernel K1.

Levels halve exactly (an odd trailing row/column is dropped) by 2×2 mean;
each level's map carries the gradients of :func:`image_gradients`.
:func:`build_pyramid_maps` runs the CUDA kernel ``csrc/pyramid.cu`` on a
CUDA image (every level in one launch, the maps views of one buffer) and
:func:`build_pyramid_maps_plain` on a CPU one; :func:`build_channel_map`
builds a frame embedder's ``[3C, H, W]`` map with K1's level-0 arithmetic,
one launch over the C planes.  A ``[B, H, W]`` stack of B sequences' frames
(the batched tick) gives ``[B, 3, H_l, W_l]`` maps, every frame's every
level in the same one launch.
"""

from __future__ import annotations

import functools

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.interpolate import build_pixel_map, image_gradients

NUM_PYRAMID_LEVELS = 5
MAX_CUDA_LEVELS = 6    # csrc/pyramid.cu: the coarsest level's tile is one pixel


def downscale(image):
    """2×2 mean, [..., H, W] → [..., H//2, W//2] (row-major summation)."""
    h = (image.shape[-2] // 2) * 2
    w = (image.shape[-1] // 2) * 2
    im = image[..., :h, :w]
    return 0.25 * (((im[..., 0::2, 0::2] + im[..., 0::2, 1::2])
                    + im[..., 1::2, 0::2]) + im[..., 1::2, 1::2])


def build_pyramid_maps_plain(image, num_levels: int = NUM_PYRAMID_LEVELS):
    """[H, W] → tuple of [3, H_l, W_l] maps, or [B, H, W] → tuple of [B, 3,
    H_l, W_l] (plain PyTorch)."""
    levels = [image]
    for _ in range(num_levels - 1):
        levels.append(downscale(levels[-1]))
    if image.dim() == 2:
        return tuple(build_pixel_map(lvl) for lvl in levels)
    return tuple(torch.stack([lvl, *image_gradients(lvl)], dim=-3) for lvl in levels)


def level_shapes(h: int, w: int, num_levels: int):
    """[(h_l, w_l)] of the pyramid's levels: each halves the one before,
    dropping an odd trailing row or column; raises when one is below 2×2."""
    shapes = []
    for level in range(num_levels):
        if level:
            h, w = h // 2, w // 2
        if h < 2 or w < 2:
            raise ValueError(f"pyramid level {level} is {h}x{w}: too small")
        shapes.append((h, w))
    return shapes


@functools.lru_cache(maxsize=None)
def _flat_layout(h: int, w: int, num_levels: int, batch: int = 0):
    """(floats of all the levels' maps, each map's (size, stride, offset) in
    that buffer), level after level as ``csrc/pyramid.cu`` writes them;
    ``batch`` > 0: B frames' [B, 3, H_l, W_l] maps a level."""
    views, offset = [], 0
    b = max(batch, 1)
    for hl, wl in level_shapes(h, w, num_levels):
        if batch:
            views.append(((b, 3, hl, wl), (3 * hl * wl, hl * wl, wl, 1), offset))
        else:
            views.append(((3, hl, wl), (hl * wl, wl, 1), offset))
        offset += 3 * hl * wl * b
    return offset, tuple(views)


def build_pyramid_maps_cuda(image, num_levels: int = NUM_PYRAMID_LEVELS):
    """[H, W] f32 CUDA image → tuple of [3, H_l, W_l] maps, or [B, H, W] →
    tuple of [B, 3, H_l, W_l] (kernel K1, one launch): contiguous views of
    one buffer, level after level."""
    batch = image.shape[0] if image.dim() == 3 else 0
    h, w = image.shape[-2:]
    kernels.check(image, "image", tuple(image.shape[:-2]) + (h, w))
    if image.dim() not in (2, 3):
        raise ValueError(f"image: expected [H, W] or [B, H, W], got {tuple(image.shape)}")
    if num_levels > MAX_CUDA_LEVELS:
        raise ValueError(f"the pyramid kernel builds at most {MAX_CUDA_LEVELS} levels,"
                         f" not {num_levels}")
    total, views = _flat_layout(h, w, num_levels, batch)
    flat = torch.empty((total,), dtype=image.dtype, device=image.device)
    kernels.PYRAMID(image, h, w, 1, num_levels, max(batch, 1), flat)
    return tuple(flat.as_strided(*view) for view in views)


def build_pyramid_maps(image, num_levels: int = NUM_PYRAMID_LEVELS):
    """[H, W] → tuple of ``num_levels`` [3, H_l, W_l] maps, [B, H, W] → of [B,
    3, H_l, W_l]; kernel on CUDA, plain on CPU."""
    if image.is_cuda:
        return build_pyramid_maps_cuda(image, num_levels)
    return build_pyramid_maps_plain(image, num_levels)


def build_channel_map_cuda(channels):
    """[C, H, W] f32 CUDA channels → [3C, H, W] map (values C | dx C | dy C),
    or S frames' [S, C, H, W] → [S, 3C, H, W]: kernel K1 at level 0, one
    launch over the S × C planes."""
    if channels.dim() not in (3, 4):
        raise ValueError(f"channels: expected [C, H, W] or [S, C, H, W], got"
                         f" {tuple(channels.shape)}")
    c, h, w = channels.shape[-3:]
    frames = channels.shape[0] if channels.dim() == 4 else 1
    kernels.check(channels, "channels", tuple(channels.shape))
    if h < 2 or w < 2:
        raise ValueError(f"a channel map of {h}x{w}: too small")
    out = torch.empty(tuple(channels.shape[:-3]) + (3 * c, h, w), dtype=channels.dtype,
                      device=channels.device)
    kernels.PYRAMID(channels, h, w, c, 1, frames, out)
    return out


def build_channel_map(channels):
    """[C, H, W] → [3C, H, W] pixel map of a frame embedder's channels, [S,
    C, H, W] → [S, 3C, H, W]; kernel on CUDA, :func:`build_pixel_map` on
    CPU."""
    if channels.is_cuda:
        return build_channel_map_cuda(channels)
    return build_pixel_map(channels)
