"""Image pyramids of (intensity, dx, dy) pixel maps (counterpart of
``dsopp_tpu/features/pyramid.py``) — kernel K1.

Levels halve exactly (an odd trailing row/column is dropped) by 2×2 mean;
each level's map carries the gradients of :func:`image_gradients`.
:func:`build_pyramid_maps` runs the CUDA kernel ``csrc/pyramid.cu`` on a
CUDA image (every level in one launch, the maps views of one buffer) and
:func:`build_pyramid_maps_plain` on a CPU one; :func:`build_channel_map`
builds a frame embedder's ``[3C, H, W]`` map with K1's level-0 arithmetic,
one launch over the C planes.
"""

from __future__ import annotations

import functools

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.interpolate import build_pixel_map

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
    """[H, W] → tuple of [3, H_l, W_l] maps (plain PyTorch)."""
    levels = [image]
    for _ in range(num_levels - 1):
        levels.append(downscale(levels[-1]))
    return tuple(build_pixel_map(lvl) for lvl in levels)


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
def _flat_layout(h: int, w: int, num_levels: int):
    """(floats of all the levels' maps, each map's (size, stride, offset) in
    that buffer), level after level as ``csrc/pyramid.cu`` writes them."""
    views, offset = [], 0
    for hl, wl in level_shapes(h, w, num_levels):
        views.append(((3, hl, wl), (hl * wl, wl, 1), offset))
        offset += 3 * hl * wl
    return offset, tuple(views)


def build_pyramid_maps_cuda(image, num_levels: int = NUM_PYRAMID_LEVELS):
    """[H, W] f32 CUDA image → tuple of [3, H_l, W_l] maps (kernel K1, one
    launch): contiguous views of one buffer, level after level."""
    h, w = image.shape
    kernels.check(image, "image", (h, w))
    if num_levels > MAX_CUDA_LEVELS:
        raise ValueError(f"the pyramid kernel builds at most {MAX_CUDA_LEVELS} levels,"
                         f" not {num_levels}")
    total, views = _flat_layout(h, w, num_levels)
    flat = torch.empty((total,), dtype=image.dtype, device=image.device)
    kernels.PYRAMID(image, h, w, 1, num_levels, flat)
    return tuple(flat.as_strided(*view) for view in views)


def build_pyramid_maps(image, num_levels: int = NUM_PYRAMID_LEVELS):
    """[H, W] → tuple of ``num_levels`` maps; kernel on CUDA, plain on CPU."""
    if image.is_cuda:
        return build_pyramid_maps_cuda(image, num_levels)
    return build_pyramid_maps_plain(image, num_levels)


def build_channel_map_cuda(channels):
    """[C, H, W] f32 CUDA channels → [3C, H, W] map (values C | dx C | dy C),
    kernel K1 at level 0, one launch."""
    c, h, w = channels.shape
    kernels.check(channels, "channels", (c, h, w))
    if h < 2 or w < 2:
        raise ValueError(f"a channel map of {h}x{w}: too small")
    out = torch.empty((3 * c, h, w), dtype=channels.dtype, device=channels.device)
    kernels.PYRAMID(channels, h, w, c, 1, out)
    return out


def build_channel_map(channels):
    """[C, H, W] → [3C, H, W] pixel map of a frame embedder's channels; kernel
    on CUDA, :func:`build_pixel_map` on CPU."""
    if channels.is_cuda:
        return build_channel_map_cuda(channels)
    return build_pixel_map(channels)
