"""Candidate-point selection (counterpart of
``dsopp_tpu/features/extractor.py``).

g² = dx² + dy² per pixel; a per-32×32-region threshold from the integer-
binned histogram median of the gradient magnitude (squared, × factor); the
argmax of each block sized so that #blocks ≈ 2 × the requested count; then
the ``num_points`` best blocks, ties broken toward the lower block index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

REGION = 32
MAX_GRADIENT_BIN = 50


class Candidates(NamedTuple):
    uv: torch.Tensor     # [N, 2] (x, y)
    grad2: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool


def top_k_stable(x, k):
    """Descending top-k with the lower index first among ties (the order of
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _region_threshold(g2, factor):
    """Per-pixel threshold: histogram median of the region's gradient
    magnitude (50 unit bins), squared, × factor."""
    h, w = g2.shape
    rh, rw = h // REGION, w // REGION
    crop = g2[: rh * REGION, : rw * REGION]
    g = torch.clamp(torch.sqrt(crop), max=float(MAX_GRADIENT_BIN - 1))
    idx = g.long()
    regions = idx.reshape(rh, REGION, rw, REGION).permute(0, 2, 1, 3).reshape(rh * rw, -1)
    counts = torch.zeros((rh * rw, MAX_GRADIENT_BIN), dtype=torch.int64, device=g2.device)
    counts.scatter_add_(1, regions, torch.ones_like(regions))
    csum = torch.cumsum(counts, dim=-1)
    half = csum[:, -1:] // 2
    med = torch.argmax((csum > half).to(torch.uint8), dim=-1).to(g2.dtype)
    thr = (med * med * factor).reshape(rh, rw)
    yy = torch.clamp(torch.arange(h, device=g2.device) // REGION, 0, rh - 1)
    xx = torch.clamp(torch.arange(w, device=g2.device) // REGION, 0, rw - 1)
    return thr[yy[:, None], xx[None, :]]


def select_candidates(pixel_map, num_points: int, mask=None, block: int = 0,
                      border: int = 4, threshold_factor: float = 2.0) -> Candidates:
    """``num_points`` well-spread high-gradient pixels of a [3, H, W] map."""
    _, h, w = pixel_map.shape
    dev, dtype = pixel_map.device, pixel_map.dtype
    g2 = pixel_map[1] * pixel_map[1] + pixel_map[2] * pixel_map[2]
    if block == 0:
        block = max(2, int((h * w / (2.0 * num_points)) ** 0.5))
    yy = torch.arange(h, device=dev)
    xx = torch.arange(w, device=dev)
    allowed = ((yy[:, None] >= border) & (yy[:, None] < h - border)
               & (xx[None, :] >= border) & (xx[None, :] < w - border))
    if mask is not None:
        allowed = allowed & mask
    thresh = _region_threshold(g2, threshold_factor)
    score = torch.where(allowed & (g2 > thresh), g2, torch.full_like(g2, -1.0))

    bh, bw = h // block, w // block
    tiles = score[: bh * block, : bw * block].reshape(bh, block, bw, block)
    tiles = tiles.permute(0, 2, 1, 3).reshape(bh, bw, -1)
    best_in_tile = torch.argmax(tiles, dim=-1)
    best_score = torch.gather(tiles, -1, best_in_tile[..., None])[..., 0]
    py = torch.arange(bh, device=dev)[:, None] * block + best_in_tile // block
    px = torch.arange(bw, device=dev)[None, :] * block + best_in_tile % block

    flat_score = best_score.reshape(-1)
    flat_xy = torch.stack([px, py], dim=-1).reshape(-1, 2)
    k = min(num_points, flat_score.shape[0])
    top_score, top_idx = top_k_stable(flat_score, k)
    uv = flat_xy[top_idx].to(dtype)
    valid = top_score > 0
    if k < num_points:
        pad = num_points - k
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=dtype, device=dev)])
        top_score = torch.cat([top_score, torch.full((pad,), -1.0, dtype=dtype, device=dev)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return Candidates(uv, torch.clamp(top_score, min=0.0), valid)
