"""Candidate-point selection (counterpart of
``dsopp_tpu/features/extractor.py``).

g² = dx² + dy² per pixel; a per-32×32-region threshold from the integer-
binned histogram median of the gradient magnitude (squared, × factor); the
argmax of each block sized so that #blocks ≈ 2 × the requested count; then
the ``num_points`` best blocks, ties broken toward the lower block index.

:func:`select_candidates` has a hand-written CUDA kernel (K12,
``csrc/candidates.cu``) beside its plain version and dispatches on the map's
device: a CUDA map goes to the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dsopp_tpu_torch import kernels

REGION = 32
MAX_GRADIENT_BIN = 50


class Candidates(NamedTuple):
    uv: torch.Tensor     # [N, 2] (x, y)
    grad2: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool


def top_k_stable(x, k):
    """Descending top-k with the lower index first among ties (the order of
    ``jax.lax.top_k``).  The plain versions' helper: a full stable sort."""
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


def _tile_size(h: int, w: int, num_points: int, block: int) -> int:
    return block if block else max(2, int((h * w / (2.0 * num_points)) ** 0.5))


def select_candidates_plain(pixel_map, num_points: int, mask=None, block: int = 0,
                            border: int = 4, threshold_factor: float = 2.0) -> Candidates:
    """``num_points`` well-spread high-gradient pixels of a [3, H, W] map."""
    _, h, w = pixel_map.shape
    dev, dtype = pixel_map.device, pixel_map.dtype
    g2 = pixel_map[1] * pixel_map[1] + pixel_map[2] * pixel_map[2]
    block = _tile_size(h, w, num_points, block)
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


@functools.lru_cache(maxsize=None)
def candidates_layout(h: int, w: int, tiles: int):
    """K12's scratch for an h×w map of ``tiles`` tiles → (byte offsets of the
    regions' thresholds (f32), the tiles' scores (f32) and the tiles' best
    positions (2 int32 a tile), the scratch's bytes); each array starts on a
    256-byte boundary."""
    offsets, at = [], 0
    for nbytes in (4 * (h // REGION) * (w // REGION), 4 * tiles, 8 * tiles):
        offsets.append(at)
        at += -(-nbytes // 256) * 256
    return offsets, at


def select_candidates_cuda(pixel_map, num_points: int, mask=None, block: int = 0,
                           border: int = 4, threshold_factor: float = 2.0) -> Candidates:
    """Kernel K12: same outputs as :func:`select_candidates_plain`, slot by
    slot: checks, the stream's scratch buffer (:func:`candidates_layout`),
    three output allocations and one C call of three launches; no host read.
    ``mask`` None passes no mask image to the kernel."""
    _, h, w = pixel_map.shape
    kernels.check(pixel_map, "pixel_map", (3, h, w))
    if mask is not None:
        kernels.check(mask, "mask", (h, w), torch.bool)
    block = _tile_size(h, w, num_points, block)
    tiles = (h // block) * (w // block)
    if h < REGION or w < REGION or tiles == 0:
        raise ValueError(f"select_candidates: a {h}x{w} map holds no {REGION}x{REGION} region"
                         f" or no {block}x{block} tile")
    dev = pixel_map.device
    f32 = dict(dtype=torch.float32, device=dev)
    scratch, nbytes = candidates_layout(h, w, tiles)
    base = kernels.scratch(kernels.SELECT_CANDIDATES, nbytes, dev).data_ptr()
    out = Candidates(torch.empty((num_points, 2), **f32), torch.empty((num_points,), **f32),
                     torch.empty((num_points,), dtype=torch.bool, device=dev))
    kernels.SELECT_CANDIDATES(pixel_map, mask, h, w, num_points, block, border,
                              float(threshold_factor), *(base + at for at in scratch), *out)
    return out


def select_candidates(pixel_map, num_points: int, mask=None, block: int = 0,
                      border: int = 4, threshold_factor: float = 2.0) -> Candidates:
    """Candidate selection: the kernel K12 on a CUDA map, the plain version
    on a CPU one."""
    fn = select_candidates_cuda if pixel_map.is_cuda else select_candidates_plain
    return fn(pixel_map, num_points, mask, block, border, threshold_factor)
