"""Candidate-point selection (counterpart of
``dsopp_tpu/features/extractor.py``).

g² = dx² + dy² per pixel; a per-32×32-region threshold from the integer-
binned histogram median of the gradient magnitude (squared, × factor); the
argmax of each block sized so that #blocks ≈ 2 × the requested count; then
the ``num_points`` best blocks, ties broken toward the lower block index.

:func:`select_candidates` has a hand-written CUDA kernel (K12,
``csrc/candidates.cu``) beside its plain version and dispatches on the map's
device: a CUDA map goes to the kernel or raises.
:func:`select_candidates_sequences` selects the candidates of S sequences of
a stack of B maps (the keyframes of a batched tick) in one call: on the card
one launch a kernel for all S, on the CPU the plain version once a sequence;
the solo call is its S = 1 case.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.solvers.pba import _kernel_sequences, sequence_list

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
def candidates_layout(h: int, w: int, tiles: int, seqs: int = 1):
    """K12's scratch for ``seqs`` h×w maps of ``tiles`` tiles → (byte offsets
    of the regions' thresholds (f32), the tiles' scores (f32) and the tiles'
    best positions (2 int32 a tile), each array [seqs, one map's], the
    scratch's bytes); each array starts on a 256-byte boundary."""
    offsets, at = [], 0
    for nbytes in (4 * seqs * (h // REGION) * (w // REGION), 4 * seqs * tiles,
                   8 * seqs * tiles):
        offsets.append(at)
        at += -(-nbytes // 256) * 256
    return offsets, at


def select_candidates_cuda(pixel_map, num_points: int, mask=None, block: int = 0,
                           border: int = 4, threshold_factor: float = 2.0) -> Candidates:
    """Kernel K12: same outputs as :func:`select_candidates_plain`, slot by
    slot: checks, the stream's scratch buffer (:func:`candidates_layout`),
    three output allocations and one C call of three launches; no host read.
    ``mask`` None passes no mask image to the kernel.  The one-sequence case
    of :func:`_select_candidates_sequences_cuda`."""
    return _select_candidates_sequences_cuda(pixel_map, (0,), num_points, mask, block, border,
                                             threshold_factor, stacked=False)


def _select_candidates_sequences_cuda(maps, seqs: tuple, num_points: int, mask=None,
                                      block: int = 0, border: int = 4,
                                      threshold_factor: float = 2.0,
                                      stacked: bool = True) -> Candidates:
    """Kernel K12 for the S sequences ``seqs`` (a checked host list) of a
    stack of maps [B, 3, H, W], read through the list (never copied), one
    launch a kernel for all S → :class:`Candidates` with a leading [S] axis.
    ``mask``: the batch's one [H, W] mask or None.  ``stacked=False``: one
    map, ``seqs`` (0,), the outputs without the sequence axis."""
    lead = tuple(maps.shape[:1]) if stacked else ()
    batch = lead[0] if stacked else 1
    h, w = maps.shape[-2:]
    kernels.check(maps, "pixel_map", lead + (3, h, w))
    if mask is not None:
        kernels.check(mask, "mask", (h, w), torch.bool)
    block = _tile_size(h, w, num_points, block)
    tiles = (h // block) * (w // block)
    if h < REGION or w < REGION or tiles == 0:
        raise ValueError(f"select_candidates: a {h}x{w} map holds no {REGION}x{REGION} region"
                         f" or no {block}x{block} tile")
    dev = maps.device
    f32 = dict(dtype=torch.float32, device=dev)
    size = len(seqs)
    own = (size,) if stacked else ()
    scratch, nbytes = candidates_layout(h, w, tiles, size)
    base = kernels.scratch(kernels.SELECT_CANDIDATES, nbytes, dev).data_ptr()
    out = Candidates(torch.empty(own + (num_points, 2), **f32),
                     torch.empty(own + (num_points,), **f32),
                     torch.empty(own + (num_points,), dtype=torch.bool, device=dev))
    kernels.SELECT_CANDIDATES(maps, mask, h, w, num_points, block, border,
                              float(threshold_factor), *(base + at for at in scratch), *out,
                              size, _kernel_sequences(seqs, batch, dev))
    return out


def select_candidates_sequences(maps, seqs, num_points: int, mask=None, block: int = 0,
                                border: int = 4, threshold_factor: float = 2.0) -> Candidates:
    """The candidates of the sequences ``seqs`` (a host list; None: all) of
    a stack of level-0 maps [B, 3, H, W] → :class:`Candidates` [S, N]: the
    kernel K12 in one launch a kernel on CUDA maps, the plain version once a
    sequence on CPU ones.  ``mask``: the batch's one [H, W] mask or None."""
    seqs = sequence_list(seqs, maps.shape[0])
    if maps.is_cuda:
        return _select_candidates_sequences_cuda(maps, seqs, num_points, mask, block, border,
                                                 threshold_factor)
    outs = [select_candidates_plain(maps[b], num_points, mask, block, border, threshold_factor)
            for b in seqs]
    return Candidates(*(torch.stack(xs) for xs in zip(*outs)))


def select_candidates(pixel_map, num_points: int, mask=None, block: int = 0,
                      border: int = 4, threshold_factor: float = 2.0) -> Candidates:
    """Candidate selection: the kernel K12 on a CUDA map, the plain version
    on a CPU one."""
    fn = select_candidates_cuda if pixel_map.is_cuda else select_candidates_plain
    return fn(pixel_map, num_points, mask, block, border, threshold_factor)
