"""Host models of kernel K11's design (``csrc/ba_status.cu``), in numpy, for
the CPU tests (``tests/test_torch_status_models.py``).

* :func:`radix_select` / :func:`outlier_threshold`: the multi-block radix
  select of the two order statistics of the ok energies — a pass a digit of
  the given widths, each block's histograms of the groups whose high bits
  match a rank's prefix (a second histogram for the hi rank once the two
  prefixes part), added into one histogram in any block order, the bin of
  each rank picked from it — and the threshold from them, interpolated in
  f32 as the kernel (and ``torch.lerp``) does.  The kernel takes the top
  digit's pass over blocks of the groups and the two lower digits' over the
  candidates the top digit leaves, in one block: the same histograms.
* :func:`point_status`: the status kernel's grid — a block per (anchor, 32
  landmarks), a warp per target row, the inliers' idepth |t_i − t_j| left in
  shared memory and taken with fmaxf from 0 in target order, the count — in
  f32.
"""

from __future__ import annotations

import numpy as np

WIDTHS = (11, 11, 10)        # the kernel's digits, from the top bit down
BLOCK_GROUPS = 1024          # groups a block takes a sweep
RES_OUTLIER = 2              # solvers/pba.py::RES_OUTLIER


def _pick(hist: np.ndarray, rank: int) -> tuple:
    """The bin holding ``rank`` (0-based) and the rank left within it; the
    last bin when ``rank`` lies beyond the counts, as the kernel leaves it."""
    cum = np.cumsum(hist)
    found = np.nonzero(cum > rank)[0] if rank >= 0 else np.zeros(0, int)
    if len(found) == 0:
        return len(hist) - 1, 0
    b = int(found[0])
    below = int(cum[b - 1]) if b else 0
    return b, rank - below


def radix_select(bits: np.ndarray, ok: np.ndarray, ranks: tuple, widths=WIDTHS,
                 block_groups: int = BLOCK_GROUPS, order=None) -> tuple:
    """The bit patterns (uint32) of the order statistics ``ranks`` = (lo, hi)
    among ``bits[ok]``, as unsigned integers: a sweep a digit, each block of
    ``block_groups`` groups histogramming its groups, the blocks' histograms
    added in ``order`` (a permutation of the blocks; None: block order)."""
    bits = np.asarray(bits, np.uint32).reshape(-1)
    ok = np.asarray(ok, bool).reshape(-1)
    blocks = max(1, -(-len(bits) // block_groups))
    order = range(blocks) if order is None else order
    prefix = [0, 0]
    rank = list(ranks)
    shift = 32
    for width in widths:
        known = (0xFFFFFFFF << shift) & 0xFFFFFFFF if shift < 32 else 0
        shift -= width
        parted = prefix[0] != prefix[1]
        hist = np.zeros((2, 1 << width), np.int64)
        for b in order:
            sl = slice(b * block_groups, (b + 1) * block_groups)
            x, take = bits[sl], ok[sl]
            high = x & np.uint32(known)
            digit = (x >> np.uint32(shift)) & np.uint32((1 << width) - 1)
            lo = take & (high == prefix[0])
            hi = take & ~lo & parted & (high == prefix[1])
            hist[0] += np.bincount(digit[lo], minlength=1 << width)
            hist[1] += np.bincount(digit[hi], minlength=1 << width)
        picked = [_pick(hist[0], rank[0]), _pick(hist[1 if parted else 0], rank[1])]
        for s in range(2):
            prefix[s] |= picked[s][0] << shift
            rank[s] = picked[s][1]
    return np.uint32(prefix[0]), np.uint32(prefix[1])


def outlier_threshold(energy: np.ndarray, ok: np.ndarray, quantile: float, sigma: float,
                      **select) -> np.float32:
    """K11's threshold: the ``quantile`` of the ok energies (f32, >= 0) by
    :func:`radix_select` and the interpolation between the two order
    statistics, plus sigma² / 2 (0 + sigma² / 2 when no group is ok)."""
    f32 = np.float32
    energy = np.asarray(energy, f32).reshape(-1)
    m = int(np.count_nonzero(ok))
    at = f32(quantile) * f32(m - 1)
    ranks = (int(np.floor(at)), int(np.ceil(at)))
    lo, hi = radix_select(energy.view(np.uint32), ok, ranks, **select)
    q = f32(0.0)
    if m > 0:
        w = at - np.floor(at)
        v_lo, v_hi = np.array([lo, hi], np.uint32).view(f32)
        diff = v_hi - v_lo
        q = v_lo + w * diff if w < f32(0.5) else v_hi - diff * (f32(1.0) - w)
    return f32(q + f32(0.5) * f32(sigma) * f32(sigma))


def point_status(energy, ok, candidate, thresh, pos, idepth, lm_mask, old_baseline,
                 old_outlier, old_opt_count, min_valid: int) -> tuple:
    """The status kernel on [K, K, N] groups and [K, N] landmarks (numpy,
    f32), ``pos`` the frames' positions [K, 3] → (statuses, baselines,
    inlier counts, outlier flags, optimization counts)."""
    f32 = np.float32
    energy = np.asarray(energy, f32)
    k, _, n = energy.shape
    thr = f32(thresh)
    status = np.where(ok & (energy > thr), RES_OUTLIER, candidate).astype(np.int32)
    inlier = ok & (energy <= thr)
    pos = np.asarray(pos, f32)
    d = pos[:, None, :] - pos[None, :, :]
    dist = np.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])
    # each warp leaves its targets' values in shared memory ...
    rel = np.asarray(idepth, f32)[:, None, :] * dist.astype(f32)[:, :, None]
    # ... and warp 0 walks them in target order
    rel_max = np.zeros((k, n), f32)
    for j in range(k):
        rel_max = np.where(inlier[:, j, :], np.fmax(rel_max, rel[:, j, :]), rel_max)
    count = inlier.sum(axis=1).astype(np.int32)
    baseline = np.fmax(np.asarray(old_baseline, f32), rel_max)
    outlier = old_outlier | (lm_mask & (count < min_valid))
    opt = (np.asarray(old_opt_count) + (count > 0)).astype(np.int32)
    return status, baseline, count, outlier, opt
