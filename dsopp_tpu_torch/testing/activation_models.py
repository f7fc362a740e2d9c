"""Host models of K13's walk and K14's compaction, and of ``ba_body.cuh``'s
pose path, for the CPU tests (``tests/test_torch_activation_models.py``).

* :func:`walk` — ``csrc/activation.cu``: the active projections staged in
  bands of image rows, each walker testing the bands its row reaches and
  stopping at the first projection within ``min_distance``, decided as
  ``d2 <= within_threshold(min_distance)`` in f32;
* :func:`compaction` — ``csrc/refine.cu::compact_kernel``'s ordering: a
  block per bank from the count of the later banks, 32 consecutive entries a
  warp step, the warps' counts scanned, the places by ballot;
* :func:`target_sums` — ``refine_kernel``'s f64 sums over the targets in a
  warp's fixed order;
* :func:`tiled_pairing` — ``csrc/refine.cu::pair_slots_kernel``'s partition:
  a block per (tile of landmark slots, frame slot), each recounting its
  slot's free slots and candidates over contiguous runs a thread and writing
  its tile of the window's outputs and of the bank's;
* :func:`frame_poses`, :func:`relative_poses` — ``frame_pose`` /
  ``relative_pose`` in torch f32, operation by operation in the kernels'
  order (the plain versions' ``SE3`` sums its components with ``torch.sum``).
"""

from __future__ import annotations

import numpy as np
import torch

BANDS = 1024                   # csrc/activation.cu::kBands
CHUNK = 8192                   # csrc/activation.cu::kChunk
REACH_PX = np.float32(1e-3)    # csrc/activation.cu::kReachPx
COMPACT_THREADS = 256          # csrc/refine.cu: compact_kernel's threads (ba_body.cuh::kThreads)
PAIR_TILE = 64                 # csrc/refine.cu::kPairTile

_F32 = np.float32


def within_threshold(min_distance) -> np.float32:
    """The largest f32 T with sqrtf(T) <= min_distance (-1 for a negative or
    NaN one): a squared distance d2 >= 0 lies within min_distance exactly when
    d2 <= T (``within_threshold`` of the kernel)."""
    md = _F32(min_distance)
    if not md >= 0:
        return _F32(-1.0)
    if np.isinf(md):
        return _F32(np.inf)
    with np.errstate(over="ignore", under="ignore"):
        t = md * md
        for _ in range(4):
            if not np.sqrt(t) > md:
                break
            t = np.nextafter(t, _F32(0.0))
        for _ in range(4):
            up = np.nextafter(t, _F32(np.inf))
            if not np.sqrt(up) <= md:
                break
            t = up
    return t


def band_of(v, scale):
    """Band of the image row coordinate ``v`` (f32 array)."""
    return np.minimum(np.maximum(v * scale, _F32(0.0)), _F32(BANDS - 1)).astype(np.int64)


def walk(cand_uv, walkers, act_uv, min_distance, height, chunk=CHUNK, rng=None):
    """K13's decision for the walkers → (spaced [M] bool, False off the
    walkers; n_active; pairs tested).

    ``cand_uv`` [M, 2] and ``act_uv`` [L, 2] are f32; a row is staged when
    it is finite (a valid reprojection is; the landmark kernel writes (+inf,
    +inf) for every other slot, so the kernel's test of u alone is the same).
    ``rng`` shuffles each band's entries, as the kernel's shared atomics
    may."""
    cand_uv = np.asarray(cand_uv, _F32)
    act_uv = np.asarray(act_uv, _F32)
    walkers = np.asarray(walkers, bool)
    md = _F32(min_distance)
    threshold = within_threshold(md)
    scale = _F32(BANDS) / _F32(height)
    with np.errstate(over="ignore", invalid="ignore"):
        reach = md * _F32(1.0 + 1e-5) + REACH_PX
        lo = band_of(cand_uv[:, 1] - reach, scale)
        hi = band_of(cand_uv[:, 1] + reach, scale)
    found = np.zeros(len(cand_uv), bool)
    active = tested = 0
    for base in range(0, len(act_uv), chunk):
        part = act_uv[base:base + chunk]
        part = part[np.isfinite(part).all(axis=1)]
        active += len(part)
        bands = band_of(part[:, 1], scale)
        order = np.argsort(bands, kind="stable")
        if rng is not None:
            order = order[np.lexsort((rng.random(len(order)), bands[order]))]
        staged = part[order]
        start = np.searchsorted(bands[order], np.arange(BANDS + 1))
        if not md == md:
            continue
        for c in np.flatnonzero(walkers & ~found):
            seg = staged[start[lo[c]]:start[hi[c] + 1]]
            dx = cand_uv[c, 0] - seg[:, 0]
            dy = cand_uv[c, 1] - seg[:, 1]
            close = np.flatnonzero(dx * dx + dy * dy <= threshold)
            if len(close):
                found[c] = True
                tested += min(len(seg), 2 * (int(close[0]) // 2) + 2)
            else:
                tested += len(seg)
    spaced = walkers & ((active == 0) | ((md == md) & ~found))
    return spaced, active, tested


def compaction(activate, cap, threads=COMPACT_THREADS):
    """``compact_kernel``'s ordering → (order [cap], -1 past the refined ones;
    their count; selected [K, M]).  A block per bank starts at the count of
    the activating candidates of the banks after it; its warp w takes the
    bank's entries [w * span, (w + 1) * span), 32 consecutive ones a step;
    the warps' counts are scanned, a warp's places follow by ballot."""
    activate = np.asarray(activate, bool)
    k, m = activate.shape
    steps = -(-m // threads)
    span = 32 * steps
    order = np.full(cap, -1)
    selected = np.zeros((k, m), bool)
    for bank in range(k):
        later = int(activate[bank + 1:].sum())
        counts = [int(activate[bank, w * span:(w + 1) * span].sum())
                  for w in range(threads // 32)]
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for w in range(threads // 32):
            pos = later + int(first[w])
            for step in range(steps):
                i = w * span + 32 * step + np.arange(32)
                bits = np.zeros(32, bool)
                bits[i < m] = activate[bank, i[i < m]]
                at = pos + np.cumsum(bits) - bits
                for lane in np.flatnonzero(bits & (at < cap)):
                    order[at[lane]] = bank * m + i[lane]
                    selected[bank, i[lane]] = True
                pos += int(bits.sum())
    return order, min(cap, int(activate.sum())), selected


def target_sums(values):
    """``refine_kernel``'s f64 sum of a candidate's per-target values [K]
    (f32): lane l adds targets l and l + 32, then a butterfly over the 32
    lanes; cast to f32."""
    v = np.asarray(values, _F32).astype(np.float64)
    lanes = np.zeros(32)
    for t in range(len(v)):
        lanes[t % 32] += v[t]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    return _F32(lanes[0])


# -- ba_body.cuh's pose path, component by component -----------------------

def tiled_pairing(lm_valid, activate, threads=COMPACT_THREADS, tile=PAIR_TILE):
    """``pair_slots_kernel`` over its grid → (src [K, N]: the bank entry a
    landmark slot takes, -1 where it keeps its own values; taken [K, M]; the
    number of writes of each landmark slot's values [K, N] and of each bank
    entry's [K, M], every block's tile counted)."""
    k, n = lm_valid.shape
    m = activate.shape[1]
    tiles = -(-n // tile)
    src = np.full((k, n), -1)
    taken = np.zeros((k, m), bool)
    writes_n = np.zeros((k, n), int)
    writes_m = np.zeros((k, m), int)
    run_n, run_m = -(-n // threads), -(-m // threads)
    for a in range(k):
        for t in range(tiles):
            # the counts of each thread's contiguous run, one exclusive scan
            free = [int((~lm_valid[a, min(i * run_n, n):min(i * run_n + run_n, n)]).sum())
                    for i in range(threads)]
            act = [int(activate[a, min(i * run_m, m):min(i * run_m + run_m, m)].sum())
                   for i in range(threads)]
            packed = np.array([(f << 16) | c for f, c in zip(free, act)])
            pre = np.concatenate([[0], np.cumsum(packed)[:-1]])
            total = int(packed.sum())
            free_rank = np.full(n, -1)
            act_list = np.zeros(m, int)
            for i in range(threads):
                rank = int(pre[i]) >> 16
                for j in range(min(i * run_n, n), min(i * run_n + run_n, n)):
                    if not lm_valid[a, j]:
                        free_rank[j] = rank
                        rank += 1
                rank = int(pre[i]) & 0xFFFF
                for j in range(min(i * run_m, m), min(i * run_m + run_m, m)):
                    if activate[a, j]:
                        act_list[rank] = j
                        rank += 1
            take = min(total >> 16, total & 0xFFFF)
            span = -(-n // tiles)
            for i in range(t * span, min(t * span + span, n)):
                r = free_rank[i]
                src[a, i] = act_list[r] if 0 <= r < take else -1
                writes_n[a, i] += 1
            span_m = -(-m // tiles)
            last = act_list[take - 1] if take > 0 else -1
            for s in range(t * span_m, min(t * span_m + span_m, m)):
                taken[a, s] = bool(activate[a, s]) and s <= last
                writes_m[a, s] += 1
    return src, taken, writes_n, writes_m


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _rotate(q, v):
    u = q[1:]
    uv = _cross(u, v)
    uuv = _cross(u, uv)
    return tuple(v[c] + 2.0 * (q[0] * uv[c] + uuv[c]) for c in range(3))


def _normalize(q):
    w, x, y, z = q
    n = torch.sqrt(torch.clamp(((w * w + x * x) + y * y) + z * z, min=1e-30))
    return (w / n, x / n, y / n, z / n)


def _multiply(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw)


def _compose(a, b):
    rt = _rotate(a[0], b[1])
    return _normalize(_multiply(a[0], b[0])), tuple(rt[c] + a[1][c] for c in range(3))


def _inverse(a):
    qi = (a[0][0], -a[0][1], -a[0][2], -a[0][3])
    rt = _rotate(qi, a[1])
    return qi, tuple(-x for x in rt)


def _exp(xi):
    ups, om = xi[:3], xi[3:]
    theta_sq = (om[0] * om[0] + om[1] * om[1]) + om[2] * om[2]
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-30))
    half = 0.5 * theta
    small = theta_sq < 1e-6
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=1e-30))
    sixth = torch.tensor(1.0 / 6.0, dtype=theta.dtype)
    b = torch.where(small, sixth - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta_sq * theta, min=1e-30))
    c1 = _cross(om, ups)
    c2 = _cross(om, c1)
    return (_normalize((w, k * om[0], k * om[1], k * om[2])),
            tuple(ups[c] + a * c1[c] + b * c2[c] for c in range(3)))


def frame_poses(t_lin_q, t_lin_t, eps):
    """``frame_pose`` of every frame → (q [K, 4], t [K, 3]) as component tuples."""
    lin = (tuple(t_lin_q.unbind(-1)), tuple(t_lin_t.unbind(-1)))
    return _compose(lin, _exp(tuple(eps[:, :6].unbind(-1))))


def relative_poses(t_lin_q, t_lin_t, eps, target):
    """``relative_pose(i, target)`` for every frame i: T_target^-1 T_i →
    (q [K, 4], t [K, 3])."""
    q, t = frame_poses(t_lin_q, t_lin_t, eps)
    k = t_lin_q.shape[0]
    pick = lambda comps: tuple(c[target].expand(k) for c in comps)  # noqa: E731
    rel = _compose(_inverse((pick(q), pick(t))), (q, t))
    return torch.stack(rel[0], dim=-1), torch.stack(rel[1], dim=-1)
