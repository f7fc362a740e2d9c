"""A plain PyTorch mirror of kernel K8 (``csrc/ba_linearize.cu``): its FEJ
arithmetic and its order of summation, for tests only: no path of the port
calls it.

K8 forms each residual's first-estimate Jacobians from the window at its
linearization point (``ba_body.cuh::fej_point``, once kernel K6's cache:
:func:`fej_cache` repeats it operation by operation, with the pair's pose from
``testing/activation_models.py``'s mirror of ``relative_pose``), then its
Jacobian row, ``r`` and ``w J`` in the operands' type (f32 on the card, ``w
J`` rounded there as the plain version rounds it) and takes every long sum in
float64 on the tensor cores.  The mirror takes the same operands, widens them
to float64 where the kernel converts them, and adds the exact products in the
kernel's order:

1. the pair blocks ``w J^T [J | r]``: per (pair, tile of ``TILE_LM``
   landmarks), warp ``w`` of ``WARPS`` sums residuals ``32 w .. 32 w + 31`` of
   each chunk of ``CHUNK_LM`` landmarks, chunk after chunk, sixteen residuals
   a product (modelled as additions in residual order: the tensor core's
   rounding inside one product is not modelled); then the warps' partials in
   warp order;
2. per (pair, landmark) the 8-point sums that feed hpd, in the operands'
   type, point by point; the anchor term, h_dd and b_d over the targets in
   frame order (float64);
3. the Schur sums per anchor frame, landmark by landmark (sixteen a product),
   of ``(hpd_l inv_l)`` (rounded in the operands' type) times
   ``[hpd_l | b_d_l]``;
4. each output entry from ``LANES`` slice sums (slice ``q``: the anchor
   frames ``q, q + 8, ...`` of the Schur partials; of the pair partials the
   frames ``q, q + 8, ...`` of a diagonal block's pairs, each over the tiles,
   then the tiles ``q, q + 8, ...`` of the block's own two pairs), then the
   tree ``((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7))``; rounded to the
   operands' type, the diagonal priors added.

At C channels a landmark has C·8 rows, channel-major, sharing each point's
FEJ geometry: a chunk is staged C times, channel by channel (each stage the
same 256 rows of 32 landmarks), and the per-landmark sums run over the C·8
rows in that order.

With float64 operands the mirror differs from ``_linearize_from_ev_plain``
only in the order of its float64 sums and of the FEJ's products.  The mirrors
work on dense tensors with vectorised entries: no ``matmul`` or ``einsum``,
whose summation order is the library's.
"""

from __future__ import annotations

import torch

from dsopp_tpu_torch.core.pattern import shift_pattern
from dsopp_tpu_torch.solvers.pba import (BLOCK, Evaluation, FEJCache, LinearSystem, PBAOptions,
                                         Window, _patch_ref, _prior_system)
from dsopp_tpu_torch.testing.activation_models import _cross, _rotate, relative_poses

TILE_LM = 128     # landmarks per pair block (kTileLm)
CHUNK_LM = 32     # landmarks per stage (kChunkLm): 256 residuals, a thread each
WARPS = 8         # warps per pair block; warp w takes 32 residuals of a stage
LANES = 8         # slices per output entry in the reduction (kReduceLanes)
PATTERN = 8


def fej_cache(window: Window, model) -> FEJCache:
    """``ba_body.cuh::fej_point`` for every (anchor i, target j, landmark,
    pattern point), operation by operation in the kernel's order, in the
    window's type; the pair's pose ``relative_pose(i, j)`` at the
    linearization point and its brightness scale as the pair kernel's thread
    0 forms them."""
    k, n = window.num_slots, window.num_landmark_slots
    zero = torch.zeros((k, 8), dtype=window.t_lin_q.dtype, device=window.t_lin_q.device)
    rel = [relative_poses(window.t_lin_q, window.t_lin_t, zero, j) for j in range(k)]
    rq = torch.stack([q for q, _ in rel], dim=1)               # [i, j, 4]: T_j^-1 T_i
    rt = torch.stack([t for _, t in rel], dim=1)               # [i, j, 3]
    bc = (slice(None), slice(None), None, None)                # [i, j] -> [i, j, n, p]
    q_rel = tuple(rq[..., c][bc] for c in range(4))
    t_rel = tuple(rt[..., c][bc] for c in range(3))
    uv = shift_pattern(window.lm_uv)[:, None]                  # [i, 1, n, p, 2]
    d = window.lm_idepth[:, None, :, None]
    ray = ((uv[..., 0] - model.cx) / model.fx, (uv[..., 1] - model.cy) / model.fy,
           torch.ones_like(uv[..., 0]))
    rot = _rotate(q_rel, ray)
    q = tuple(rot[c] + d * t_rel[c] for c in range(3))
    z_safe = torch.where(q[2].abs() < 1e-12, torch.full_like(q[2], 1e-12), q[2])
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u_t = model.fx * q[0] * iz + model.cx
    v_t = model.fy * q[1] * iz + model.cy
    z = q[2]
    proj = ((z >= 1e-3) & (u_t >= 4.0) & (v_t >= 4.0) & (u_t <= model.width - 4.0 - 1.0)
            & (v_t <= model.height - 4.0 - 1.0))
    valid = (proj & (z >= 1e-3 * torch.clamp(d, min=0.0) + 1e-12) & (d > -1e-4) & (d < 1010.0))

    zeros = torch.zeros_like(iz)
    j0 = (model.fx * iz, zeros, -model.fx * q[0] * iz2)
    j1 = (zeros, model.fy * iz, -model.fy * q[1] * iz2)
    qw, qx, qy, qz = q_rel
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    r0 = (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy))
    r1 = (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx))
    r2 = (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))
    a0 = tuple(j0[0] * r0[c] + j0[2] * r2[c] for c in range(3))
    a1 = tuple(j1[1] * r1[c] + j1[2] * r2[c] for c in range(3))
    ar0, ar1 = _cross(a0, ray), _cross(a1, ray)
    jq0, jq1 = _cross(j0, q), _cross(j1, q)
    ref = torch.stack([torch.stack([d * a[0], d * a[1], d * a[2], -ar[0], -ar[1], -ar[2]], -1)
                       for a, ar in ((a0, ar0), (a1, ar1))], dim=-2)
    tgt = torch.stack([torch.stack([-d * jr[0], -d * jr[1], -d * jr[2], jq[0], jq[1], jq[2]], -1)
                       for jr, jq in ((j0, jq0), (j1, jq1))], dim=-2)
    d_idepth = torch.stack([(jr[0] * t_rel[0] + jr[1] * t_rel[1]) + jr[2] * t_rel[2]
                            for jr in (j0, j1)], dim=-1)
    e, a = window.exposure, window.affine0
    ratio = e[None, :] / torch.clamp(e[:, None], min=1e-12)
    scale0 = ratio * torch.exp(a[None, :, 0] - a[:, None, 0])
    corrected = (scale0[bc][:, :, :, None]
                 * (_patch_ref(window)[:, None] - a[:, 1][:, None, None, None, None]))
    return FEJCache(ref, tgt, d_idepth, corrected, scale0, torch.all(valid, dim=-1))


def _rows(fej: FEJCache, ev: Evaluation):
    """→ (w, J [K,K,N,C·P,16], r, j_d [K,K,N,C·P]) in the operands' type, as
    pair_kernel forms them, rows channel-major."""
    k, n, c = ev.residuals.shape[0], ev.residuals.shape[2], ev.residuals.shape[3]
    w = torch.where(ev.ok & fej.geom_valid, ev.weight, torch.zeros_like(ev.weight))
    gx, gy = ev.gx[..., None], ev.gy[..., None]                     # [K,K,N,C,P,1]
    d_ref, d_tgt = fej.d_uv_ref[:, :, :, None], fej.d_uv_tgt[:, :, :, None]
    j_ref = gx * d_ref[..., 0, :] + gy * d_ref[..., 1, :]
    j_tgt = gx * d_tgt[..., 0, :] + gy * d_tgt[..., 1, :]
    corr = fej.corrected_ref[..., None]
    s0 = fej.scale0[:, :, None, None, None, None].expand_as(corr)
    j = torch.cat([j_ref, corr, s0, j_tgt, -corr, -torch.ones_like(corr)], dim=-1)
    j_d = (ev.gx * fej.d_uv_idepth[:, :, :, None, :, 0]
           + ev.gy * fej.d_uv_idepth[:, :, :, None, :, 1])
    cp = c * PATTERN
    return (w, j.reshape(k, k, n, cp, 16), ev.residuals.reshape(k, k, n, cp),
            j_d.reshape(k, k, n, cp))


def _in_order(terms):
    """Left-to-right sum of the tensors ``terms``, from 0."""
    total = None
    for t in terms:
        total = t.clone() if total is None else total + t
    return total


def _tree(lanes):
    """reduce_kernel's tree over the ``LANES`` slice sums."""
    s = list(lanes)
    s = [s[q] + s[q + 4] for q in range(4)]
    s = [s[q] + s[q + 2] for q in range(2)]
    return s[0] + s[1]


def pair_sums(w, j, r):
    """[K*K, tiles, 16, 17] float64: each (pair, tile)'s sum of
    ``(w J)^T [J | r]`` in pair_kernel's order."""
    k, n, cp = w.shape[0], w.shape[2], j.shape[3]
    c = cp // PATTERN
    tiles = -(-n // TILE_LM)
    chunks = TILE_LM // CHUNK_LM
    wj = (w[..., None, None] * j).double()
    jr = torch.cat([j, r[..., None]], dim=-1).double()
    pad = tiles * TILE_LM - n

    def staged(x):       # → [K*K, tiles, chunks, C, WARPS, 32, cols]: a stage a channel
        x = torch.nn.functional.pad(x.reshape(k * k, n, cp, -1), (0, 0, 0, 0, 0, pad))
        x = x.reshape(k * k, tiles, chunks, CHUNK_LM, c, PATTERN, x.shape[-1])
        return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(k * k, tiles, chunks, c, WARPS, 32,
                                                      x.shape[-1])

    wj, jr = staged(wj), staged(jr)
    acc = torch.zeros((k * k, tiles, WARPS, 16, 17), dtype=torch.float64)
    for chunk in range(chunks):
        for ch in range(c):
            for t in range(32):      # the warp's residuals in order, sixteen a product
                a, b = wj[:, :, chunk, ch, :, t], jr[:, :, chunk, ch, :, t]
                acc = acc + a[..., :, None] * b[..., None, :]
    return _in_order(acc[:, :, w_] for w_ in range(WARPS))


def linearize(window: Window, model, ev: Evaluation, eps, opts: PBAOptions,
              marg_pass: bool = False) -> LinearSystem:
    """K8's outputs, its FEJ formed from the window (:func:`fej_cache`), in
    its order of summation, in the operands' type."""
    return linearize_from_fej(window, fej_cache(window, model), ev, eps, opts, marg_pass)


def linearize_from_fej(window: Window, fej: FEJCache, ev: Evaluation, eps, opts: PBAOptions,
                       marg_pass: bool = False) -> LinearSystem:
    """K8's outputs in its order of summation on the FEJ ``fej``, in the
    operands' type."""
    k, n = window.num_slots, window.num_landmark_slots
    kb = k * BLOCK
    op = ev.residuals.dtype
    w, j, r, j_d = _rows(fej, ev)
    tiles = -(-n // TILE_LM)
    pp = pair_sums(w, j, r).reshape(k, k, tiles, 16, 17)

    # per (pair, landmark): the sums over its C·8 rows, row by row
    wj = w[..., None, None] * j
    rows_lm = range(j.shape[3])
    h_ref = _in_order(wj[:, :, :, p, :8] * j_d[:, :, :, p, None] for p in rows_lm)
    h_tgt = _in_order(wj[:, :, :, p, 8:] * j_d[:, :, :, p, None] for p in rows_lm)
    hdd_t = _in_order((j_d[..., p] * j_d[..., p]) * w for p in rows_lm)
    bd_t = _in_order((j_d[..., p] * r[..., p]) * w for p in rows_lm)
    hpd = h_tgt.permute(0, 2, 1, 3).contiguous()                  # [i, l, j, a]
    anchor = _in_order(h_ref[:, f].double() for f in range(k))    # [i, l, a]
    eye = torch.arange(k)
    hpd[eye, :, eye] = hpd[eye, :, eye] + anchor.to(op)
    h_dd = _in_order(hdd_t[:, f].double() for f in range(k)).to(op)
    b_d = _in_order(bd_t[:, f].double() for f in range(k)).to(op)
    thr = opts.idepth_nullspace_threshold
    if marg_pass:
        h_dd = torch.where(window.frame_fixed[:, None] & (h_dd > thr),
                           h_dd + opts.scale_nullspace_reg, h_dd)
    inv_hdd = torch.where(h_dd > thr, 1.0 / h_dd, torch.zeros_like(h_dd))

    # the Schur partial of each anchor frame, landmark by landmark
    rows = hpd.reshape(k, n, kb)
    a_op = (rows * inv_hdd[..., None]).double()
    b_op = torch.cat([rows, b_d[..., None]], dim=-1).double()
    part = _in_order(a_op[:, l, :, None] * b_op[:, l, None, :] for l in range(n))

    def lane_sums(fn):
        return [fn(q) for q in range(LANES)]

    def schur_lane(q):
        terms = [part[f] for f in range(q, k, LANES)]
        return _in_order(terms) if terms else torch.zeros_like(part[0])

    schur = _tree(lane_sums(schur_lane))

    def h_lane(q):
        # a diagonal block's pairs (bi, f) and (f, bi) for f = q, q + 8, ...,
        # each over the tiles, then the tiles q, q + 8, ... of (bi, bj), (bj, bi)
        diag = torch.zeros((k, 8, 8), dtype=torch.float64)
        bvec = torch.zeros((k, 8), dtype=torch.float64)
        for f in range(q, k, LANES):
            for t in range(tiles):
                diag = diag + pp[:, f, t, :8, :8]
                diag = diag + pp[f, :, t, 8:, 8:16]
                bvec = bvec + pp[:, f, t, :8, 16]
                bvec = bvec + pp[f, :, t, 8:, 16]
        h = torch.zeros((k, 8, k, 8), dtype=torch.float64)
        h[eye, :, eye, :] = diag
        for t in range(q, tiles, LANES):
            h = h + pp[:, :, t, :8, 8:16].permute(0, 2, 1, 3)        # h_rt[bi, bj][a, b]
            h = h + pp[:, :, t, :8, 8:16].permute(1, 3, 0, 2)        # h_rt[bj, bi][b, a]
        return h, bvec

    lanes = lane_sums(h_lane)
    h = _tree(lane[0] for lane in lanes).reshape(kb, kb)
    b = _tree(lane[1] for lane in lanes).reshape(kb)
    h_pr, b_pr = _prior_system(window, eps, opts, marg_pass=marg_pass)
    return LinearSystem(h.to(op) + h_pr, b.to(op) + b_pr, schur[:, :kb].to(op),
                        schur[:, kb].to(op), hpd, inv_hdd, b_d)
