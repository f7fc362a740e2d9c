"""Regular-frame tick (counterpart of ``dsopp_tpu/tracker/fused_tick.py``
and of ``tracker/monocular.py::_initialization_hypotheses``).

Pyramid (K1) → coarse-to-fine alignment of a chunk of 5 pose hypotheses
(on the card one K3 launch per level for all hypotheses of the call, 5 or
105; level 0 only for each chunk's coarse winner, or for every hypothesis
when there is no coarser level) → epipolar depth update
of every window bank (K4) → flow statistic, reliability gate and keyframe
decision (K5, packed into one buffer for the caller's one host copy).  When
the first chunk fails the 2.5× reliability gate, the 104 rotation-perturbed
hypotheses run too (chunks 1..21, batched into one align chain); the best
per-point energy over all chunks wins, the earliest chunk on ties.

Every function takes one sequence's tensors or B sequences' (a leading
``[B]`` axis: the batched tick of ``tracker/batched_loop.py``).  B
sequences make the same launches as one: K1 over the B frames, one K3 launch
per level for every sequence's hypotheses (each carries its sequence's
index), one K4 and one K5 call; the chunk-0 gate's flags are read once for
all B, and the re-track's chunks run in one chain for the sequences that
escalated only.  No step loops over the sequences.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features.pyramid import build_pyramid_maps
from dsopp_tpu_torch.solvers.pose_alignment import AlignmentOptions, align_level
from dsopp_tpu_torch.tracker.depth_estimation import ImmaturePoints, estimate_depths
from dsopp_tpu_torch.tracker.depth_map import (ENERGY_RATIO_THRESHOLD, STAT_FLOW,
                                               STAT_FLOW_NO_ROT, frame_statistics)

CHUNK = 5


class FusedTickResult(NamedTuple):
    maps: tuple
    pose_q: torch.Tensor
    pose_t: torch.Tensor
    affine: torch.Tensor
    rmse: torch.Tensor
    num_valid: torch.Tensor
    flow: torch.Tensor
    flow_no_rot: torch.Tensor
    immature: ImmaturePoints
    t_kf_frame_mat: torch.Tensor
    escalated: object           # bool, or a tuple of B bools
    rmse_chunk0: torch.Tensor   # the rmse the re-track gate tested (chunk 0's)
    stats: torch.Tensor         # [STATS] / [B, STATS] K5's packed statistics (STAT_*)
    host_stats: object = None   # ``stats`` on the host (numpy), set by the caller that
    #                             reads it (device_loop._frontend_core)


def _initialization_hypotheses(t_w_last: SE3, t_prev_rel: SE3, t_w_kf: SE3,
                               with_perturbations: bool) -> SE3:
    """Batched initial poses T_w_t [..., 5 or 109]: const motion, double,
    half, zero, zero from the keyframe, then (optionally) 104 rotation
    perturbations of the const-motion pose; ``...``: the poses' leading
    axes (none, or B sequences)."""
    cands = [
        t_w_last @ t_prev_rel,
        t_w_last @ t_prev_rel @ t_prev_rel,
        t_w_last @ SE3.exp(0.5 * t_prev_rel.log()),
        t_w_last,
        t_w_kf,
    ]
    q = torch.stack([c.q for c in cands], dim=-2)
    t = torch.stack([c.t for c in cands], dim=-2)
    if with_perturbations:
        xi = _perturbations(q.dtype, q.device)
        n = xi.shape[0]
        base = cands[0]
        lead = tuple(base.q.shape[:-1])
        pert = SE3(base.q[..., None, :].expand(lead + (n, 4)),
                   base.t[..., None, :].expand(lead + (n, 3))) @ SE3.exp(xi)
        q = torch.cat([q, pert.q], dim=-2)
        t = torch.cat([t, pert.t], dim=-2)
    return SE3(q, t)


@functools.lru_cache(maxsize=None)
def _perturbations(dtype, device):
    """[104, 6] rotation perturbations of ±1..2.5° (a constant per dtype and
    device, built once: a host → device copy waits for the device)."""
    deg = math.pi / 180.0
    xis = []
    for delta in (1.0 * deg, 1.5 * deg, 2.0 * deg, 2.5 * deg):
        for dx in (0.0, delta, -delta):
            for dy in (0.0, delta, -delta):
                for dz in (0.0, delta, -delta):
                    if dx == dy == dz == 0.0:
                        continue
                    xis.append([0.0, 0.0, 0.0, dx, dy, dz])
    return torch.tensor(xis, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _sequence_index(rows: tuple, repeat: int, device, dtype=torch.int32):
    """[len(rows) · repeat] the sequence of each of ``repeat`` consecutive
    entries per row (K3's per-hypothesis sequence index, or the rows
    themselves as an index), built once per (rows, repeat, device)."""
    return torch.tensor([r for r in rows for _ in range(repeat)], dtype=dtype, device=device)


def _chunk_winners(result, c: int):
    """Index of each chunk's winner among ``result``'s [C·CHUNK] hypotheses:
    the least energy per valid point among those keeping at least half the
    chunk's most valid points (at least 1)."""
    nv = result.num_valid.reshape(c, CHUNK)
    energy = result.energy.reshape(c, CHUNK)
    nv_floor = torch.clamp(torch.max(nv, dim=1).values // 2, min=1)
    score = torch.where(nv >= nv_floor[:, None], energy / torch.clamp(nv, min=1),
                        torch.full_like(energy, float("inf")))
    return torch.arange(c, device=nv.device) * CHUNK + torch.argmin(score, dim=1)


def _run_chunks(hyp_q, hyp_t, kf: SE3, maps, level_points, models, last_affine,
                exp_ratio, opts: AlignmentOptions, num_levels: int, rows: tuple = None):
    """Chunks [C, CHUNK] of T_w_t hypotheses through the coarse-to-fine
    schedule → per chunk (q, t, affine, rmse, num_valid, score).  Level 0
    refines each chunk's coarse winner; with one level there is no coarse
    ranking, and level 0 refines every hypothesis and picks the winner.

    ``rows``: the sequences (host ints) of B-sequence inputs whose chunks
    these are: ``hyp_q`` [E, C, CHUNK, 4] for E = len(rows), ``kf`` [E], the
    maps, level points, ``last_affine`` and ``exp_ratio`` of all B; the
    results are [E·C], sequence-major.  One K3 launch a level serves every
    row, each hypothesis with its sequence's index."""
    c = hyp_q.shape[-3]
    hyps = SE3(hyp_q.reshape(-1, 4), hyp_t.reshape(-1, 3))
    nb = hyps.q.shape[0]
    if rows is None:
        kf_q, kf_t = kf.q.expand(nb, 4), kf.t.expand(nb, 3)
        affine = last_affine.expand(nb, 2).contiguous()
        seq_args = seq0_args = {}
    else:
        per = nb // len(rows)
        # each hypothesis's row of ``kf`` by a gather: a reshape of the
        # expanded rows would be a view at one row and a copy at several
        local = _sequence_index(tuple(range(len(rows))), per, hyps.q.device, torch.long)
        kf_q, kf_t = kf.q.index_select(0, local), kf.t.index_select(0, local)
        seq = _sequence_index(rows, per, hyps.q.device)
        affine = last_affine.index_select(0, seq)
        # the cluster size follows a sequence's hypotheses: per, then c winners
        seq_args = dict(seq=seq, per_seq=per)
        seq0_args = dict(seq=_sequence_index(rows, c, hyps.q.device), per_seq=c)
    t = hyps.inverse().compose(SE3(kf_q, kf_t))
    result = None
    for level in range(num_levels - 1, 0, -1):
        result = align_level(level_points[level], maps[level], models[level], t,
                             affine, last_affine, exp_ratio, opts, **seq_args)
        t, affine = result.t_t_r, result.affine
    chunks = nb // CHUNK
    if result is not None:
        pick = _chunk_winners(result, chunks)
        res0 = align_level(level_points[0], maps[0], models[0],
                           SE3(t.q[pick], t.t[pick]), affine[pick], last_affine,
                           exp_ratio, opts, **seq0_args)
    else:
        res = align_level(level_points[0], maps[0], models[0], t, affine, last_affine,
                          exp_ratio, opts, **seq_args)
        pick = _chunk_winners(res, chunks)
        res0 = res._replace(t_t_r=SE3(res.t_t_r.q[pick], res.t_t_r.t[pick]),
                            **{name: getattr(res, name)[pick] for name in
                               ("affine", "energy", "num_valid", "rmse", "iterations")})
    score0 = torch.where(res0.num_valid > 0,
                         res0.energy / torch.clamp(res0.num_valid, min=1),
                         torch.full_like(res0.energy, float("inf")))
    return (res0.t_t_r.q, res0.t_t_r.t, res0.affine, res0.rmse,
            res0.num_valid, score0)


def _at_slot(x, slot):
    """``x`` [K, ...] at ``slot`` [1] → [...], or of B sequences, [B, K, ...]
    at [B, 1] → [B, ...]: a gather over an expanded index, the same kernels at
    every B (``take_along_dim`` ran 8 more kernels a tick at B = 4 than at
    B = 1 on the card)."""
    if slot.dim() == 1:
        return x.index_select(0, slot)[0]
    idx = slot.reshape(slot.shape + (1,) * (x.dim() - 2)).expand(slot.shape + x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


def _retrack_winners(out0, rest, esc):
    """Chunk 0's results [B] (``out0``) and the escalated sequences' chunks
    1..21 ([E·21], ``rest``; ``esc`` their [E] rows on the device) → each
    sequence's winner: chunk 0 where it did not escalate, else the least
    score over its 22 chunks, the earliest on ties."""
    e = esc.shape[0]
    cand = [torch.cat([a.index_select(0, esc)[:, None], b.reshape((e, -1) + b.shape[1:])],
                      dim=1) for a, b in zip(out0, rest)]
    best = torch.argmin(cand[5], dim=1)
    rows = torch.arange(e, device=esc.device)
    return tuple(a.index_copy(0, esc, x[rows, best]) for a, x in zip(out0[:5], cand[:5]))


def fused_regular_tick(image, level_points, flow_points, window_poses_q,
                       window_poses_t, window_affines, window_exposures,
                       exposure, kf_slot, immature: ImmaturePoints, last_q, last_t,
                       prev_q, prev_t, last_affine, models,
                       align_opts: AlignmentOptions, with_perturbations: bool,
                       num_levels: int, huber_sigma: float,
                       rmse_last0, kf_rmse, keyframe_factor: float,
                       force_kf) -> FusedTickResult:
    """One tracked frame's frontend.  ``kf_slot``: [1] long tensor of the
    newest keyframe slot.  ``rmse_last0``, ``kf_rmse``: the state's gate and
    strategy memories, which the statistics' gate and decision read
    (``keyframe_factor``, ``force_kf``: the strategy's factor and a forced
    keyframe).  Reads one flag on the host when perturbations are armed
    (whether chunk 0 failed the gate).

    B sequences' frames (``image`` [B, H, W], a leading [B] axis on every
    state tensor, ``kf_slot`` [B, 1], ``force_kf`` B flags) run as one tick:
    the gate's B flags are one host read, and ``escalated`` is B flags."""
    batched = image.dim() == 3
    maps = build_pyramid_maps(image, num_levels)
    kf = SE3(_at_slot(window_poses_q, kf_slot), _at_slot(window_poses_t, kf_slot))
    exp_ratio_kf = exposure / torch.clamp(_at_slot(window_exposures, kf_slot), min=1e-12)
    hyps = _initialization_hypotheses(SE3(last_q, last_t), SE3(prev_q, prev_t), kf,
                                      with_perturbations)
    rows = tuple(range(image.shape[0])) if batched else None
    run = lambda q, t, pose=kf, rows=rows: _run_chunks(  # noqa: E731
        q, t, pose, maps, level_points, models, last_affine, exp_ratio_kf, align_opts,
        num_levels, rows)
    if not with_perturbations:
        out = run(hyps.q[..., None, :, :], hyps.t[..., None, :, :])
        if batched:
            bq, bt, b_aff, b_rmse, b_valid = out[:5]
            escalated = (False,) * len(rows)
        else:
            bq, bt, b_aff, b_rmse, b_valid = (x[0] for x in out[:5])
            escalated = False
        rmse_chunk0 = b_rmse
    else:
        total = hyps.q.shape[-2]
        dev = hyps.q.device
        pad_idx = torch.cat([torch.arange(total, device=dev),
                             torch.zeros((-total) % CHUNK, dtype=torch.long, device=dev)])
        thr = ENERGY_RATIO_THRESHOLD * rmse_last0
        if batched:
            # gathers, not slices: a slice of B > 1 rows would be copied where
            # one row is a view, and B sequences make the same launches as one
            first = pad_idx[:CHUNK]
            out = run(hyps.q[:, first].reshape(-1, 1, CHUNK, 4),
                      hyps.t[:, first].reshape(-1, 1, CHUNK, 3))
            rmse_chunk0 = out[3]
            # the gate's B flags: the tick's one read before its statistics
            escalated = tuple(bool(f) for f in ((out[4] == 0) | (rmse_chunk0 >= thr)).tolist())
            esc_rows = tuple(b for b in rows if escalated[b])
            if esc_rows:
                esc = _sequence_index(esc_rows, 1, dev, torch.long)
                later = pad_idx[CHUNK:]
                rest = run(hyps.q[esc[:, None], later].reshape(len(esc_rows), -1, CHUNK, 4),
                           hyps.t[esc[:, None], later].reshape(len(esc_rows), -1, CHUNK, 3),
                           SE3(kf.q.index_select(0, esc), kf.t.index_select(0, esc)), esc_rows)
                bq, bt, b_aff, b_rmse, b_valid = _retrack_winners(out, rest, esc)
            else:
                bq, bt, b_aff, b_rmse, b_valid = out[:5]
        else:
            chunks_q = hyps.q[pad_idx].reshape(-1, CHUNK, 4)
            chunks_t = hyps.t[pad_idx].reshape(-1, CHUNK, 3)
            out = run(chunks_q[:1], chunks_t[:1])
            rmse_chunk0 = out[3][0]
            escalated = bool((out[4][0] == 0) | (rmse_chunk0 >= thr))
            if escalated:
                rest = run(chunks_q[1:], chunks_t[1:])
                out = tuple(torch.cat([a, b]) for a, b in zip(out, rest))
            best = torch.argmin(out[5]).view(1)
            bq, bt, b_aff, b_rmse, b_valid = (x.index_select(0, best)[0] for x in out[:5])

    t_t_kf = SE3(bq, bt)
    t_w_t = kf @ t_t_kf.inverse()
    immature = estimate_depths(immature, maps[0], models[0], t_w_t.q, t_w_t.t,
                               window_poses_q, window_poses_t, window_affines, b_aff,
                               exposure, window_exposures, huber_sigma)
    t_kf_frame_mat = t_t_kf.inverse().matrix()
    num_valid = b_valid.to(torch.int32)
    stats = frame_statistics(flow_points, models[0], t_t_kf, t_kf_frame_mat, b_rmse, num_valid,
                             rmse_last0, kf_rmse, keyframe_factor, force_kf)
    flow, flow_nr = stats[..., STAT_FLOW], stats[..., STAT_FLOW_NO_ROT]
    return FusedTickResult(
        maps=maps, pose_q=t_w_t.q, pose_t=t_w_t.t, affine=b_aff, rmse=b_rmse,
        num_valid=num_valid, flow=flow, flow_no_rot=flow_nr,
        immature=immature, t_kf_frame_mat=t_kf_frame_mat, escalated=escalated,
        rmse_chunk0=rmse_chunk0, stats=stats)
