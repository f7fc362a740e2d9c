"""Regular-frame tick (counterpart of ``dsopp_tpu/tracker/fused_tick.py``
and of ``tracker/monocular.py::_initialization_hypotheses``).

Pyramid (K1) → coarse-to-fine alignment of a chunk of 5 pose hypotheses
(on the card one K3 launch per level for all hypotheses of the call, 5 or
105; level 0 only for each chunk's coarse winner, or for every hypothesis
when there is no coarser level) → epipolar depth update
of every window bank (K4) → flow statistic.  When
the first chunk fails the 2.5× reliability gate, the 104 rotation-perturbed
hypotheses run too (chunks 1..21, batched into one align chain); the best
per-point energy over all chunks wins, the earliest chunk on ties.
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
from dsopp_tpu_torch.tracker.depth_map import mean_square_flows

ENERGY_RATIO_THRESHOLD = 2.5
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
    escalated: bool
    rmse_chunk0: torch.Tensor   # the rmse the re-track gate tested (chunk 0's)


def _initialization_hypotheses(t_w_last: SE3, t_prev_rel: SE3, t_w_kf: SE3,
                               with_perturbations: bool) -> SE3:
    """Batched initial poses T_w_t: const motion, double, half, zero, zero
    from the keyframe, then (optionally) 104 rotation perturbations of the
    const-motion pose."""
    cands = [
        t_w_last @ t_prev_rel,
        t_w_last @ t_prev_rel @ t_prev_rel,
        t_w_last @ SE3.exp(0.5 * t_prev_rel.log()),
        t_w_last,
        t_w_kf,
    ]
    q = torch.stack([c.q for c in cands])
    t = torch.stack([c.t for c in cands])
    if with_perturbations:
        xi = _perturbations(q.dtype, q.device)
        n = xi.shape[0]
        base = cands[0]
        pert = SE3(base.q.expand(n, 4), base.t.expand(n, 3)) @ SE3.exp(xi)
        q = torch.cat([q, pert.q])
        t = torch.cat([t, pert.t])
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
                exp_ratio, opts: AlignmentOptions, num_levels: int):
    """Chunks [C, CHUNK] of T_w_t hypotheses through the coarse-to-fine
    schedule → per chunk (q, t, affine, rmse, num_valid, score).  Level 0
    refines each chunk's coarse winner; with one level there is no coarse
    ranking, and level 0 refines every hypothesis and picks the winner."""
    c = hyp_q.shape[0]
    hyps = SE3(hyp_q.reshape(-1, 4), hyp_t.reshape(-1, 3))
    nb = hyps.q.shape[0]
    t = hyps.inverse().compose(SE3(kf.q.expand(nb, 4), kf.t.expand(nb, 3)))
    affine = last_affine.expand(nb, 2).contiguous()
    result = None
    for level in range(num_levels - 1, 0, -1):
        result = align_level(level_points[level], maps[level], models[level], t,
                             affine, last_affine, exp_ratio, opts)
        t, affine = result.t_t_r, result.affine
    if result is not None:
        pick = _chunk_winners(result, c)
        res0 = align_level(level_points[0], maps[0], models[0],
                           SE3(t.q[pick], t.t[pick]), affine[pick], last_affine,
                           exp_ratio, opts)
    else:
        res = align_level(level_points[0], maps[0], models[0], t, affine, last_affine,
                          exp_ratio, opts)
        pick = _chunk_winners(res, c)
        res0 = res._replace(t_t_r=SE3(res.t_t_r.q[pick], res.t_t_r.t[pick]),
                            **{name: getattr(res, name)[pick] for name in
                               ("affine", "energy", "num_valid", "rmse", "iterations")})
    score0 = torch.where(res0.num_valid > 0,
                         res0.energy / torch.clamp(res0.num_valid, min=1),
                         torch.full_like(res0.energy, float("inf")))
    return (res0.t_t_r.q, res0.t_t_r.t, res0.affine, res0.rmse,
            res0.num_valid, score0)


def fused_regular_tick(image, level_points, flow_points, window_poses_q,
                       window_poses_t, window_affines, window_exposures,
                       exposure, kf_slot, immature: ImmaturePoints, last_q, last_t,
                       prev_q, prev_t, last_affine, models,
                       align_opts: AlignmentOptions, with_perturbations: bool,
                       num_levels: int, huber_sigma: float,
                       rmse_last0) -> FusedTickResult:
    """One tracked frame's frontend.  ``kf_slot``: [1] long tensor of the
    newest keyframe slot.  Reads one flag on the host when perturbations
    are armed (whether chunk 0 failed the gate)."""
    maps = build_pyramid_maps(image, num_levels)
    kf = SE3(window_poses_q.index_select(0, kf_slot)[0],
             window_poses_t.index_select(0, kf_slot)[0])
    exp_ratio_kf = exposure / torch.clamp(window_exposures.index_select(0, kf_slot)[0], min=1e-12)
    hyps = _initialization_hypotheses(SE3(last_q, last_t), SE3(prev_q, prev_t), kf,
                                      with_perturbations)
    run = lambda q, t: _run_chunks(q, t, kf, maps, level_points, models,  # noqa: E731
                                   last_affine, exp_ratio_kf, align_opts, num_levels)
    escalated = False
    if not with_perturbations:
        out = run(hyps.q[None], hyps.t[None])
        bq, bt, b_aff, b_rmse, b_valid = (x[0] for x in out[:5])
        rmse_chunk0 = b_rmse
    else:
        total = hyps.q.shape[0]
        dev = hyps.q.device
        pad_idx = torch.cat([torch.arange(total, device=dev),
                             torch.zeros((-total) % CHUNK, dtype=torch.long, device=dev)])
        chunks_q = hyps.q[pad_idx].reshape(-1, CHUNK, 4)
        chunks_t = hyps.t[pad_idx].reshape(-1, CHUNK, 3)
        out = run(chunks_q[:1], chunks_t[:1])
        thr = ENERGY_RATIO_THRESHOLD * rmse_last0
        rmse_chunk0 = out[3][0]
        escalated = bool((out[4][0] == 0) | (rmse_chunk0 >= thr))
        if escalated:
            rest = run(chunks_q[1:], chunks_t[1:])
            out = tuple(torch.cat([a, b]) for a, b in zip(out, rest))
        best = torch.argmin(out[5]).view(1)
        bq, bt, b_aff, b_rmse, b_valid = (x.index_select(0, best)[0] for x in out[:5])

    t_t_kf = SE3(bq, bt)
    t_w_t = kf @ t_t_kf.inverse()
    k = window_poses_q.shape[0]
    t_inv = t_w_t.inverse()
    t_rel = SE3(t_inv.q.expand(k, 4), t_inv.t.expand(k, 3)).compose(
        SE3(window_poses_q, window_poses_t))
    immature = estimate_depths(immature, maps[0], models[0], t_rel.q, t_rel.t,
                               window_affines, b_aff,
                               exposure / torch.clamp(window_exposures, min=1e-12),
                               huber_sigma)
    flow, flow_nr = mean_square_flows(flow_points, models[0], t_t_kf)
    return FusedTickResult(
        maps=maps, pose_q=t_w_t.q, pose_t=t_w_t.t, affine=b_aff, rmse=b_rmse,
        num_valid=b_valid.to(torch.int32), flow=flow, flow_no_rot=flow_nr,
        immature=immature, t_kf_frame_mat=t_t_kf.inverse().matrix(), escalated=escalated,
        rmse_chunk0=rmse_chunk0)
