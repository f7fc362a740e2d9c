"""Immature-point depth estimation by epipolar search (counterpart of
``dsopp_tpu/tracker/depth_estimation.py``) — kernel K4.

Per new frame every active immature point samples its epipolar segment at
S = 32 uniform positions, takes the SSD of the 8-point pattern against its
exposure- and affine-corrected reference patch, keeps the argmin and the
best energy outside a ±2 px uniqueness radius, refines the winner with 4
Gauss-Newton steps along the epiline (steps clipped to ±0.3 px), and then
updates its inverse-depth interval and status.

:func:`estimate_depths` takes the new frame's pose T_w_t and the window's
poses, as the JAX package's regular tick composes them.  On CUDA tensors it
is :func:`estimate_depths_cuda`, one launch of ``csrc/epipolar.cu`` that
composes the relative poses and runs the geometry, the sweep, the error
model, the interval shrink and the status machine; on CPU tensors
:func:`estimate_depths_plain`, plain PyTorch in three parts:
:func:`sweep_inputs` (the geometry), :func:`epipolar_sweep_plain` (sweep,
uniqueness, refine) and :func:`update_from_sweep` (error model, shrink,
status).

B sequences' banks in one call (the batched tick): every argument gains a
leading ``[B]`` axis (banks ``[B, K, N]``, the target maps ``[B, 3, H, W]``,
the poses, affines and exposures per sequence).  On the card that is the
same one launch with a grid axis over the sequences, each sequence's
outputs those of its own launch to the bit; on the CPU each sequence runs
through :func:`estimate_depths_plain` in turn.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.camera import MIN_DEPTH, valid_idepth
from dsopp_tpu_torch.core.interpolate import (pad_images, sample_window,
                                              sample_window_values, window_base)
from dsopp_tpu_torch.core.lie import SE3, quat_rotate
from dsopp_tpu_torch.core.pattern import PATTERN_SIZE, shift_pattern

STATUS_GOOD = 0
STATUS_OOB = 1
STATUS_OUTLIER = 2
STATUS_SKIPPED = 3
STATUS_ILL_CONDITIONED = 4
STATUS_UNINITIALIZED = 5

MIN_EPILINE_SIZE = 2.0
MIN_DEPTH_SCALE = 0.75
MAX_DEPTH_SCALE = 1.5
MAX_ERROR = 10.0
UNIQUENESS_RADIUS_PX = 2.0
MIN_EPILINE_FOR_UNIQUENESS = 10.0
MAX_ENERGY_PER_PIXEL = 12.0 * 12.0
MAX_ENERGY_INLIER = PATTERN_SIZE * MAX_ENERGY_PER_PIXEL
MAX_PIX_SEARCH_FACTOR = 0.027
MAX_SUBPIXEL_STEP = 0.3
INITIAL_IDEPTH_MAX = 1.0 / MIN_DEPTH
NUM_SAMPLES = 32
GROUP = 4            # consecutive samples sharing one 10×10 window
GN_ITERATIONS = 4


class ImmaturePoints(NamedTuple):
    """Immature landmark banks ``[K, N]`` (one bank per window slot)."""

    uv: torch.Tensor            # [..., N, 2]
    patch: torch.Tensor         # [..., N, P]
    gradient: torch.Tensor      # [..., N, 2]
    idepth_min: torch.Tensor    # [..., N]
    idepth_max: torch.Tensor    # [..., N]
    status: torch.Tensor        # [..., N] int32
    traced: torch.Tensor        # [..., N] bool
    uniqueness: torch.Tensor    # [..., N]
    search_interval: torch.Tensor  # [..., N]
    valid: torch.Tensor         # [..., N] bool

    @property
    def idepth(self):
        return 0.5 * (self.idepth_min + self.idepth_max)


def _triangulate_idepth(pr, t, ray_target):
    """Reference-frame idepth whose target projection is ``ray_target``."""
    vx, vy = ray_target[..., 0], ray_target[..., 1]
    den_x = t[..., 0] - vx * t[..., 2]
    den_y = t[..., 1] - vy * t[..., 2]
    num_x = vx * pr[..., 2] - pr[..., 0]
    num_y = vy * pr[..., 2] - pr[..., 1]
    use_x = torch.abs(den_x) > torch.abs(den_y)
    den = torch.where(use_x, den_x, den_y)
    num = torch.where(use_x, num_x, num_y)
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    return num / den


class SweepInputs(NamedTuple):
    """Per-landmark inputs of the sweep, flattened to ``M = K·N``."""

    active: torch.Tensor      # [M] bool
    uv_a: torch.Tensor        # [M, 2] epiline start
    dir: torch.Tensor         # [M, 2] unit direction
    search_len: torch.Tensor  # [M]
    pr: torch.Tensor          # [M, 3] R·ray of the point
    t: torch.Tensor           # [M, 3] target-from-host translation
    pr_p: torch.Tensor        # [M, P, 3] R·ray of the pattern points
    corr_ref: torch.Tensor    # [M, P] corrected reference patch
    b_tgt: torch.Tensor       # [1] target affine b
    alphas: torch.Tensor      # [S] sample positions along the segment
    alpha_g: torch.Tensor     # [S / GROUP] group-center positions


class SweepResult(NamedTuple):
    best_idx: torch.Tensor     # [M] int64
    best_energy: torch.Tensor  # [M] sweep energy at the winner
    second_best: torch.Tensor  # [M] best energy outside the radius
    any_sample: torch.Tensor   # [M] bool
    refined_energy: torch.Tensor  # [M] best GN energy (inf if none valid)
    best_delta: torch.Tensor   # [M] GN offset of that energy (px)


def epipolar_sweep_plain(inp: SweepInputs, image, model, huber_sigma):
    """Sweep + uniqueness + GN refine in plain PyTorch (see module doc)."""
    h_px, w_px = image.shape
    padded = pad_images(image)
    m, s = inp.uv_a.shape[0], inp.alphas.shape[0]
    sl = inp.search_len[:, None, None]
    uv_s = inp.uv_a[:, None, :] + (inp.alphas[None, :, None] * sl) * inp.dir[:, None, :]
    rho_s = _triangulate_idepth(inp.pr[:, None, :], inp.t[:, None, :],
                                model.unproject(uv_s))                     # [M,S]
    q_sp = inp.pr_p[:, None] + rho_s[:, :, None, None] * inp.t[:, None, None, :]
    uv_sp, valid_sp = model.project(q_sp)                                 # [M,S,P]
    uv_g = inp.uv_a[:, None, :] + (inp.alpha_g[None, :, None] * sl) * inp.dir[:, None, :]
    bx, by = window_base(uv_g, h_px, w_px)                                # [M,G]
    bx = bx.repeat_interleave(GROUP, dim=1)[..., None]
    by = by.repeat_interleave(GROUP, dim=1)[..., None]
    vals, inside = sample_window_values(padded, uv_sp, bx, by, h_px, w_px)
    resid = (vals - inp.b_tgt) - inp.corr_ref[:, None, :]
    sample_ok = (torch.all(valid_sp & inside, dim=-1)
                 & (rho_s > -1e-4) & (rho_s < INITIAL_IDEPTH_MAX * 1.01))
    energy_s = torch.where(sample_ok, torch.sum(resid * resid, dim=-1),
                           torch.full_like(rho_s, float("inf")))
    best_idx = torch.argmin(energy_s, dim=-1)
    best_energy = torch.gather(energy_s, 1, best_idx[:, None])[:, 0]
    any_sample = torch.any(sample_ok, dim=-1)

    spacing = inp.search_len / (s - 1)
    radius = torch.ceil(UNIQUENESS_RADIUS_PX / torch.clamp(spacing, min=1e-6)).to(torch.int32)
    ids = torch.arange(s, device=image.device)[None, :]
    outside = torch.abs(ids - best_idx[:, None]) > radius[:, None]
    second_best = torch.min(torch.where(outside, energy_s, torch.full_like(energy_s, float("inf"))),
                            dim=-1).values

    uv_best = torch.gather(uv_s, 1, best_idx[:, None, None].expand(m, 1, 2))[:, 0]
    pattern_best = torch.gather(
        uv_sp, 1, best_idx[:, None, None, None].expand(m, 1, PATTERN_SIZE, 2))[:, 0]
    rbx, rby = window_base(uv_best, h_px, w_px)
    dirv = inp.dir
    delta = torch.zeros_like(inp.search_len)
    e_best = torch.full_like(delta, float("inf"))
    best_delta = torch.zeros_like(delta)
    for _ in range(GN_ITERATIONS):
        pat = pattern_best - delta[:, None, None] * dirv[:, None, :]
        it, gx, gy, ok = sample_window(padded, pat, rbx[:, None], rby[:, None], h_px, w_px)
        r = (it - inp.b_tgt) - inp.corr_ref
        w = huber_sigma / torch.clamp(torch.abs(r), min=huber_sigma)
        g_tau = gx * dirv[:, None, 0] + gy * dirv[:, None, 1]
        hh = torch.sum(w * g_tau * g_tau, dim=-1)
        bb = torch.sum(w * r * g_tau, dim=-1)
        step = torch.clamp(bb / torch.clamp(hh, min=1e-9), -MAX_SUBPIXEL_STEP, MAX_SUBPIXEL_STEP)
        e = torch.sum(torch.clamp(r, -huber_sigma, huber_sigma) * r, dim=-1)
        e = torch.where(torch.all(ok, dim=-1), e, torch.full_like(e, float("inf")))
        better = e < e_best
        e_best = torch.where(better, e, e_best)
        best_delta = torch.where(better, delta, best_delta)
        delta = delta + step
    return SweepResult(best_idx, best_energy, second_best, any_sample, e_best, best_delta)


def sweep_inputs(points: ImmaturePoints, model, t_q, t_t, affine_ref,
                 affine_tgt, exposure_ratio, num_samples=NUM_SAMPLES):
    """Per-landmark geometry of the sweep for banks ``[K, N]``.

    ``t_q``/``t_t``: [K] target-from-host poses; ``affine_ref`` [K, 2];
    ``affine_tgt`` [2]; ``exposure_ratio`` [K].  Returns the flattened
    :class:`SweepInputs` and the [K, N] tensors the status update needs.
    """
    k, n = points.uv.shape[:2]
    dtype, dev = points.uv.dtype, points.uv.device
    s = num_samples
    st = points.status
    active = points.valid & ((st == STATUS_GOOD) | (st == STATUS_SKIPPED)
                             | (st == STATUS_ILL_CONDITIONED)
                             | (st == STATUS_UNINITIALIZED))
    ray = model.unproject(points.uv)                                  # [K,N,3]
    pr = quat_rotate(t_q[:, None], ray)
    t = t_t[:, None].expand(pr.shape)

    rho_min = torch.clamp(points.idepth_min, min=0.0)
    rho_max = torch.clamp(points.idepth_max, max=INITIAL_IDEPTH_MAX)
    min_qz = 1e-3
    tz = t[..., 2]
    rho_limit = (min_qz - pr[..., 2]) / torch.where(torch.abs(tz) < 1e-12,
                                                    torch.full_like(tz, 1e-12), tz)
    decreasing = tz < 0
    rho_max = torch.where(decreasing & (pr[..., 2] + rho_max * tz < min_qz),
                          torch.maximum(rho_limit, rho_min), rho_max)
    uv_a, valid_a = model.project(pr + rho_min[..., None] * t)
    uv_b, valid_b = model.project(pr + rho_max[..., None] * t)
    depth_scale = pr[..., 2] + rho_min * tz
    scale_bad = (points.idepth_min >= 0) & ((depth_scale < MIN_DEPTH_SCALE)
                                            | (depth_scale > MAX_DEPTH_SCALE))
    seg = uv_b - uv_a
    seg_len = torch.sqrt(torch.sum(seg * seg, dim=-1))
    too_short = seg_len < MIN_EPILINE_SIZE
    dir_unit = seg / torch.clamp(seg_len, min=1e-12)[..., None]
    max_search = MAX_PIX_SEARCH_FACTOR * (model.width + model.height)
    search_len = torch.where(points.traced, seg_len,
                             torch.clamp(seg_len, max=max_search))

    pr_p = quat_rotate(t_q[:, None, None], model.unproject(shift_pattern(points.uv)))
    scale = exposure_ratio * torch.exp(affine_tgt[0] - affine_ref[:, 0])      # [K]
    corr_ref = scale[:, None, None] * (points.patch - affine_ref[:, 1][:, None, None])

    alphas = torch.linspace(0.0, 1.0, s, dtype=dtype, device=dev)
    groups = s // GROUP
    alpha_g = ((GROUP * torch.arange(groups, dtype=dtype, device=dev)
                + 0.5 * (GROUP - 1)) / (s - 1))
    m = k * n
    inp = SweepInputs(
        active=active.reshape(m).contiguous(),
        uv_a=uv_a.reshape(m, 2).contiguous(),
        dir=dir_unit.reshape(m, 2).contiguous(),
        search_len=search_len.reshape(m).contiguous(),
        pr=pr.reshape(m, 3).contiguous(),
        t=t.reshape(m, 3).contiguous(),
        pr_p=pr_p.reshape(m, PATTERN_SIZE, 3).contiguous(),
        corr_ref=corr_ref.reshape(m, PATTERN_SIZE).contiguous(),
        b_tgt=affine_tgt[1:2].contiguous(),
        alphas=alphas, alpha_g=alpha_g)
    geo = dict(active=active, valid_a=valid_a, valid_b=valid_b,
               scale_bad=scale_bad, too_short=too_short, search_len=search_len,
               uv_a=uv_a, dir=dir_unit, pr=pr, t=t, alphas=alphas)
    return inp, geo


def relative_poses(pose_q, pose_t, window_poses_q, window_poses_t):
    """[K] target-from-host poses inverse(T_w_t) · T_w_k (the JAX package's
    ``fused_tick.py:204-208``)."""
    k = window_poses_q.shape[0]
    t_inv = SE3(pose_q, pose_t).inverse()
    return SE3(t_inv.q.expand(k, 4), t_inv.t.expand(k, 3)).compose(
        SE3(window_poses_q, window_poses_t))


def estimate_depths_plain(points: ImmaturePoints, target_map, model, pose_q, pose_t,
                          window_poses_q, window_poses_t, window_affines, affine_tgt,
                          exposure, window_exposures, huber_sigma: float = 20.0,
                          num_samples: int = NUM_SAMPLES) -> ImmaturePoints:
    """:func:`estimate_depths` in plain PyTorch."""
    t_rel = relative_poses(pose_q, pose_t, window_poses_q, window_poses_t)
    ratio = exposure / torch.clamp(window_exposures, min=1e-12)
    inp, geo = sweep_inputs(points, model, t_rel.q, t_rel.t, window_affines, affine_tgt,
                            ratio, num_samples)
    res = epipolar_sweep_plain(inp, target_map[0], model, huber_sigma)
    return update_from_sweep(points, geo, res, model)


class EpipolarDebug(NamedTuple):
    """The kernel's optional record of its sweep ([K, N] each, as
    :class:`SweepResult` with an int32 ``best_idx``) and of the relative
    poses it composed (``rel_pose`` [K, 7]: q, t)."""

    best_idx: torch.Tensor
    best_energy: torch.Tensor
    second_best: torch.Tensor
    any_sample: torch.Tensor
    refined_energy: torch.Tensor
    best_delta: torch.Tensor
    rel_pose: torch.Tensor


_DEBUG_DTYPES = {"best_idx": torch.int32, "any_sample": torch.bool}


def debug_buffers(k: int, n: int, device) -> EpipolarDebug:
    """Empty :class:`EpipolarDebug` for banks ``[k, n]``."""
    return EpipolarDebug(*(
        torch.empty((k, 7) if name == "rel_pose" else (k, n),
                    dtype=_DEBUG_DTYPES.get(name, torch.float32), device=device)
        for name in EpipolarDebug._fields))


def estimate_depths_cuda(points: ImmaturePoints, target_map, model, pose_q, pose_t,
                         window_poses_q, window_poses_t, window_affines, affine_tgt,
                         exposure, window_exposures, huber_sigma: float = 20.0,
                         debug: EpipolarDebug | None = None) -> ImmaturePoints:
    """Kernel K4: :func:`estimate_depths` in one launch, of one sequence or of
    B (a leading ``[B]`` axis on every argument).  ``debug``: optional
    :func:`debug_buffers` the kernel fills too (one sequence)."""
    batched = target_map.dim() == 4
    lead = tuple(target_map.shape[:1]) if batched else ()
    k, n = points.uv.shape[len(lead):len(lead) + 2]
    h, w = target_map.shape[-2:]
    check = kernels.check
    for name in ("uv", "gradient"):
        check(getattr(points, name), name, lead + (k, n, 2))
    check(points.patch, "patch", lead + (k, n, PATTERN_SIZE))
    for name in ("idepth_min", "idepth_max", "uniqueness", "search_interval"):
        check(getattr(points, name), name, lead + (k, n))
    check(points.status, "status", lead + (k, n), torch.int32)
    check(points.traced, "traced", lead + (k, n), torch.bool)
    check(points.valid, "valid", lead + (k, n), torch.bool)
    check(target_map, "target_map", lead + (target_map.shape[-3], h, w))
    check(pose_q, "pose_q", lead + (4,))
    check(pose_t, "pose_t", lead + (3,))
    check(window_poses_q, "window_poses_q", lead + (k, 4))
    check(window_poses_t, "window_poses_t", lead + (k, 3))
    check(window_affines, "window_affines", lead + (k, 2))
    check(affine_tgt, "affine_tgt", lead + (2,))
    if batched:
        check(exposure, "exposure", lead)
    else:
        if exposure.numel() != 1:
            raise ValueError(f"exposure: expected one value, got shape {tuple(exposure.shape)}")
        check(exposure, "exposure", tuple(exposure.shape))
    check(window_exposures, "window_exposures", lead + (k,))
    if debug is not None:
        if batched:
            raise ValueError("debug: one sequence's launch only")
        for name, x in debug._asdict().items():
            check(x, f"debug.{name}", (k, 7) if name == "rel_pose" else (k, n),
                  _DEBUG_DTYPES.get(name, torch.float32))
    dev, dt = target_map.device, target_map.dtype

    def empty(dtype=dt):
        return torch.empty(lead + (k, n), dtype=dtype, device=dev)

    out = points._replace(idepth_min=empty(), idepth_max=empty(),
                          status=empty(torch.int32), traced=empty(torch.bool),
                          uniqueness=empty(), search_interval=empty())
    dbg = (None,) * 7 if debug is None else tuple(debug)
    f32 = np.float32
    kernels.EPIPOLAR(points.uv, points.patch, points.gradient, points.idepth_min,
                     points.idepth_max, points.status, points.traced, points.uniqueness,
                     points.search_interval, points.valid, k, n, lead[0] if batched else 1,
                     target_map, target_map[0].numel() if batched else 0, h, w,
                     pose_q, pose_t, window_poses_q, window_poses_t, window_affines,
                     affine_tgt, exposure, window_exposures, model.fx, model.fy,
                     model.cx, model.cy, float(f32(1.0) / f32(model.fx)),
                     float(f32(1.0) / f32(model.fy)), model.width, model.height,
                     float(huber_sigma), MAX_PIX_SEARCH_FACTOR * (model.width + model.height),
                     out.idepth_min, out.idepth_max, out.status, out.traced, out.uniqueness,
                     out.search_interval, *dbg)
    return out


def estimate_depths(points: ImmaturePoints, target_map, model, pose_q, pose_t,
                    window_poses_q, window_poses_t, window_affines, affine_tgt,
                    exposure, window_exposures,
                    huber_sigma: float = 20.0) -> ImmaturePoints:
    """One epipolar update of every bank ``[K, N]`` against a new frame.

    ``target_map``: [3, H, W] level-0 map of the new frame; ``pose_q`` /
    ``pose_t``: its pose T_w_t; ``window_poses_q`` [K, 4] / ``window_poses_t``
    [K, 3]: the host keyframes' poses T_w_k; ``window_affines`` [K, 2];
    ``affine_tgt`` [2]; ``exposure``: the frame's exposure (one value);
    ``window_exposures`` [K].  The kernel on CUDA tensors, the plain version
    on CPU ones.  With a leading ``[B]`` axis on every argument (``target_map``
    [B, 3, H, W]): B sequences in one call.
    """
    if target_map.is_cuda:
        return estimate_depths_cuda(points, target_map, model, pose_q, pose_t, window_poses_q,
                                    window_poses_t, window_affines, affine_tgt, exposure,
                                    window_exposures, huber_sigma)
    if target_map.dim() == 4:
        return estimate_depths_sequences_plain(points, target_map, model, pose_q, pose_t,
                                               window_poses_q, window_poses_t, window_affines,
                                               affine_tgt, exposure, window_exposures,
                                               huber_sigma)
    return estimate_depths_plain(points, target_map, model, pose_q, pose_t, window_poses_q,
                                 window_poses_t, window_affines, affine_tgt, exposure,
                                 window_exposures, huber_sigma)


def estimate_depths_sequences_plain(points: ImmaturePoints, target_map, model, pose_q,
                                    pose_t, window_poses_q, window_poses_t, window_affines,
                                    affine_tgt, exposure, window_exposures,
                                    huber_sigma: float = 20.0) -> ImmaturePoints:
    """:func:`estimate_depths` of B sequences on the CPU: each sequence's banks
    through :func:`estimate_depths_plain`, the results stacked."""
    outs = [estimate_depths_plain(ImmaturePoints(*(x[b] for x in points)), target_map[b],
                                  model, pose_q[b], pose_t[b], window_poses_q[b],
                                  window_poses_t[b], window_affines[b], affine_tgt[b],
                                  exposure[b], window_exposures[b], huber_sigma)
            for b in range(target_map.shape[0])]
    return ImmaturePoints(*(torch.stack(xs) for xs in zip(*outs)))


def update_from_sweep(points: ImmaturePoints, geo: dict, res: SweepResult,
                      model) -> ImmaturePoints:
    """Error model, 11-step interval shrink and status machine from a sweep
    result (``geo``: the second output of :func:`sweep_inputs`)."""
    k, n = points.uv.shape[:2]

    def kn(x):
        return x.reshape((k, n) + tuple(x.shape[1:]))

    best_idx = kn(res.best_idx)
    search_len, dir_unit = geo["search_len"], geo["dir"]
    uniqueness = kn(res.second_best) / torch.clamp(kn(res.best_energy), min=1e-12)
    update_uniqueness = search_len > MIN_EPILINE_FOR_UNIQUENESS
    alpha_best = geo["alphas"][best_idx]
    uv_best = geo["uv_a"] + (alpha_best * search_len)[..., None] * dir_unit
    refined = kn(res.refined_energy)
    best_energy = torch.where(torch.isfinite(refined), refined, kn(res.best_energy))
    shift = -kn(res.best_delta)

    # gradient-angle error model (reference calculateError)
    g = points.gradient
    a_term = torch.square(dir_unit[..., 0] * g[..., 0] + dir_unit[..., 1] * g[..., 1])
    b_term = torch.square(dir_unit[..., 1] * g[..., 0] - dir_unit[..., 0] * g[..., 1])
    error = 0.2 + 0.2 * (a_term + b_term) / torch.clamp(a_term, min=1e-12)
    ill = (error > search_len / 2.0) & points.traced
    error = torch.clamp(error, max=MAX_ERROR)

    # interval update: widest valid error radius of an 11-step shrink
    ks = torch.linspace(1.0, 0.0, 11, dtype=error.dtype, device=error.device)
    errs = error[..., None] * ks
    d3 = dir_unit[..., None, :]
    uv_lo = uv_best[..., None, :] + (shift[..., None] - errs)[..., None] * d3
    uv_hi = uv_best[..., None, :] + (shift[..., None] + errs)[..., None] * d3
    pr3, t3 = geo["pr"][..., None, :], geo["t"][..., None, :]
    rho_lo = _triangulate_idepth(pr3, t3, model.unproject(uv_lo))
    rho_hi = _triangulate_idepth(pr3, t3, model.unproject(uv_hi))
    pair_valid = valid_idepth(rho_lo) & valid_idepth(rho_hi)
    first_valid = torch.argmax(pair_valid.to(torch.uint8), dim=-1, keepdim=True)
    has_valid = torch.any(pair_valid, dim=-1)
    rho_lo = torch.gather(rho_lo, -1, first_valid)[..., 0]
    rho_hi = torch.gather(rho_hi, -1, first_valid)[..., 0]
    new_min = torch.minimum(rho_lo, rho_hi)
    new_max = torch.maximum(rho_lo, rho_hi)

    oob = ((~geo["valid_a"] & ~geo["valid_b"]) | ~kn(res.any_sample)
           | geo["scale_bad"] | ~has_valid)
    outlier = best_energy > MAX_ENERGY_INLIER
    too_short = geo["too_short"]
    status = torch.full_like(points.status, STATUS_GOOD)
    status = torch.where(ill, STATUS_ILL_CONDITIONED, status)
    status = torch.where(outlier, STATUS_OUTLIER, status)
    status = torch.where(too_short, STATUS_SKIPPED, status)
    status = torch.where(oob, STATUS_OOB, status).to(torch.int32)
    good = status == STATUS_GOOD
    zero = torch.zeros_like(search_len)
    search_interval = torch.where(good, 2.0 * error,
                                  torch.where(too_short | ill, search_len, zero))

    active = geo["active"]

    def keep(new, old):
        return torch.where(active, new, old)

    return points._replace(
        idepth_min=keep(torch.where(good, new_min, points.idepth_min), points.idepth_min),
        idepth_max=keep(torch.where(good, new_max, points.idepth_max), points.idepth_max),
        status=keep(status, points.status),
        traced=keep(points.traced | good, points.traced),
        uniqueness=keep(torch.where(update_uniqueness & good, uniqueness,
                                    points.uniqueness), points.uniqueness),
        search_interval=keep(search_interval, points.search_interval),
    )


def make_immature_points(uv, patch, gradient) -> ImmaturePoints:
    """Fresh immature bank ``[N]`` from extracted candidates, or ``[S, N]``
    banks of S sequences' (dense, so that the banks written from it stay
    dense for kernel K4)."""
    dtype, dev = uv.dtype, uv.device
    lead = tuple(uv.shape[:-1])
    return ImmaturePoints(
        uv=uv.contiguous(), patch=patch.contiguous(), gradient=gradient.contiguous(),
        idepth_min=torch.zeros(lead, dtype=dtype, device=dev),
        idepth_max=torch.full(lead, INITIAL_IDEPTH_MAX, dtype=dtype, device=dev),
        status=torch.full(lead, STATUS_UNINITIALIZED, dtype=torch.int32, device=dev),
        traced=torch.zeros(lead, dtype=torch.bool, device=dev),
        uniqueness=torch.full(lead, float("inf"), dtype=dtype, device=dev),
        search_interval=torch.zeros(lead, dtype=dtype, device=dev),
        valid=torch.ones(lead, dtype=torch.bool, device=dev),
    )
