"""Sliding-window photometric bundle adjustment (counterpart of the parts of
``dsopp_tpu/solvers/pba.py`` the tracker's main path runs).

Per-frame state ε = [6 pose | a, b], pose applied as T_lin·exp(ε); FEJ
geometric Jacobians at the linearization point; whole-patch Huber; residual
statuses Ok/OOB/Outlier committed on LM accept; LM with force-accept for the
first iterations and a constant regularizer; affine and fixed-frame priors;
a marginalization ledger (H_m, b_m, E_m) kept in float64 (the reference
keeps it in double); frames Schur-eliminated on marginalization.

The window is a fixed-shape bank of K frame slots × N landmark slots × the
8-point pattern, residuals a dense [K_anchor, K_target, N, P] tensor.
Target values and gradients are read from the frames' intensity images with
the 10×10-window semantics of :func:`sample_window` (one window per
(anchor, target, landmark) group, based at the reprojected pattern center).

Three functions have a hand-written CUDA kernel beside their plain PyTorch
version and dispatch on ``window.maps.is_cuda``: :func:`_fej_cache` (K6,
``csrc/ba_fej.cu``), :func:`_evaluate` (K7, ``csrc/ba_evaluate.cu``) and
:func:`_linearize_from_ev` (K8, ``csrc/ba_linearize.cu``).  CUDA tensors go
to the kernel or raise; the plain versions run on CPU tensors only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from dsopp_tpu_torch import default_device, kernels
from dsopp_tpu_torch.core.interpolate import pad_images, sample_window, window_base
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.core.pattern import PATTERN_CENTER, shift_pattern
from dsopp_tpu_torch.core.reproject import reproject, reproject_jacobian
from dsopp_tpu_torch.solvers.linear import pinv_hermitian, solve
from dsopp_tpu_torch.solvers.measure import huber_energy_weight

RES_OK = 0
RES_OOB = 1
RES_OUTLIER = 2

BLOCK = 8  # per-frame state: 6 pose + 2 affine
LEDGER_DTYPE = torch.float64


class PBAOptions(NamedTuple):
    max_iterations: int = 7
    min_iterations: int = 3
    force_accept: bool = True
    initial_regularizer: float = 1e-5
    function_tolerance: float = 1e-8
    parameter_tolerance: float = 1e-8
    huber_sigma: float = 20.0
    reg_decrease: float = 1.0
    reg_increase: float = 1.0
    affine_reg_a: float = 1e12
    affine_reg_b: float = 1e8
    fixed_reg: float = 1e16
    idepth_nullspace_threshold: float = 1e-15
    scale_nullspace_reg: float = 1e8
    min_valid_reprojections: int = 1


@dataclasses.dataclass(frozen=True)
class Window:
    """Fixed-shape sliding-window state; valid frame slots are [0, count)."""

    t_lin_q: torch.Tensor      # [K, 4]
    t_lin_t: torch.Tensor      # [K, 3]
    affine0: torch.Tensor      # [K, 2]
    eps: torch.Tensor          # [K, 8]
    exposure: torch.Tensor     # [K]
    frame_valid: torch.Tensor  # [K] bool
    frame_fixed: torch.Tensor  # [K] bool
    frame_marg: torch.Tensor   # [K] bool
    frame_id: torch.Tensor     # [K] int32 (-1 = empty)
    lm_uv: torch.Tensor        # [K, N, 2]
    lm_patch: torch.Tensor     # [K, N, P]
    lm_idepth: torch.Tensor    # [K, N]
    lm_valid: torch.Tensor     # [K, N] bool
    lm_marg_flag: torch.Tensor  # [K, N] bool
    lm_outlier: torch.Tensor   # [K, N] bool
    lm_inliers: torch.Tensor   # [K, N] int32
    lm_opt_count: torch.Tensor  # [K, N] int32
    lm_baseline: torch.Tensor  # [K, N]
    res_status: torch.Tensor   # [K, K, N] int32
    h_marg: torch.Tensor       # [K*8, K*8] float64 ledger
    b_marg: torch.Tensor       # [K*8] float64
    energy_marg: torch.Tensor  # [] float64
    maps: torch.Tensor         # [K, 3, H, W] level-0 pixel maps

    @property
    def num_slots(self):
        return self.t_lin_q.shape[0]

    @property
    def num_landmark_slots(self):
        return self.lm_uv.shape[1]

    def t_lin(self) -> SE3:
        return SE3(self.t_lin_q, self.t_lin_t)

    def poses(self) -> SE3:
        """Current poses T_w_c = T_lin · exp(ε_pose)."""
        return self.t_lin() @ SE3.exp(self.eps[:, :6])

    def affine(self):
        return self.affine0 + self.eps[:, 6:]

    def replace(self, **changes) -> "Window":
        return dataclasses.replace(self, **changes)


def empty_window(num_frames: int, num_landmarks: int, map_shape,
                 dtype=torch.float32, device=None) -> Window:
    """An empty window on ``device`` (``None``: the CUDA card)."""
    device = default_device(device)
    k, n = num_frames, num_landmarks
    kw = dict(dtype=dtype, device=device)
    qeye = torch.zeros((k, 4), **kw)
    qeye[:, 0] = 1.0
    return Window(
        t_lin_q=qeye, t_lin_t=torch.zeros((k, 3), **kw),
        affine0=torch.zeros((k, 2), **kw), eps=torch.zeros((k, BLOCK), **kw),
        exposure=torch.ones((k,), **kw),
        frame_valid=torch.zeros((k,), dtype=torch.bool, device=device),
        frame_fixed=torch.zeros((k,), dtype=torch.bool, device=device),
        frame_marg=torch.zeros((k,), dtype=torch.bool, device=device),
        frame_id=torch.full((k,), -1, dtype=torch.int32, device=device),
        lm_uv=torch.zeros((k, n, 2), **kw),
        lm_patch=torch.zeros((k, n, 8), **kw),
        lm_idepth=torch.zeros((k, n), **kw),
        lm_valid=torch.zeros((k, n), dtype=torch.bool, device=device),
        lm_marg_flag=torch.zeros((k, n), dtype=torch.bool, device=device),
        lm_outlier=torch.zeros((k, n), dtype=torch.bool, device=device),
        lm_inliers=torch.zeros((k, n), dtype=torch.int32, device=device),
        lm_opt_count=torch.zeros((k, n), dtype=torch.int32, device=device),
        lm_baseline=torch.zeros((k, n), **kw),
        res_status=torch.zeros((k, k, n), dtype=torch.int32, device=device),
        h_marg=torch.zeros((k * BLOCK, k * BLOCK), dtype=LEDGER_DTYPE, device=device),
        b_marg=torch.zeros((k * BLOCK,), dtype=LEDGER_DTYPE, device=device),
        energy_marg=torch.zeros((), dtype=LEDGER_DTYPE, device=device),
        maps=torch.zeros((k,) + tuple(map_shape), **kw),
    )


def frame_count(window: Window) -> int:
    """Number of valid frame slots (reads the device)."""
    return int(window.frame_valid.sum())


def newest_slot(window: Window):
    """[1] long tensor: the newest valid slot (no host read)."""
    return window.frame_valid.sum().view(1) - 1


def active_lm_mask(window: Window):
    return window.lm_valid & window.frame_valid[:, None]


def _relative_poses(t_q, t_t, eps_pose):
    """T_j⁻¹ · T_i for all ordered pairs → SE3 with batch [K_i, K_j]."""
    t = SE3(t_q, t_t) @ SE3.exp(eps_pose)
    t_inv = t.inverse()
    return SE3(t_inv.q[None], t_inv.t[None]).compose(SE3(t.q[:, None], t.t[:, None]))


class FEJCache(NamedTuple):
    d_uv_ref: torch.Tensor      # [K,K,N,P,2,6]
    d_uv_tgt: torch.Tensor      # [K,K,N,P,2,6]
    d_uv_idepth: torch.Tensor   # [K,K,N,P,2]
    corrected_ref: torch.Tensor  # [K,K,N,P]
    scale0: torch.Tensor        # [K,K]
    geom_valid: torch.Tensor    # [K,K,N]


def _brightness_scale(exposure, affine):
    ratio = exposure[None, :] / torch.clamp(exposure[:, None], min=1e-12)
    return ratio * torch.exp(affine[None, :, 0] - affine[:, None, 0])


def _fej_cache_plain(window: Window, model) -> FEJCache:
    k = window.num_slots
    zero = torch.zeros((k, 6), dtype=window.t_lin_q.dtype, device=window.t_lin_q.device)
    t_ji = _relative_poses(window.t_lin_q, window.t_lin_t, zero)
    uv = shift_pattern(window.lm_uv)[:, None]                      # [K,1,N,P,2]
    idepth = window.lm_idepth[:, None, :, None]
    t_b = SE3(t_ji.q[:, :, None, None, :], t_ji.t[:, :, None, None, :])
    rj = reproject_jacobian(model, model, uv, idepth, t_b)
    scale0 = _brightness_scale(window.exposure, window.affine0)
    corrected = scale0[:, :, None, None] * (
        window.lm_patch[:, None] - window.affine0[:, None, None, None, 1])
    return FEJCache(rj.d_uv_d_eps_ref, rj.d_uv_d_eps_tgt, rj.d_uv_d_idepth,
                    corrected, scale0, torch.all(rj.valid, dim=-1))


def _check_window(window: Window):
    """Validate the window tensors the BA kernels read → (k, n, h, w)."""
    k, n = window.num_slots, window.num_landmark_slots
    check = kernels.check
    check(window.maps, "maps", (k, 3) + tuple(window.maps.shape[-2:]))
    check(window.t_lin_q, "t_lin_q", (k, 4))
    check(window.t_lin_t, "t_lin_t", (k, 3))
    check(window.affine0, "affine0", (k, 2))
    check(window.exposure, "exposure", (k,))
    check(window.lm_uv, "lm_uv", (k, n, 2))
    check(window.lm_idepth, "lm_idepth", (k, n))
    check(window.lm_patch, "lm_patch", (k, n, 8))
    h, w = window.maps.shape[-2:]
    return k, n, h, w


def _fej_cache_cuda(window: Window, model) -> FEJCache:
    """Kernel K6: same outputs as :func:`_fej_cache_plain`."""
    k, n, _, _ = _check_window(window)
    kw = dict(dtype=window.eps.dtype, device=window.eps.device)
    d_ref = torch.empty((k, k, n, 8, 2, 6), **kw)
    d_tgt = torch.empty((k, k, n, 8, 2, 6), **kw)
    d_idepth = torch.empty((k, k, n, 8, 2), **kw)
    corrected = torch.empty((k, k, n, 8), **kw)
    scale0 = torch.empty((k, k), **kw)
    geom_valid = torch.empty((k, k, n), dtype=torch.bool, device=window.eps.device)
    kernels.BA_FEJ(window.t_lin_q, window.t_lin_t, window.affine0, window.exposure,
                   window.lm_uv, window.lm_idepth, window.lm_patch, k, n,
                   model.fx, model.fy, model.cx, model.cy, model.width, model.height,
                   d_ref, d_tgt, d_idepth, corrected, scale0, geom_valid)
    return FEJCache(d_ref, d_tgt, d_idepth, corrected, scale0, geom_valid)


def _fej_cache(window: Window, model) -> FEJCache:
    """FEJ Jacobians at the linearization point: the kernel K6 on CUDA
    tensors, the plain version on CPU ones."""
    fn = _fej_cache_cuda if window.maps.is_cuda else _fej_cache_plain
    return fn(window, model)


class Evaluation(NamedTuple):
    residuals: torch.Tensor     # [K,K,N,P]
    energy_patch: torch.Tensor  # [K,K,N]
    weight: torch.Tensor        # [K,K,N]
    status_candidate: torch.Tensor  # [K,K,N] int32
    gx: torch.Tensor            # [K,K,N,P]
    gy: torch.Tensor            # [K,K,N,P]
    ok: torch.Tensor            # [K,K,N]


def _pair_mask(window: Window):
    fv = window.frame_valid
    eye = torch.eye(window.num_slots, dtype=torch.bool, device=fv.device)
    return fv[:, None] & fv[None, :] & ~eye


def _evaluate_plain(window: Window, model, eps, idepth, lm_mask,
                    opts: PBAOptions) -> Evaluation:
    """Residuals of every (anchor i, target j, landmark n) at (eps, idepth)."""
    k = window.num_slots
    h, w = window.maps.shape[-2:]
    t_ji = _relative_poses(window.t_lin_q, window.t_lin_t, eps[:, :6])
    affine = window.affine0 + eps[:, 6:]
    scale = _brightness_scale(window.exposure, affine)
    uv = shift_pattern(window.lm_uv)[:, None]
    d = idepth[:, None, :, None]
    t_b = SE3(t_ji.q[:, :, None, None, :], t_ji.t[:, :, None, None, :])
    rp = reproject(model, model, uv, d, t_b)                        # [K,K,N,P]
    bx, by = window_base(rp.uv[..., PATTERN_CENTER, :], h, w)       # [K,K,N]
    target = torch.arange(k, device=eps.device)[None, :, None, None]
    vals, gx, gy, inside = sample_window(
        pad_images(window.maps[:, 0]), rp.uv, bx[..., None], by[..., None],
        h, w, img_idx=target)
    corrected_ref = scale[:, :, None, None] * (
        window.lm_patch[:, None] - affine[:, None, None, None, 1])
    r = (vals - affine[None, :, None, None, 1]) - corrected_ref
    geom_ok = torch.all(rp.valid & inside, dim=-1)
    live = _pair_mask(window)[:, :, None] & lm_mask[:, None, :]
    candidate = torch.where(live & ~geom_ok, RES_OOB, window.res_status).to(torch.int32)
    ok = live & geom_ok & (window.res_status == RES_OK)
    r = torch.where(ok[..., None], r, torch.zeros_like(r))
    energy, weight = huber_energy_weight(torch.sum(r * r, dim=-1), opts.huber_sigma)
    zero = torch.zeros_like(energy)
    return Evaluation(r, torch.where(ok, energy, zero), torch.where(ok, weight, zero),
                      candidate, gx, gy, ok)


def _evaluate_cuda(window: Window, model, eps, idepth, lm_mask,
                   opts: PBAOptions) -> Evaluation:
    """Kernel K7: same outputs as :func:`_evaluate_plain`."""
    k, n, h, w = _check_window(window)
    check = kernels.check
    check(eps, "eps", (k, BLOCK))
    check(idepth, "idepth", (k, n))
    check(lm_mask, "lm_mask", (k, n), torch.bool)
    check(window.frame_valid, "frame_valid", (k,), torch.bool)
    check(window.res_status, "res_status", (k, k, n), torch.int32)
    dev = eps.device
    kw = dict(dtype=eps.dtype, device=dev)
    residuals = torch.empty((k, k, n, 8), **kw)
    gx = torch.empty((k, k, n, 8), **kw)
    gy = torch.empty((k, k, n, 8), **kw)
    energy = torch.empty((k, k, n), **kw)
    weight = torch.empty((k, k, n), **kw)
    candidate = torch.empty((k, k, n), dtype=torch.int32, device=dev)
    ok = torch.empty((k, k, n), dtype=torch.bool, device=dev)
    # the intensity image of frame f is channel 0 of maps[f]
    kernels.BA_EVALUATE(window.t_lin_q, window.t_lin_t, eps, window.affine0,
                        window.exposure, window.lm_uv, idepth, window.lm_patch, lm_mask,
                        window.frame_valid, window.res_status, window.maps, 3 * h * w,
                        k, n, h, w, model.fx, model.fy, model.cx, model.cy, model.width,
                        model.height, float(opts.huber_sigma), residuals, energy, weight,
                        candidate, gx, gy, ok)
    return Evaluation(residuals, energy, weight, candidate, gx, gy, ok)


def _evaluate(window: Window, model, eps, idepth, lm_mask, opts: PBAOptions) -> Evaluation:
    """Residuals at (eps, idepth): the kernel K7 on CUDA tensors, the plain
    version on CPU ones."""
    fn = _evaluate_cuda if window.maps.is_cuda else _evaluate_plain
    return fn(window, model, eps, idepth, lm_mask, opts)


def _prior_system(window: Window, eps, opts: PBAOptions, marg_pass=False):
    """Affine-brightness + fixed-frame priors as (diag matrix, b)."""
    k = window.num_slots
    sel = window.frame_valid & (window.frame_marg if marg_pass else ~window.frame_marg)
    fixed = (sel & window.frame_fixed)[:, None]
    free = (sel & ~window.frame_fixed)[:, None]
    zero = torch.zeros_like(eps)
    dvec = torch.where(fixed, opts.fixed_reg, zero)
    b = torch.where(fixed, opts.fixed_reg * eps, zero)
    reg = _affine_reg(eps, opts)
    affine = window.affine0 + eps[:, 6:]
    dvec = dvec + torch.cat([zero[:, :6], torch.where(free, reg, zero[:, 6:])], dim=-1)
    b = b + torch.cat([zero[:, :6], torch.where(free, reg * affine, zero[:, 6:])], dim=-1)
    return torch.diag(dvec.reshape(-1)), b.reshape(k * BLOCK)


def _affine_reg(eps, opts: PBAOptions):
    """[K, 2] rows of (reg_a, reg_b), filled on the device (no host copy)."""
    k = eps.shape[0]
    return torch.stack([torch.full((k,), opts.affine_reg_a, dtype=eps.dtype, device=eps.device),
                        torch.full((k,), opts.affine_reg_b, dtype=eps.dtype, device=eps.device)],
                       dim=-1)


def _prior_energy(window: Window, eps, opts: PBAOptions):
    affine = window.affine0 + eps[:, 6:]
    term = _affine_reg(eps, opts) * affine * affine
    return 0.5 * torch.sum(torch.where(window.frame_valid[:, None], term, torch.zeros_like(term)))


class LinearSystem(NamedTuple):
    h_pose: torch.Tensor    # [K*8, K*8] photometric + prior
    b_pose: torch.Tensor    # [K*8]
    h_schur: torch.Tensor   # [K*8, K*8]
    b_schur: torch.Tensor   # [K*8]
    hpd: torch.Tensor       # [K,N,K,8]
    inv_hdd: torch.Tensor   # [K,N]
    b_d: torch.Tensor       # [K,N]


def _linearize_from_ev_plain(window: Window, fej: FEJCache, ev: Evaluation, eps,
                             opts: PBAOptions, marg_pass: bool = False) -> LinearSystem:
    """GN system with FEJ geometry, current gradients and weights, and the
    landmark Schur complement."""
    k = window.num_slots
    w = torch.where(ev.ok & fej.geom_valid, ev.weight, torch.zeros_like(ev.weight))
    gx, gy = ev.gx, ev.gy
    d_ref, d_tgt = fej.d_uv_ref, fej.d_uv_tgt
    j_ref_pose = gx[..., None] * d_ref[..., 0, :] + gy[..., None] * d_ref[..., 1, :]
    j_tgt_pose = gx[..., None] * d_tgt[..., 0, :] + gy[..., None] * d_tgt[..., 1, :]
    ones = torch.ones_like(fej.corrected_ref)
    j_ref = torch.cat([j_ref_pose, fej.corrected_ref[..., None],
                       (fej.scale0[:, :, None, None] * ones)[..., None]], dim=-1)
    j_tgt = torch.cat([j_tgt_pose, -fej.corrected_ref[..., None], -ones[..., None]], dim=-1)
    j_d = gx * fej.d_uv_idepth[..., 0] + gy * fej.d_uv_idepth[..., 1]
    r = ev.residuals
    wj_ref = w[..., None, None] * j_ref
    wj_tgt = w[..., None, None] * j_tgt

    h_rr = torch.einsum("ijnpa,ijnpb->iab", wj_ref, j_ref)
    h_tt = torch.einsum("ijnpa,ijnpb->jab", wj_tgt, j_tgt)
    h_rt = torch.einsum("ijnpa,ijnpb->ijab", wj_ref, j_tgt)
    b_r = torch.einsum("ijnpa,ijnp->ia", wj_ref, r)
    b_t = torch.einsum("ijnpa,ijnp->ja", wj_tgt, r)
    eye = torch.eye(k, dtype=r.dtype, device=r.device)
    h = eye[:, None, :, None] * (h_rr + h_tt)[:, :, None, :]
    h = h + h_rt.permute(0, 2, 1, 3) + h_rt.permute(1, 3, 0, 2)
    h = h.reshape(k * BLOCK, k * BLOCK)
    b = (b_r + b_t).reshape(k * BLOCK)
    h_pr, b_pr = _prior_system(window, eps, opts, marg_pass=marg_pass)

    hpd_ref = torch.einsum("ijnpa,ijnp->ina", wj_ref, j_d)
    hpd_tgt = torch.einsum("ijnpa,ijnp->ijna", wj_tgt, j_d)
    hpd = hpd_tgt.permute(0, 2, 1, 3) + torch.einsum("ina,ij->inja", hpd_ref, eye)
    h_dd = torch.einsum("ijnp,ijnp,ijn->in", j_d, j_d, w)
    b_d = torch.einsum("ijnp,ijnp,ijn->in", j_d, r, w)
    thr = opts.idepth_nullspace_threshold
    if marg_pass:
        h_dd = h_dd + torch.where(window.frame_fixed[:, None] & (h_dd > thr),
                                  opts.scale_nullspace_reg, torch.zeros_like(h_dd))
    inv_hdd = torch.where(h_dd > thr, 1.0 / torch.clamp(h_dd, min=1e-300),
                          torch.zeros_like(h_dd))
    h_schur = torch.einsum("inja,in,inkb->jakb", hpd, inv_hdd, hpd).reshape(k * BLOCK, k * BLOCK)
    b_schur = torch.einsum("inja,in,in->ja", hpd, inv_hdd, b_d).reshape(k * BLOCK)
    return LinearSystem(h + h_pr, b + b_pr, h_schur, b_schur, hpd, inv_hdd, b_d)


# landmarks per block of csrc/ba_linearize.cu's pair and landmark kernels
# (kTileLm, kChunkLm): they size the scratch the caller allocates
_LINEARIZE_TILE_LM = 64
_LINEARIZE_CHUNK_LM = 32


def _linearize_from_ev_cuda(window: Window, fej: FEJCache, ev: Evaluation, eps,
                            opts: PBAOptions, marg_pass: bool = False) -> LinearSystem:
    """Kernel K8: same outputs as :func:`_linearize_from_ev_plain` (the
    diagonal priors are added here, as there)."""
    k, n = window.num_slots, window.num_landmark_slots
    kb = k * BLOCK
    check = kernels.check
    check(fej.d_uv_ref, "d_uv_ref", (k, k, n, 8, 2, 6))
    check(fej.d_uv_tgt, "d_uv_tgt", (k, k, n, 8, 2, 6))
    check(fej.d_uv_idepth, "d_uv_idepth", (k, k, n, 8, 2))
    check(fej.corrected_ref, "corrected_ref", (k, k, n, 8))
    check(fej.scale0, "scale0", (k, k))
    check(fej.geom_valid, "geom_valid", (k, k, n), torch.bool)
    check(ev.residuals, "residuals", (k, k, n, 8))
    check(ev.weight, "weight", (k, k, n))
    check(ev.gx, "gx", (k, k, n, 8))
    check(ev.gy, "gy", (k, k, n, 8))
    check(ev.ok, "ok", (k, k, n), torch.bool)
    check(window.frame_fixed, "frame_fixed", (k,), torch.bool)
    dev = eps.device
    kw = dict(dtype=eps.dtype, device=dev)
    tiles = -(-n // _LINEARIZE_TILE_LM)
    lm_blocks = -(-(k * n) // _LINEARIZE_CHUNK_LM)
    pair_part = torch.empty((k * k * tiles, 16 * 16 + 16), dtype=torch.float64, device=dev)
    lm_part = torch.empty((k * k * n, 18), **kw)
    schur_part = torch.empty((lm_blocks, kb * kb + kb), dtype=torch.float64, device=dev)
    h = torch.empty((kb, kb), **kw)
    b = torch.empty((kb,), **kw)
    h_schur = torch.empty((kb, kb), **kw)
    b_schur = torch.empty((kb,), **kw)
    hpd = torch.empty((k, n, k, BLOCK), **kw)
    inv_hdd = torch.empty((k, n), **kw)
    b_d = torch.empty((k, n), **kw)
    kernels.BA_LINEARIZE(fej.d_uv_ref, fej.d_uv_tgt, fej.d_uv_idepth, fej.corrected_ref,
                         fej.scale0, fej.geom_valid, ev.residuals, ev.weight, ev.gx, ev.gy,
                         ev.ok, window.frame_fixed, k, n, int(bool(marg_pass)),
                         float(opts.idepth_nullspace_threshold),
                         float(opts.scale_nullspace_reg), tiles, lm_blocks, pair_part,
                         lm_part, schur_part, h, b, h_schur, b_schur, hpd, inv_hdd, b_d)
    h_pr, b_pr = _prior_system(window, eps, opts, marg_pass=marg_pass)
    return LinearSystem(h + h_pr, b + b_pr, h_schur, b_schur, hpd, inv_hdd, b_d)


def _linearize_from_ev(window: Window, fej: FEJCache, ev: Evaluation, eps,
                       opts: PBAOptions, marg_pass: bool = False) -> LinearSystem:
    """GN system and landmark Schur complement: the kernel K8 on CUDA
    tensors, the plain version on CPU ones."""
    fn = _linearize_from_ev_cuda if window.maps.is_cuda else _linearize_from_ev_plain
    return fn(window, fej, ev, eps, opts, marg_pass)


def _energy_from_ev(window: Window, ev: Evaluation, eps, opts: PBAOptions):
    """Landmark + prior + ledger energy (ledger quadratic in float64)."""
    e_land = torch.sum(ev.energy_patch)
    n_valid = torch.sum(ev.energy_patch > 0)
    s = eps.reshape(-1).to(LEDGER_DTYPE)
    e_marg = (window.energy_marg + window.b_marg @ s) + 0.5 * (s @ (window.h_marg @ s))
    return e_land + _prior_energy(window, eps, opts) + e_marg.to(e_land.dtype), n_valid


def _solve_step(window: Window, sys: LinearSystem, eps, idepth, lam, opts: PBAOptions):
    """LM step → (eps', idepth', |pose step|², |idepth step|²)."""
    k = window.num_slots
    dtype = eps.dtype
    s = eps.reshape(-1).to(LEDGER_DTYPE)
    b_prior = (window.b_marg + window.h_marg @ s).to(dtype)
    h_full = (sys.h_pose + window.h_marg.to(dtype)
              + torch.diag(torch.diagonal(sys.h_pose) * lam) - sys.h_schur / (1.0 + lam))
    b_full = sys.b_pose - sys.b_schur / (1.0 + lam) + b_prior
    live = torch.repeat_interleave(window.frame_valid, BLOCK)
    eye = torch.eye(k * BLOCK, dtype=dtype, device=eps.device)
    h_full = torch.where(live[:, None] & live[None, :], h_full, eye)
    b_full = torch.where(live, b_full, torch.zeros_like(b_full))
    step = -solve(h_full, b_full)
    step = torch.where(torch.isfinite(step) & live, step, torch.zeros_like(step))
    step_pose = step.reshape(k, BLOCK)
    d_step = -(sys.b_d + torch.einsum("inja,ja->in", sys.hpd, step_pose)) * sys.inv_hdd / (1.0 + lam)
    d_step = torch.where(torch.isfinite(d_step), d_step, torch.zeros_like(d_step))
    return (eps + step_pose, idepth + d_step, torch.sum(step * step),
            torch.sum(d_step * d_step))


def _solve_loop_device(window: Window, model, opts: PBAOptions):
    """The windowed LM solve → (window', energy, num_valid).

    Force-accept for the first ``min_iterations``; candidate statuses commit
    on accept; while the ledger is empty every accepted step is folded into
    the linearization point (fresh FEJ next iteration).  The loop reads its
    accept/done flags on the host (keyframe path only)."""
    lm_mask = active_lm_mask(window)
    ledger_empty = bool(torch.max(torch.abs(window.h_marg)) == 0.0)
    ev = _evaluate(window, model, window.eps, window.lm_idepth, lm_mask, opts)
    e, n = _energy_from_ev(window, ev, window.eps, opts)
    fej = _fej_cache(window, model)
    tq, tt, ab0 = window.t_lin_q, window.t_lin_t, window.affine0
    eps, idepth, lin_idepth = window.eps, window.lm_idepth, window.lm_idepth
    status = window.res_status
    lam = opts.initial_regularizer
    done = bool(n == 0)
    fej_stale = False
    it = 0
    while it < opts.max_iterations and not done:
        win = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0,
                             lm_idepth=lin_idepth, res_status=status)
        if fej_stale:
            fej = _fej_cache(win, model)
        sys = _linearize_from_ev(win, fej, ev, eps, opts)
        eps_new, idepth_new, pose_sq, d_sq = _solve_step(win, sys, eps, idepth, lam, opts)
        ev_new = _evaluate(win, model, eps_new, idepth_new, lm_mask, opts)
        e_new, n_new = _energy_from_ev(win, ev_new, eps_new, opts)
        ftol = torch.abs(e - e_new) / torch.clamp(e, min=1e-30) < opts.function_tolerance
        ok = (n_new > 0) & torch.isfinite(e_new)
        forced = opts.force_accept and it < opts.min_iterations
        accept = ((e_new < e) | forced) & ok
        ptol = (pose_sq + d_sq) < opts.parameter_tolerance * (
            torch.sum(eps_new * eps_new) + opts.parameter_tolerance)
        done_new = ftol | (accept & ptol)
        if opts.force_accept:
            done_new = done_new | ~accept
        accept, done = (bool(v) for v in torch.stack([accept, done_new]).tolist())
        if accept:
            eps, idepth, status = eps_new, idepth_new, ev_new.status_candidate
            e, n, ev = e_new, n_new, ev_new
            lam = lam / opts.reg_decrease
        else:
            lam = lam * opts.reg_increase
        fej_stale = accept and ledger_empty and not done
        if fej_stale:
            t_new = SE3(tq, tt) @ SE3.exp(eps[:, :6])
            tq, tt, ab0 = t_new.q, t_new.t, ab0 + eps[:, 6:]
            lin_idepth = idepth
            eps = torch.zeros_like(eps)
        it += 1

    out = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0, eps=eps,
                         lm_idepth=idepth, res_status=status)
    out = _relinearize_last(out)
    st, baseline, inliers, outlier, opt_count = _point_status_kernel(out, model, opts)
    out = out.replace(res_status=st, lm_baseline=baseline, lm_inliers=inliers,
                      lm_outlier=outlier, lm_opt_count=opt_count)
    return out, e, n


def _relinearize_last(window: Window) -> Window:
    """Fold the newest frame's increment into its linearization point."""
    newest = newest_slot(window)
    sel = (torch.arange(window.num_slots, device=newest.device) == newest)[:, None]
    t_new = window.t_lin() @ SE3.exp(window.eps[:, :6])
    return window.replace(
        t_lin_q=torch.where(sel, t_new.q, window.t_lin_q),
        t_lin_t=torch.where(sel, t_new.t, window.t_lin_t),
        affine0=torch.where(sel, window.affine0 + window.eps[:, 6:], window.affine0),
        eps=torch.where(sel, torch.zeros_like(window.eps), window.eps))


def _point_status_kernel(window: Window, model, opts: PBAOptions):
    """Outlier threshold (75th percentile + σ²/2), statuses, baselines,
    inlier and optimization counts."""
    lm_mask = active_lm_mask(window)
    ev = _evaluate(window, model, window.eps, window.lm_idepth, lm_mask, opts)
    e, ok = ev.energy_patch, ev.ok
    flat = torch.where(ok, e, torch.full_like(e, float("nan"))).reshape(-1)
    q75 = torch.nanquantile(flat, 0.75)
    thresh = torch.where(torch.isnan(q75), torch.zeros_like(q75), q75) + 0.5 * opts.huber_sigma ** 2
    new_status = torch.where(ok & (e > thresh), RES_OUTLIER, ev.status_candidate).to(torch.int32)
    still_ok = ok & (e <= thresh)
    pt = window.poses().t
    dist = torch.linalg.vector_norm(pt[:, None, :] - pt[None, :, :], dim=-1)
    rel = torch.where(still_ok, window.lm_idepth[:, None, :] * dist[:, :, None],
                      torch.zeros_like(e))
    baseline = torch.maximum(window.lm_baseline, torch.max(rel, dim=1).values)
    inliers = torch.sum(still_ok, dim=1, dtype=torch.int32)
    outlier = window.lm_outlier | (lm_mask & (inliers < opts.min_valid_reprojections))
    opt_count = window.lm_opt_count + (inliers > 0).to(torch.int32)
    return new_status, baseline, inliers, outlier, opt_count


def _marg_system_kernel(window: Window, model, opts: PBAOptions):
    """H/b/E of the flagged landmarks at the current state (FEJ Jacobians),
    minus their Schur complement and without the priors."""
    fej = _fej_cache(window, model)
    lm_mask = window.lm_marg_flag & window.lm_valid & window.frame_valid[:, None]
    ev = _evaluate(window, model, window.eps, window.lm_idepth, lm_mask, opts)
    sys = _linearize_from_ev(window, fej, ev, window.eps, opts, marg_pass=True)
    h_pr, b_pr = _prior_system(window, window.eps, opts, marg_pass=True)
    return (sys.h_pose - h_pr - sys.h_schur, sys.b_pose - b_pr - sys.b_schur,
            torch.sum(ev.energy_patch))


def _permute_window(window: Window, perm, drop_marg) -> Window:
    """Compact frame slots by ``perm`` (kept frames first)."""
    keep = ~drop_marg[perm]
    valid = window.frame_valid[perm] & keep
    return window.replace(
        t_lin_q=window.t_lin_q[perm], t_lin_t=window.t_lin_t[perm],
        affine0=window.affine0[perm], eps=window.eps[perm],
        exposure=window.exposure[perm], frame_valid=valid,
        frame_fixed=window.frame_fixed[perm] & keep,
        frame_marg=torch.zeros_like(window.frame_marg),
        frame_id=torch.where(valid, window.frame_id[perm], -1).to(torch.int32),
        lm_uv=window.lm_uv[perm], lm_patch=window.lm_patch[perm],
        lm_idepth=window.lm_idepth[perm],
        lm_valid=window.lm_valid[perm] & keep[:, None],
        lm_marg_flag=torch.zeros_like(window.lm_marg_flag),
        lm_outlier=window.lm_outlier[perm], lm_inliers=window.lm_inliers[perm],
        lm_opt_count=window.lm_opt_count[perm], lm_baseline=window.lm_baseline[perm],
        res_status=window.res_status[perm][:, perm], maps=window.maps[perm])


def _marginalize_device(window: Window, model, perm, opts: PBAOptions) -> Window:
    """Fold flagged landmarks and frames into the float64 ledger, then
    compact the frame slots by ``perm``.

    Landmarks: H_m += H_pts, b_m += b_pts − H_pts·ε, E_m += E + εᵀH_ptsε −
    εᵀb_pts (DSO eq 8.15).  Frames: their priors are folded, then their
    blocks are Schur-eliminated (pseudo-inverse + one Newton step)."""
    ld = LEDGER_DTYPE
    s = window.eps.reshape(-1).to(ld)
    h_pts, b_pts, e_land = _marg_system_kernel(window, model, opts)
    h_pts = h_pts.to(ld)
    h_pts = 0.5 * (h_pts + h_pts.T)
    b_pts = b_pts.to(ld)
    e_m = window.energy_marg + ((e_land.to(ld) + s @ (h_pts @ s)) - s @ b_pts)
    h_m = window.h_marg + h_pts
    b_m = window.b_marg + (b_pts - h_pts @ s)
    window = window.replace(lm_valid=window.lm_valid & ~window.lm_marg_flag,
                            lm_marg_flag=torch.zeros_like(window.lm_marg_flag))

    h_pr, b_pr = _prior_system(window, window.eps, opts, marg_pass=True)
    h_pr, b_pr = h_pr.to(ld), b_pr.to(ld)
    h_m = h_m + h_pr
    b_m = b_m + (b_pr - h_pr @ s)
    kb = window.num_slots * BLOCK
    marg = torch.repeat_interleave(window.frame_marg & window.frame_valid, BLOCK)
    keep = torch.repeat_interleave(window.frame_valid & ~window.frame_marg, BLOCK)
    eye = torch.eye(kb, dtype=ld, device=h_m.device)
    zero = torch.zeros_like(h_m)
    h_ee = torch.where(marg[:, None] & marg[None, :], h_m, eye)
    x0 = pinv_hermitian(h_ee)
    h_ee_inv = x0 + x0 @ (eye - h_ee @ x0)
    h_ke = torch.where(keep[:, None] & marg[None, :], h_m, zero)
    corr = h_ke @ h_ee_inv
    h_kk = torch.where(keep[:, None] & keep[None, :], h_m, zero) - corr @ h_ke.T
    b_e = torch.where(marg, b_m, torch.zeros_like(b_m))
    b_k = torch.where(keep, b_m, torch.zeros_like(b_m)) - corr @ b_e
    h_kk = 0.5 * (h_kk + h_kk.T)
    idx = (perm[:, None] * BLOCK + torch.arange(BLOCK, device=perm.device)[None, :]).reshape(-1)
    window = _permute_window(window, perm, window.frame_marg & window.frame_valid)
    return window.replace(h_marg=h_kk[idx][:, idx], b_marg=b_k[idx], energy_marg=e_m)


def push_frame_slot(window: Window, slot: int, pose_q, pose_t, affine, exposure,
                    fixed: bool, frame_id: int, pixel_map) -> Window:
    """Insert a keyframe with no landmarks into ``slot`` (pushFrame)."""
    def put(x, v):
        x = x.clone()
        x[slot] = v
        return x

    status = window.res_status.clone()
    status[slot, :, :] = RES_OK
    status[:, slot, :] = RES_OK
    return window.replace(
        t_lin_q=put(window.t_lin_q, pose_q), t_lin_t=put(window.t_lin_t, pose_t),
        affine0=put(window.affine0, affine), eps=put(window.eps, 0.0),
        exposure=put(window.exposure, exposure),
        frame_valid=put(window.frame_valid, True),
        frame_fixed=put(window.frame_fixed, fixed),
        frame_id=put(window.frame_id, frame_id),
        lm_uv=put(window.lm_uv, 0.0), lm_patch=put(window.lm_patch, 0.0),
        lm_idepth=put(window.lm_idepth, 0.0), lm_valid=put(window.lm_valid, False),
        lm_outlier=put(window.lm_outlier, False), lm_inliers=put(window.lm_inliers, 0),
        lm_opt_count=put(window.lm_opt_count, 0),
        lm_baseline=put(window.lm_baseline, 0.0), res_status=status,
        maps=put(window.maps, pixel_map))
