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

Seven functions have a hand-written CUDA kernel beside their plain PyTorch
version and dispatch on ``window.maps.is_cuda``: :func:`_fej_cache` (K6,
``csrc/ba_fej.cu``), :func:`_evaluate` (K7, ``csrc/ba_evaluate.cu``),
:func:`_linearize_from_ev` (K8, ``csrc/ba_linearize.cu``),
:func:`_solve_step` (K9, ``csrc/ba_solve.cu``), :func:`_solve_loop_device`
(K10, ``csrc/ba_lm.cu``), :func:`_point_status_kernel` (K11,
``csrc/ba_status.cu``) and the ledger fold of :func:`_marginalize_device`
(K15, ``csrc/marg_fold.cu``).  CUDA tensors go to the kernel or raise; the
plain versions run on CPU tensors only.

On the card the LM loop keeps its state — energy, count, regularizer,
iteration, accept / done / relinearize flags — in eight words of device
memory (``LM_*`` below, ``csrc/ba_lm_state.cuh``).  The host launches
``opts.max_iterations`` iterations unconditionally and reads nothing; K6–K9
take the state and return at once when the loop is done.
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
from dsopp_tpu_torch.solvers.linear import pinv_hermitian, pinv_rtol, solve
from dsopp_tpu_torch.solvers.measure import huber_energy_weight

RES_OK = 0
RES_OOB = 1
RES_OUTLIER = 2

BLOCK = 8  # per-frame state: 6 pose + 2 affine
LEDGER_DTYPE = torch.float64

# words of the LM loop's device state (csrc/ba_lm_state.cuh); energy and
# regularizer are float bits
(LM_ENERGY, LM_LAMBDA, LM_COUNT, LM_ITER, LM_ACCEPT, LM_DONE, LM_RELIN,
 LM_LEDGER_EMPTY) = range(8)
LM_FIELDS = 8
# frame slots the kernels take: K8, K10 and K11 stage 8k-wide rows in the 48
# KB of shared memory a block gets without opting in; K9 holds the 8k x 8k
# system as f64 in the 227 KB a Hopper block can opt in to
_LINEARIZE_MAX_FRAMES = 40
_SOLVE_MAX_FRAMES = 21


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


def _fej_cache_cuda(window: Window, model, lm_state=None, out: FEJCache = None) -> FEJCache:
    """Kernel K6: same outputs as :func:`_fej_cache_plain`.  Inside the LM
    loop ``lm_state`` is the loop's state and ``out`` the carried cache,
    rewritten only when the last step relinearized."""
    k, n, _, _ = _check_window(window)
    if out is None:
        kw = dict(dtype=window.eps.dtype, device=window.eps.device)
        out = FEJCache(torch.empty((k, k, n, 8, 2, 6), **kw),
                       torch.empty((k, k, n, 8, 2, 6), **kw),
                       torch.empty((k, k, n, 8, 2), **kw), torch.empty((k, k, n, 8), **kw),
                       torch.empty((k, k), **kw),
                       torch.empty((k, k, n), dtype=torch.bool, device=window.eps.device))
    kernels.BA_FEJ(window.t_lin_q, window.t_lin_t, window.affine0, window.exposure,
                   window.lm_uv, window.lm_idepth, window.lm_patch, k, n,
                   model.fx, model.fy, model.cx, model.cy, model.width, model.height,
                   lm_state, *out)
    return out


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


def _evaluation_buffers(k: int, n: int, dtype, device) -> Evaluation:
    kw = dict(dtype=dtype, device=device)
    return Evaluation(torch.empty((k, k, n, 8), **kw), torch.empty((k, k, n), **kw),
                      torch.empty((k, k, n), **kw),
                      torch.empty((k, k, n), dtype=torch.int32, device=device),
                      torch.empty((k, k, n, 8), **kw), torch.empty((k, k, n, 8), **kw),
                      torch.empty((k, k, n), dtype=torch.bool, device=device))


def _evaluate_cuda(window: Window, model, eps, idepth, lm_mask,
                   opts: PBAOptions, lm_state=None, out: Evaluation = None) -> Evaluation:
    """Kernel K7: same outputs as :func:`_evaluate_plain`, into ``out`` where
    given.  With the LM loop's state the kernel leaves the outputs unwritten
    once the loop is done."""
    k, n, h, w = _check_window(window)
    check = kernels.check
    check(eps, "eps", (k, BLOCK))
    check(idepth, "idepth", (k, n))
    check(lm_mask, "lm_mask", (k, n), torch.bool)
    check(window.frame_valid, "frame_valid", (k,), torch.bool)
    check(window.res_status, "res_status", (k, k, n), torch.int32)
    if out is None:
        out = _evaluation_buffers(k, n, eps.dtype, eps.device)
    # the intensity image of frame f is channel 0 of maps[f]
    kernels.BA_EVALUATE(window.t_lin_q, window.t_lin_t, eps, window.affine0,
                        window.exposure, window.lm_uv, idepth, window.lm_patch, lm_mask,
                        window.frame_valid, window.res_status, window.maps, 3 * h * w,
                        k, n, h, w, model.fx, model.fy, model.cx, model.cy, model.width,
                        model.height, float(opts.huber_sigma), lm_state, *out)
    return out


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


def _linearize_buffers(k: int, n: int, dtype, device):
    """What kernel K8 writes → (its scratch (pair_part, lm_part, schur_part),
    its outputs)."""
    kb = k * BLOCK
    kw = dict(dtype=dtype, device=device)
    tiles = -(-n // _LINEARIZE_TILE_LM)
    lm_blocks = -(-(k * n) // _LINEARIZE_CHUNK_LM)
    scratch = (torch.empty((k * k * tiles, 16 * 16 + 16), dtype=torch.float64, device=device),
               torch.empty((k * k * n, 18), **kw),
               torch.empty((lm_blocks, kb * kb + kb), dtype=torch.float64, device=device))
    out = LinearSystem(torch.empty((kb, kb), **kw), torch.empty((kb,), **kw),
                       torch.empty((kb, kb), **kw), torch.empty((kb,), **kw),
                       torch.empty((k, n, k, BLOCK), **kw), torch.empty((k, n), **kw),
                       torch.empty((k, n), **kw))
    return scratch, out


def _linearize_from_ev_cuda(window: Window, fej: FEJCache, ev: Evaluation, eps,
                            opts: PBAOptions, marg_pass: bool = False,
                            lm_state=None, buffers=None) -> LinearSystem:
    """Kernel K8: same outputs as :func:`_linearize_from_ev_plain`, the
    diagonal priors included, into ``buffers`` (of :func:`_linearize_buffers`)
    where given.  With the LM loop's state the kernels leave the outputs
    unwritten once the loop is done."""
    k, n = window.num_slots, window.num_landmark_slots
    if k > _LINEARIZE_MAX_FRAMES:
        raise ValueError(f"ba_linearize_schur: {k} frame slots exceed the kernel's limit of "
                         f"{_LINEARIZE_MAX_FRAMES} (32 rows of 8k + 1 floats in 48 KB of "
                         "shared memory)")
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
    check(eps, "eps", (k, BLOCK))
    check(window.affine0, "affine0", (k, 2))
    check(window.frame_valid, "frame_valid", (k,), torch.bool)
    check(window.frame_fixed, "frame_fixed", (k,), torch.bool)
    check(window.frame_marg, "frame_marg", (k,), torch.bool)
    scratch, out = buffers or _linearize_buffers(k, n, eps.dtype, eps.device)
    kernels.BA_LINEARIZE(fej.d_uv_ref, fej.d_uv_tgt, fej.d_uv_idepth, fej.corrected_ref,
                         fej.scale0, fej.geom_valid, ev.residuals, ev.weight, ev.gx, ev.gy,
                         ev.ok, eps, window.affine0, window.frame_valid, window.frame_fixed,
                         window.frame_marg, k, n, int(bool(marg_pass)),
                         float(opts.idepth_nullspace_threshold),
                         float(opts.scale_nullspace_reg), float(opts.fixed_reg),
                         float(opts.affine_reg_a), float(opts.affine_reg_b),
                         scratch[0].shape[0] // (k * k), scratch[2].shape[0], lm_state,
                         *scratch, *out)
    return out


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


def _assemble_step_system(window: Window, sys: LinearSystem, eps, lam):
    """The damped, Schur-reduced pose system of one LM step → (H, b, live):
    ledger product in float64, identity rows on dead frame slots."""
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
    return h_full, torch.where(live, b_full, torch.zeros_like(b_full)), live


def _solve_step_plain(window: Window, sys: LinearSystem, eps, idepth, lam, opts: PBAOptions):
    """LM step → (eps', idepth', |pose step|², |idepth step|²)."""
    k = window.num_slots
    h_full, b_full, live = _assemble_step_system(window, sys, eps, lam)
    step = -solve(h_full, b_full)
    step = torch.where(torch.isfinite(step) & live, step, torch.zeros_like(step))
    step_pose = step.reshape(k, BLOCK)
    d_step = -(sys.b_d + torch.einsum("inja,ja->in", sys.hpd, step_pose)) * sys.inv_hdd / (1.0 + lam)
    d_step = torch.where(torch.isfinite(d_step), d_step, torch.zeros_like(d_step))
    return (eps + step_pose, idepth + d_step, torch.sum(step * step),
            torch.sum(d_step * d_step))


# landmarks per block of csrc/ba_solve.cu's back-substitution (kBackWarps)
_BACKSUB_BLOCK_LM = 8


def _solve_step_buffers(k: int, n: int, dtype, device):
    """What kernel K9 writes: its scratch (step, d_part), then eps', idepth'
    and step_sq [2]."""
    kw = dict(dtype=dtype, device=device)
    blocks = -(-(k * n) // _BACKSUB_BLOCK_LM)
    return (torch.empty((k * BLOCK,), **kw), torch.empty((blocks,), **kw),
            torch.empty((k, BLOCK), **kw), torch.empty((k, n), **kw), torch.empty((2,), **kw))


def _solve_step_launch(window: Window, sys: LinearSystem, eps, idepth, lam, lm_state,
                       buffers=None):
    """Kernel K9 → (eps', idepth', step_sq [2]), in ``buffers`` (of
    :func:`_solve_step_buffers`) where given.  ``lam`` is a host float, or
    ``None`` with ``lm_state``: the loop state's regularizer."""
    k, n = window.num_slots, window.num_landmark_slots
    if k > _SOLVE_MAX_FRAMES:
        raise ValueError(f"ba_solve_step: {k} frame slots exceed the kernel's limit of "
                         f"{_SOLVE_MAX_FRAMES} (the 8k x 8k system in the 227 KB of shared "
                         "memory of one block)")
    kb = k * BLOCK
    check = kernels.check
    check(sys.h_pose, "h_pose", (kb, kb))
    check(sys.b_pose, "b_pose", (kb,))
    check(sys.h_schur, "h_schur", (kb, kb))
    check(sys.b_schur, "b_schur", (kb,))
    check(sys.hpd, "hpd", (k, n, k, BLOCK))
    check(sys.inv_hdd, "inv_hdd", (k, n))
    check(sys.b_d, "b_d", (k, n))
    check(window.h_marg, "h_marg", (kb, kb), LEDGER_DTYPE)
    check(window.b_marg, "b_marg", (kb,), LEDGER_DTYPE)
    check(window.frame_valid, "frame_valid", (k,), torch.bool)
    check(eps, "eps", (k, BLOCK))
    check(idepth, "idepth", (k, n))
    step, d_part, eps_new, idepth_new, step_sq = \
        buffers or _solve_step_buffers(k, n, eps.dtype, eps.device)
    kernels.BA_SOLVE(sys.h_pose, sys.b_pose, sys.h_schur, sys.b_schur, window.h_marg,
                     window.b_marg, eps, idepth, window.frame_valid, sys.hpd, sys.inv_hdd,
                     sys.b_d, k, n, 0.0 if lam is None else float(lam), d_part.shape[0],
                     lm_state, step, d_part, eps_new, idepth_new, step_sq)
    return eps_new, idepth_new, step_sq


def _solve_step_cuda(window: Window, sys: LinearSystem, eps, idepth, lam, opts: PBAOptions):
    """Kernel K9: same outputs as :func:`_solve_step_plain`."""
    eps_new, idepth_new, step_sq = _solve_step_launch(window, sys, eps, idepth, lam, None)
    return eps_new, idepth_new, step_sq[0], step_sq[1]


def _solve_step(window: Window, sys: LinearSystem, eps, idepth, lam, opts: PBAOptions):
    """LM step from an assembled system: the kernel K9 on CUDA tensors, the
    plain version on CPU ones."""
    fn = _solve_step_cuda if window.maps.is_cuda else _solve_step_plain
    return fn(window, sys, eps, idepth, lam, opts)


def _lm_decide_plain(window: Window, ev_new: Evaluation, eps_new, pose_sq, d_sq, e, it: int,
                     opts: PBAOptions):
    """The decision of LM iteration ``it`` on a trial → (accept, done, energy,
    num_valid of the trial).  Reads the two flags on the host."""
    e_new, n_new = _energy_from_ev(window, ev_new, eps_new, opts)
    ftol = torch.abs(e - e_new) / torch.clamp(e, min=1e-30) < opts.function_tolerance
    ok = (n_new > 0) & torch.isfinite(e_new)
    forced = opts.force_accept and it < opts.min_iterations
    accept = ((e_new < e) | forced) & ok
    ptol = (pose_sq + d_sq) < opts.parameter_tolerance * (
        torch.sum(eps_new * eps_new) + opts.parameter_tolerance)
    done = ftol | (accept & ptol)
    if opts.force_accept:
        done = done | ~accept
    accept, done = (bool(v) for v in torch.stack([accept, done]).tolist())
    return accept, done, e_new, n_new


def _solve_loop_plain(window: Window, model, opts: PBAOptions, log: list = None):
    """The windowed LM solve → (window', energy, num_valid), driven from the
    host.

    Force-accept for the first ``min_iterations``; candidate statuses commit
    on accept; while the ledger is empty every accepted step is folded into
    the linearization point (fresh FEJ next iteration).  The loop reads its
    accept/done flags on the host; its parts are the dispatchers (kernels on
    CUDA tensors).  ``log`` receives the loop state after the initial
    evaluation and after every iteration, as :func:`lm_log_rows` gives it
    for the device loop."""
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

    def record(accept):
        if log is not None:
            log.append(dict(energy=float(e), lam=float(lam), count=int(n), it=it,
                            accept=accept, done=done, relin=fej_stale))

    record(False)
    while it < opts.max_iterations and not done:
        win = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0,
                             lm_idepth=lin_idepth, res_status=status)
        if fej_stale:
            fej = _fej_cache(win, model)
        sys = _linearize_from_ev(win, fej, ev, eps, opts)
        eps_new, idepth_new, pose_sq, d_sq = _solve_step(win, sys, eps, idepth, lam, opts)
        ev_new = _evaluate(win, model, eps_new, idepth_new, lm_mask, opts)
        accept, done, e_new, n_new = _lm_decide_plain(win, ev_new, eps_new, pose_sq, d_sq, e,
                                                      it, opts)
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
        record(accept)

    out = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0, eps=eps,
                         lm_idepth=idepth, res_status=status)
    out = _relinearize_last(out)
    return _with_point_status(out, _point_status_kernel(out, model, opts)), e, n


def _lm_phase(phase: int, row: int, window: Window, opts: PBAOptions, trial_eps,
              trial_idepth, step_sq, trial: Evaluation, carried, ev: Evaluation, state,
              lm_log):
    """One launch of kernel K10 (``csrc/ba_lm.cu``): phase 0 initialises the
    loop state from the initial evaluation, 1 decides on a trial and commits
    it, 2 folds the newest frame's increment.  ``carried`` = (t_lin_q,
    t_lin_t, affine0, eps, idepth, lin_idepth, res_status), updated in
    place, as is the carried evaluation ``ev``."""
    k, n = window.num_slots, window.num_landmark_slots
    kernels.BA_LM(phase, row, k, n, int(opts.min_iterations), int(bool(opts.force_accept)),
                  float(opts.initial_regularizer), float(opts.function_tolerance),
                  float(opts.parameter_tolerance), float(opts.reg_decrease),
                  float(opts.reg_increase), float(opts.affine_reg_a), float(opts.affine_reg_b),
                  window.frame_valid, window.h_marg, window.b_marg, window.energy_marg,
                  trial_eps, trial_idepth, step_sq, *trial, *carried, *ev, state, lm_log)


def _carried_state(window: Window):
    """What the device-resident loop carries and K10 updates in place →
    ((t_lin_q, t_lin_t, affine0, eps, idepth, lin_idepth, res_status), the
    window at the carried linearization point, which sees the updates)."""
    carried = tuple(x.clone() for x in (
        window.t_lin_q, window.t_lin_t, window.affine0, window.eps, window.lm_idepth,
        window.lm_idepth, window.res_status))
    tq, tt, ab0, _, _, lin_idepth, status = carried
    return carried, window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0, lm_idepth=lin_idepth,
                                   res_status=status)


def _solve_loop_cuda(window: Window, model, opts: PBAOptions, log: list = None):
    """Kernels K6–K11 under K10's control: the same solve as
    :func:`_solve_loop_plain` without a host read.  ``opts.max_iterations``
    iterations are launched whatever happens; the loop's state lives on the
    device and the kernels return at once when it says done.  ``log``
    (diagnostics only: it reads the device) receives the decoded state log."""
    k, n, _, _ = _check_window(window)
    if k > _LINEARIZE_MAX_FRAMES:
        raise ValueError(f"ba_lm: {k} frame slots exceed the kernel's limit of "
                         f"{_LINEARIZE_MAX_FRAMES}")
    check = kernels.check
    check(window.eps, "eps", (k, BLOCK))
    check(window.res_status, "res_status", (k, k, n), torch.int32)
    check(window.energy_marg, "energy_marg", (), LEDGER_DTYPE)
    dev = window.eps.device
    lm_mask = active_lm_mask(window)
    state = torch.zeros(LM_FIELDS, dtype=torch.int32, device=dev)
    lm_log = torch.zeros((opts.max_iterations + 2, LM_FIELDS), dtype=torch.int32, device=dev)
    carried, win = _carried_state(window)
    tq, tt, ab0, eps, idepth, lin_idepth, status = carried
    ev = _evaluate_cuda(win, model, eps, idepth, lm_mask, opts)
    fej = _fej_cache_cuda(win, model)
    _lm_phase(0, 0, win, opts, eps, idepth, None, ev, carried, ev, state, lm_log)
    # every iteration writes the same system, step and trial evaluation
    sys_buffers = _linearize_buffers(k, n, eps.dtype, dev)
    step_buffers = _solve_step_buffers(k, n, eps.dtype, dev)
    ev_new = _evaluation_buffers(k, n, eps.dtype, dev)
    for it in range(1, opts.max_iterations + 1):
        _fej_cache_cuda(win, model, lm_state=state, out=fej)
        sys = _linearize_from_ev_cuda(win, fej, ev, eps, opts, lm_state=state,
                                      buffers=sys_buffers)
        eps_new, idepth_new, step_sq = _solve_step_launch(win, sys, eps, idepth, None, state,
                                                          buffers=step_buffers)
        _evaluate_cuda(win, model, eps_new, idepth_new, lm_mask, opts, lm_state=state,
                       out=ev_new)
        _lm_phase(1, it, win, opts, eps_new, idepth_new, step_sq, ev_new, carried, ev, state,
                  lm_log)
    _lm_phase(2, opts.max_iterations + 1, win, opts, eps, idepth, None, ev, carried, ev, state,
              lm_log)
    if log is not None:
        log.extend(lm_log_rows(lm_log))
    out = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0, eps=eps, lm_idepth=idepth,
                         res_status=status)
    out = _with_point_status(out, _point_status_cuda(out, model, opts))
    return out, state[LM_ENERGY:LM_ENERGY + 1].view(torch.float32)[0], state[LM_COUNT]


def lm_log_rows(lm_log) -> list:
    """The device loop's state log (int32 [rows, 8]) → one dict for the initial
    state and one for every iteration that ran, as :func:`_solve_loop_plain`
    logs them.  Reads the device."""
    rows, last_it = [], -1
    for words in lm_log.cpu():
        it = int(words[LM_ITER])
        if it == last_it:
            continue          # written after the loop was done, or by the finish phase
        last_it = it
        e, lam = words[[LM_ENERGY, LM_LAMBDA]].view(torch.float32).tolist()
        rows.append(dict(energy=e, lam=lam, count=int(words[LM_COUNT]), it=it,
                         accept=bool(words[LM_ACCEPT]), done=bool(words[LM_DONE]),
                         relin=bool(words[LM_RELIN])))
    return rows


def _solve_loop_device(window: Window, model, opts: PBAOptions):
    """The windowed LM solve → (window', energy, num_valid): kernels K6–K11
    without a host read on CUDA tensors, the host-driven plain loop on CPU
    ones."""
    fn = _solve_loop_cuda if window.maps.is_cuda else _solve_loop_plain
    return fn(window, model, opts)


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


class PointStatus(NamedTuple):
    res_status: torch.Tensor    # [K,K,N] int32
    lm_baseline: torch.Tensor   # [K,N]
    lm_inliers: torch.Tensor    # [K,N] int32
    lm_outlier: torch.Tensor    # [K,N] bool
    lm_opt_count: torch.Tensor  # [K,N] int32
    threshold: torch.Tensor     # [] the outlier threshold on patch energies


OUTLIER_QUANTILE = 0.75


def _with_point_status(window: Window, ps: PointStatus) -> Window:
    return window.replace(res_status=ps.res_status, lm_baseline=ps.lm_baseline,
                          lm_inliers=ps.lm_inliers, lm_outlier=ps.lm_outlier,
                          lm_opt_count=ps.lm_opt_count)


def _point_status_from_ev_plain(window: Window, ev: Evaluation, lm_mask,
                                opts: PBAOptions) -> PointStatus:
    """Outlier threshold (75th percentile + σ²/2), statuses, baselines,
    inlier and optimization counts from an evaluation at the window's state."""
    e, ok = ev.energy_patch, ev.ok
    flat = torch.where(ok, e, torch.full_like(e, float("nan"))).reshape(-1)
    q75 = torch.nanquantile(flat, OUTLIER_QUANTILE)
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
    return PointStatus(new_status, baseline, inliers, outlier, opt_count, thresh)


def _point_status_plain(window: Window, model, opts: PBAOptions) -> PointStatus:
    lm_mask = active_lm_mask(window)
    ev = _evaluate_plain(window, model, window.eps, window.lm_idepth, lm_mask, opts)
    return _point_status_from_ev_plain(window, ev, lm_mask, opts)


def _point_status_from_ev_cuda(window: Window, ev: Evaluation, lm_mask,
                               opts: PBAOptions) -> PointStatus:
    """Kernel K11: same outputs as :func:`_point_status_from_ev_plain`."""
    k, n, _, _ = _check_window(window)
    if k > _LINEARIZE_MAX_FRAMES:
        raise ValueError(f"ba_point_status: {k} frame slots exceed the kernel's limit of "
                         f"{_LINEARIZE_MAX_FRAMES}")
    check = kernels.check
    check(window.eps, "eps", (k, BLOCK))
    check(window.lm_baseline, "lm_baseline", (k, n))
    check(window.lm_outlier, "lm_outlier", (k, n), torch.bool)
    check(window.lm_opt_count, "lm_opt_count", (k, n), torch.int32)
    check(ev.energy_patch, "energy_patch", (k, k, n))
    check(ev.ok, "ok", (k, k, n), torch.bool)
    check(ev.status_candidate, "status_candidate", (k, k, n), torch.int32)
    check(lm_mask, "lm_mask", (k, n), torch.bool)
    dev = window.eps.device
    thresh = torch.empty((1,), dtype=window.eps.dtype, device=dev)
    new_status = torch.empty((k, k, n), dtype=torch.int32, device=dev)
    baseline = torch.empty((k, n), dtype=window.eps.dtype, device=dev)
    inliers = torch.empty((k, n), dtype=torch.int32, device=dev)
    outlier = torch.empty((k, n), dtype=torch.bool, device=dev)
    opt_count = torch.empty((k, n), dtype=torch.int32, device=dev)
    kernels.BA_STATUS(ev.energy_patch, ev.ok, ev.status_candidate, window.t_lin_q,
                      window.t_lin_t, window.eps, window.lm_idepth, lm_mask,
                      window.lm_baseline, window.lm_outlier, window.lm_opt_count, k, n,
                      OUTLIER_QUANTILE, float(opts.huber_sigma),
                      int(opts.min_valid_reprojections), thresh, new_status, baseline, inliers,
                      outlier, opt_count)
    return PointStatus(new_status, baseline, inliers, outlier, opt_count, thresh[0])


def _point_status_cuda(window: Window, model, opts: PBAOptions) -> PointStatus:
    lm_mask = active_lm_mask(window)
    ev = _evaluate_cuda(window, model, window.eps, window.lm_idepth, lm_mask, opts)
    return _point_status_from_ev_cuda(window, ev, lm_mask, opts)


def _point_status_kernel(window: Window, model, opts: PBAOptions) -> PointStatus:
    """Point statuses after a solve: the kernels K7 + K11 on CUDA tensors,
    the plain version on CPU ones."""
    fn = _point_status_cuda if window.maps.is_cuda else _point_status_plain
    return fn(window, model, opts)


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


def _marginalize_plain(window: Window, h_pts, b_pts, e_land, perm, opts: PBAOptions,
                       pinv=None):
    """The ledger fold of a marginalization → the new (H_m, b_m, E_m), float64.

    ``h_pts``, ``b_pts``, ``e_land``: the flagged landmarks' system
    (:func:`_marg_system_kernel`); ``pinv``: the pseudo-inverse of the
    identity-padded flagged block (by default the reference's, whose cutoff
    follows the window's working precision: it inverts in f32 in an f32
    run, and drops the eigenvalues below f32's cutoff).  Landmarks: H_m += H_pts, b_m += b_pts −
    H_pts·ε, E_m += E + εᵀH_ptsε − εᵀb_pts (DSO eq 8.15).  Frames: their
    priors are folded, then their blocks are Schur-eliminated (pseudo-inverse
    + one Newton step); the kept blocks are permuted by ``perm``."""
    ld = LEDGER_DTYPE
    s = window.eps.reshape(-1).to(ld)
    h_pts = h_pts.to(ld)
    h_pts = 0.5 * (h_pts + h_pts.T)
    b_pts = b_pts.to(ld)
    e_m = window.energy_marg + ((e_land.to(ld) + s @ (h_pts @ s)) - s @ b_pts)
    h_m = window.h_marg + h_pts
    b_m = window.b_marg + (b_pts - h_pts @ s)

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
    x0 = pinv(h_ee) if pinv is not None else pinv_hermitian(h_ee, window.eps.dtype)
    h_ee_inv = x0 + x0 @ (eye - h_ee @ x0)
    h_ke = torch.where(keep[:, None] & marg[None, :], h_m, zero)
    corr = h_ke @ h_ee_inv
    h_kk = torch.where(keep[:, None] & keep[None, :], h_m, zero) - corr @ h_ke.T
    b_e = torch.where(marg, b_m, torch.zeros_like(b_m))
    b_k = torch.where(keep, b_m, torch.zeros_like(b_m)) - corr @ b_e
    h_kk = 0.5 * (h_kk + h_kk.T)
    idx = (perm[:, None] * BLOCK + torch.arange(BLOCK, device=perm.device)[None, :]).reshape(-1)
    return h_kk[idx][:, idx], b_k[idx], e_m


def _marginalize_cuda(window: Window, h_pts, b_pts, e_land, perm, opts: PBAOptions,
                      sweeps=None):
    """Kernel K15: same outputs as :func:`_marginalize_plain`, read nothing
    on the host (the number of flagged frames stays on the device).
    ``sweeps``, an int32 [1] CUDA tensor or None, receives the number of
    Jacobi sweeps that rotated: ``MARG_MAX_SWEEPS`` when the decomposition
    did not converge."""
    k = window.num_slots
    kb = k * BLOCK
    check = kernels.check
    check(h_pts, "h_pts", (kb, kb))
    check(b_pts, "b_pts", (kb,))
    check(e_land, "e_land", ())
    check(window.eps, "eps", (k, BLOCK))
    check(window.affine0, "affine0", (k, 2))
    for name in ("frame_valid", "frame_fixed", "frame_marg"):
        check(getattr(window, name), name, (k,), torch.bool)
    check(perm, "perm", (k,), torch.int64)
    check(window.h_marg, "h_marg", (kb, kb), LEDGER_DTYPE)
    check(window.b_marg, "b_marg", (kb,), LEDGER_DTYPE)
    check(window.energy_marg, "energy_marg", (), LEDGER_DTYPE)
    kw = dict(dtype=LEDGER_DTYPE, device=window.eps.device)
    h_out, b_out, e_out = (torch.empty((kb, kb), **kw), torch.empty((kb,), **kw),
                           torch.empty((), **kw))
    scratch = torch.empty((_marg_scratch_words(k),), **kw)
    if sweeps is not None:
        check(sweeps, "sweeps", (1,), torch.int32)
    kernels.MARG_FOLD(h_pts, b_pts, e_land, window.eps, window.affine0, window.frame_valid,
                      window.frame_fixed, window.frame_marg, perm, window.h_marg,
                      window.b_marg, window.energy_marg, k, pinv_rtol(kb, window.eps.dtype),
                      float(opts.fixed_reg), float(opts.affine_reg_a),
                      float(opts.affine_reg_b), scratch, h_out, b_out, e_out, sweeps)
    return h_out, b_out, e_out


MARG_MAX_SWEEPS = 40   # csrc/marg_fold.cu kMaxSweeps


def _marg_scratch_words(k: int) -> int:
    """float64 words of kernel K15's scratch (csrc/marg_fold.cu): H_m [8k, 8k],
    b_m [8k], five [n, n] matrices (the compact block, its eigenvectors, X0,
    I − H_ee X0, X) and the correction [8k, n], for n = 8(k − 1) flagged rows
    at most."""
    kb, n = k * BLOCK, (k - 1) * BLOCK
    return kb * kb + kb + 5 * n * n + kb * n


def _marginalize_device(window: Window, model, perm, opts: PBAOptions) -> Window:
    """Fold flagged landmarks and frames into the float64 ledger, then
    compact the frame slots by ``perm``: the fold is kernel K15 on CUDA
    tensors, the plain version on CPU ones.  Nothing is read on the host."""
    fold = _marginalize_cuda if window.maps.is_cuda else _marginalize_plain
    return _marginalize_with(fold, window, model, perm, opts)


def _marginalize_with(fold, window: Window, model, perm, opts: PBAOptions) -> Window:
    """:func:`_marginalize_device` with the ledger fold ``fold``
    (:func:`_marginalize_cuda` or :func:`_marginalize_plain`)."""
    h_pts, b_pts, e_land = _marg_system_kernel(window, model, opts)
    h_m, b_m, e_m = fold(window, h_pts.contiguous(), b_pts.contiguous(), e_land, perm, opts)
    window = window.replace(lm_valid=window.lm_valid & ~window.lm_marg_flag,
                            lm_marg_flag=torch.zeros_like(window.lm_marg_flag))
    window = _permute_window(window, perm, window.frame_marg & window.frame_valid)
    return window.replace(h_marg=h_m, b_marg=b_m, energy_marg=e_m)


def slot_mask(num_slots: int, slot, device):
    """[K] bool, true at frame slot ``slot``: an int, or a device tensor of
    one element, which is then never read on the host."""
    return torch.arange(num_slots, device=device) == slot


def put_slot(x, onehot, value):
    """``x`` [K, ...] with ``value`` (a scalar or a [...] tensor) at the slot
    marked in ``onehot`` [K]; a new dense tensor."""
    return torch.where(onehot.reshape((-1,) + (1,) * (x.dim() - 1)), value, x)


def push_frame_slot(window: Window, slot, pose_q, pose_t, affine, exposure,
                    fixed: bool, frame_id: int, pixel_map) -> Window:
    """Insert a keyframe with no landmarks into ``slot`` (pushFrame); ``slot``
    as :func:`slot_mask` takes it."""
    at = slot_mask(window.num_slots, slot, window.frame_valid.device)

    def put(x, v):
        return put_slot(x, at, v)

    status = torch.where(at[:, None, None] | at[None, :, None], RES_OK, window.res_status)
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
