"""Sliding-window photometric bundle adjustment (counterpart of the parts of
``dsopp_tpu/solvers/pba.py`` the tracker's main path runs).

Per-frame state ε = [6 pose | a, b], pose applied as T_lin·exp(ε); FEJ
geometric Jacobians at the linearization point; whole-patch Huber; residual
statuses Ok/OOB/Outlier committed on LM accept; LM with force-accept for the
first iterations and a constant regularizer; affine and fixed-frame priors;
a marginalization ledger (H_m, b_m, E_m) kept in float64 (the reference
keeps it in double); frames Schur-eliminated on marginalization.

The window is a fixed-shape bank of K frame slots × N landmark slots × C
channels × the 8-point pattern, residuals a dense [K_anchor, K_target, N, C,
P] tensor.  C is 1 (intensity) unless a frame embedder gives more channels:
then each keyframe's ``[3C, H, W]`` map of the embedded channels is kept in
the window's channel bank (``channel_maps``; at C = 1 the bank is ``maps``
itself), reference patches are ``[N, C·P]`` channel-major, the FEJ geometry
is per pattern point and shared by its C residuals, and the whole-patch
Huber runs on all C·P residuals at σ·√C (the JAX package's
``pba.py:257-471``).
Target values and gradients are read from the frames' channel planes with
the 10×10-window semantics of :func:`sample_window` (one window per
(anchor, target, landmark) group, based at the reprojected pattern center).

Six functions have a hand-written CUDA kernel beside their plain PyTorch
version and dispatch on ``window.maps.is_cuda``: :func:`_evaluate` (K7,
``csrc/ba_evaluate.cu``), :func:`_linearize_from_ev` (K8,
``csrc/ba_linearize.cu``), :func:`_solve_step` (K9, ``csrc/ba_solve.cu``),
:func:`_solve_loop_device` (K7–K11 under K10's control, ``csrc/ba_lm.cu``),
:func:`_point_status_kernel` (K11, ``csrc/ba_status.cu``) and the ledger fold
of :func:`_marginalize_device` (K15, ``csrc/marg_fold.cu``).  CUDA tensors go
to the kernel or raise; the plain versions run on CPU tensors only.  The FEJ
Jacobians (:func:`_fej_cache`, once kernel K6's cache) have no kernel of their
own: K8 forms them from the window where it reads them, and the plain
linearization takes them from :func:`_fej_cache_plain`.

On the card the whole solve is one C call (``csrc/ba_lm.cu::ba_solve_loop``,
:func:`_solve_loop_cuda`): it issues the fixed sequence of the JAX package's
one device program — K7, K10's init, ``opts.max_iterations`` × (K8, K9, K7,
K10), K10's finish, K7 and K11 — and reads nothing on the host.  The LM loop
keeps its state — energy, count, regularizer, iteration, accept / done /
relinearize flags, and which of its two evaluation buffers holds the carried
evaluation — in nine words of device memory (``LM_*`` below,
``csrc/ba_lm_state.cuh``); K7–K9 take the state and return at once when the
loop is done, K7 writes each trial into the buffer that does not hold the
carried evaluation, and an accepted step flips the word instead of copying.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from dsopp_tpu_torch import default_device, kernels
from dsopp_tpu_torch.core.interpolate import pad_images, sample_window, window_base
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.core.pattern import PATTERN_CENTER, PATTERN_SIZE, shift_pattern
from dsopp_tpu_torch.core.reproject import reproject, reproject_jacobian
from dsopp_tpu_torch.solvers.linear import pinv_hermitian, pinv_rtol, solve
from dsopp_tpu_torch.solvers.measure import huber_energy_weight

RES_OK = 0
RES_OOB = 1
RES_OUTLIER = 2

BLOCK = 8  # per-frame state: 6 pose + 2 affine
LEDGER_DTYPE = torch.float64

# words of the LM loop's device state (csrc/ba_lm_state.cuh); energy and
# regularizer are float bits; LM_CARRIED is the evaluation buffer (0 or 1)
# that holds the carried evaluation
(LM_ENERGY, LM_LAMBDA, LM_COUNT, LM_ITER, LM_ACCEPT, LM_DONE, LM_RELIN,
 LM_LEDGER_EMPTY, LM_CARRIED) = range(9)
LM_FIELDS = 9
# frame slots the kernels take: K8, K10 and K11 take up to 40 (K10 and K11
# stage 8k-wide rows in the 48 KB of shared memory a block gets without
# opting in, K8's Schur kernel runs a warp per 16 of its 8(k + 1) columns);
# K9 holds the 8k x 8k system as f64 in the 227 KB a Hopper block can opt in
# to
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
    lm_patch: torch.Tensor     # [K, N, C·P] channel-major
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
    # [K, 3C, H, W] level-0 maps of the embedded channels (values C | dx C |
    # dy C), stored per slot; None at C = 1, where the bank is ``maps``
    channel_maps: Optional[torch.Tensor] = None

    @property
    def channel_bank(self):
        """[K, 3C, H, W]: the maps the BA residuals sample."""
        return self.maps if self.channel_maps is None else self.channel_maps

    @property
    def num_channels(self):
        return self.channel_bank.shape[1] // 3

    @property
    def num_slots(self):
        return self.t_lin_q.shape[0]

    @property
    def num_landmark_slots(self):
        return self.lm_uv.shape[1]

    def t_lin(self) -> SE3:
        return SE3(self.t_lin_q, self.t_lin_t)

    def poses(self) -> SE3:
        """Current poses T_w_c = T_lin · exp(ε_pose) (of every sequence, on a
        window stacked with a leading [B] axis)."""
        return self.t_lin() @ SE3.exp(self.eps[..., :6])

    def affine(self):
        return self.affine0 + self.eps[..., 6:]

    def replace(self, **changes) -> "Window":
        return dataclasses.replace(self, **changes)


def empty_window(num_frames: int, num_landmarks: int, map_shape,
                 dtype=torch.float32, device=None, channels: int = 1) -> Window:
    """An empty window of ``channels`` embedder channels on ``device``
    (``None``: the CUDA card)."""
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
        lm_patch=torch.zeros((k, n, 8 * channels), **kw),
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
        channel_maps=(None if channels == 1 else
                      torch.zeros((k, 3 * channels) + tuple(map_shape[-2:]), **kw)),
    )


def frame_count(window: Window) -> int:
    """Number of valid frame slots (reads the device)."""
    return int(window.frame_valid.sum())


def newest_slot(window: Window):
    """[1] long tensor: the newest valid slot (no host read); [B, 1] on a
    window stacked with a leading [B] axis."""
    return window.frame_valid.sum(-1, keepdim=True) - 1


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
    corrected_ref: torch.Tensor  # [K,K,N,C,P]
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
    corrected = scale0[:, :, None, None, None] * (
        _patch_ref(window)[:, None] - window.affine0[:, None, None, None, None, 1])
    return FEJCache(rj.d_uv_d_eps_ref, rj.d_uv_d_eps_tgt, rj.d_uv_d_idepth,
                    corrected, scale0, torch.all(rj.valid, dim=-1))


def _patch_ref(window: Window):
    """[K, N, C, P] reference patches."""
    k, n = window.num_slots, window.num_landmark_slots
    return window.lm_patch.reshape(k, n, window.num_channels, PATTERN_SIZE)


def _check_window(window: Window, lead: tuple = ()):
    """Validate the window tensors the BA kernels read → (k, n, h, w).
    ``lead``: the leading axes of a stacked window ((B,)), none for one."""
    k, n = window.t_lin_q.shape[-2], window.lm_uv.shape[-2]
    c = window.channel_bank.shape[-3] // 3
    h, w = window.maps.shape[-2:]
    check = kernels.check
    check(window.maps, "maps", lead + (k, 3, h, w))
    check(window.channel_bank, "channel bank", lead + (k, 3 * c, h, w))
    check(window.t_lin_q, "t_lin_q", lead + (k, 4))
    check(window.t_lin_t, "t_lin_t", lead + (k, 3))
    check(window.affine0, "affine0", lead + (k, 2))
    check(window.exposure, "exposure", lead + (k,))
    check(window.lm_uv, "lm_uv", lead + (k, n, 2))
    check(window.lm_idepth, "lm_idepth", lead + (k, n))
    check(window.lm_patch, "lm_patch", lead + (k, n, 8 * c))
    return k, n, h, w


def _fej_cache(window: Window, model) -> FEJCache:
    """FEJ Jacobians at the linearization point, on CPU tensors.  On the card
    no cache exists: kernel K8 forms them where it reads them, so a CUDA
    window raises."""
    if window.maps.is_cuda:
        raise ValueError("_fej_cache: the card keeps no FEJ cache; kernel K8 "
                         "(_linearize_from_ev_cuda) forms the Jacobians itself")
    return _fej_cache_plain(window, model)


class Evaluation(NamedTuple):
    residuals: torch.Tensor     # [K,K,N,C,P]
    energy_patch: torch.Tensor  # [K,K,N]
    weight: torch.Tensor        # [K,K,N]
    status_candidate: torch.Tensor  # [K,K,N] int32
    gx: torch.Tensor            # [K,K,N,C,P]
    gy: torch.Tensor            # [K,K,N,C,P]
    ok: torch.Tensor            # [K,K,N]


def _pair_mask(window: Window):
    fv = window.frame_valid
    eye = torch.eye(window.num_slots, dtype=torch.bool, device=fv.device)
    return fv[:, None] & fv[None, :] & ~eye


def _evaluate_plain(window: Window, model, eps, idepth, lm_mask,
                    opts: PBAOptions) -> Evaluation:
    """Residuals of every (anchor i, target j, landmark n, channel c) at
    (eps, idepth): whole-patch Huber over the C·P residuals at σ·√C."""
    k, c = window.num_slots, window.num_channels
    h, w = window.maps.shape[-2:]
    t_ji = _relative_poses(window.t_lin_q, window.t_lin_t, eps[:, :6])
    affine = window.affine0 + eps[:, 6:]
    scale = _brightness_scale(window.exposure, affine)
    uv = shift_pattern(window.lm_uv)[:, None]
    d = idepth[:, None, :, None]
    t_b = SE3(t_ji.q[:, :, None, None, :], t_ji.t[:, :, None, None, :])
    rp = reproject(model, model, uv, d, t_b)                        # [K,K,N,P]
    bx, by = window_base(rp.uv[..., PATTERN_CENTER, :], h, w)       # [K,K,N]
    # channel plane ch of target j: image j * C + ch of the padded stack
    plane = (torch.arange(k, device=eps.device)[None, :, None, None, None] * c
             + torch.arange(c, device=eps.device)[:, None])             # [1,K,1,C,1]
    vals, gx, gy, inside = sample_window(
        pad_images(window.channel_bank[:, :c]), rp.uv[..., None, :, :],
        bx[..., None, None], by[..., None, None], h, w, img_idx=plane)  # [K,K,N,C,P]
    inside = inside[..., 0, :]                                      # per point
    corrected_ref = scale[:, :, None, None, None] * (
        _patch_ref(window)[:, None] - affine[:, None, None, None, None, 1])
    r = (vals - affine[None, :, None, None, None, 1]) - corrected_ref
    geom_ok = torch.all(rp.valid & inside, dim=-1)
    live = _pair_mask(window)[:, :, None] & lm_mask[:, None, :]
    candidate = torch.where(live & ~geom_ok, RES_OOB, window.res_status).to(torch.int32)
    ok = live & geom_ok & (window.res_status == RES_OK)
    r = torch.where(ok[..., None, None], r, torch.zeros_like(r))
    energy, weight = huber_energy_weight(torch.sum(r * r, dim=(-2, -1)), _huber_sigma(c, opts))
    zero = torch.zeros_like(energy)
    return Evaluation(r, torch.where(ok, energy, zero), torch.where(ok, weight, zero),
                      candidate, gx, gy, ok)


def _huber_sigma(channels: int, opts: PBAOptions) -> float:
    """The whole-patch Huber sigma of C channels, σ·√C (a host float, as the
    JAX package's)."""
    return opts.huber_sigma * float(channels) ** 0.5


def _evaluation_buffers(k: int, n: int, c: int, dtype, device, lead: tuple = ()) -> Evaluation:
    """K7's outputs (``lead``: the sequence axis of a launch of several)."""
    kw = dict(dtype=dtype, device=device)
    g = lead + (k, k, n)
    return Evaluation(torch.empty(g + (c, 8), **kw), torch.empty(g, **kw),
                      torch.empty(g, **kw), torch.empty(g, dtype=torch.int32, device=device),
                      torch.empty(g + (c, 8), **kw), torch.empty(g + (c, 8), **kw),
                      torch.empty(g, dtype=torch.bool, device=device))


def _evaluate_cuda(window: Window, model, eps, idepth, lm_mask,
                   opts: PBAOptions) -> Evaluation:
    """Kernel K7: same outputs as :func:`_evaluate_plain`, in new tensors
    (the kernel's buffer 0; inside the LM loop :func:`_solve_loop_cuda`'s C
    call launches it on two)."""
    k, n, h, w = _check_window(window)
    c = window.num_channels
    check = kernels.check
    check(eps, "eps", (k, BLOCK))
    check(idepth, "idepth", (k, n))
    check(lm_mask, "lm_mask", (k, n), torch.bool)
    check(window.frame_valid, "frame_valid", (k,), torch.bool)
    check(window.res_status, "res_status", (k, k, n), torch.int32)
    out = _evaluation_buffers(k, n, c, eps.dtype, eps.device)
    _evaluate_launch(window, model, eps, idepth, lm_mask, opts, None, out)
    return out


def _evaluate_launch(window: Window, model, eps, idepth, lm_mask, opts: PBAOptions, state,
                     ev0: Evaluation, ev1: Evaluation = None, mask=None, seqs: int = 1,
                     seq=None, state_seq=None):
    """One launch of kernel K7 on checked tensors: into ``ev0`` without the
    LM loop's ``state``; with it, into the one of ``ev0`` and ``ev1`` that
    the state does not name carried (nothing when the loop is done).
    ``mask``, where given, receives ``lm_mask & frame_valid``.  ``seqs``
    sequences (the kernel's grid z): the window's fields and ``lm_mask``
    are stacks read at ``seq``, ``eps`` and ``idepth`` at ``state_seq``
    (int32 device lists; None: each sequence's position), the outputs
    ``[seqs, ...]``."""
    k, n = window.t_lin_q.shape[-2], window.lm_uv.shape[-2]
    c = window.channel_bank.shape[-3] // 3
    h, w = window.maps.shape[-2:]
    # channel plane ch of frame f is plane ch of channel_bank[f]
    kernels.BA_EVALUATE(window.t_lin_q, window.t_lin_t, eps, window.affine0,
                        window.exposure, window.lm_uv, idepth, window.lm_patch, lm_mask,
                        window.frame_valid, window.res_status, window.channel_bank,
                        3 * c * h * w, k, n, h, w, c, model.fx, model.fy, model.cx, model.cy,
                        model.width, model.height, _huber_sigma(c, opts), state, *ev0,
                        *(ev1 or (None,) * len(ev0)), mask, seqs, seq, state_seq)


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
    landmark Schur complement.  The FEJ geometry is per pattern point, shared
    by its C residual rows; the channel axis folds into the residual axis,
    C·P rows of 8 columns, channel-major."""
    k, n = window.num_slots, window.num_landmark_slots
    w = torch.where(ev.ok & fej.geom_valid, ev.weight, torch.zeros_like(ev.weight))
    gx, gy = ev.gx, ev.gy                                           # [K,K,N,C,P]
    d_ref, d_tgt = fej.d_uv_ref[:, :, :, None], fej.d_uv_tgt[:, :, :, None]
    j_ref_pose = gx[..., None] * d_ref[..., 0, :] + gy[..., None] * d_ref[..., 1, :]
    j_tgt_pose = gx[..., None] * d_tgt[..., 0, :] + gy[..., None] * d_tgt[..., 1, :]
    ones = torch.ones_like(fej.corrected_ref)
    j_ref = torch.cat([j_ref_pose, fej.corrected_ref[..., None],
                       (fej.scale0[:, :, None, None, None] * ones)[..., None]], dim=-1)
    j_tgt = torch.cat([j_tgt_pose, -fej.corrected_ref[..., None], -ones[..., None]], dim=-1)
    j_d = (gx * fej.d_uv_idepth[:, :, :, None, :, 0]
           + gy * fej.d_uv_idepth[:, :, :, None, :, 1])
    cp = gx.shape[-2] * gx.shape[-1]
    j_ref = j_ref.reshape(k, k, n, cp, BLOCK)
    j_tgt = j_tgt.reshape(k, k, n, cp, BLOCK)
    j_d = j_d.reshape(k, k, n, cp)
    r = ev.residuals.reshape(k, k, n, cp)
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


# landmarks per pair_kernel block of csrc/ba_linearize.cu (kTileLm): it sizes
# the scratch the caller allocates
_LINEARIZE_TILE_LM = 128
_LINEARIZE_LM_OUT = 10     # kLmOut: a (pair, landmark)'s anchor term, h_dd and b_d


def _linearize_buffers(k: int, n: int, dtype, device, lead: tuple = ()):
    """What kernel K8 writes → (its scratch (pair_part, lm_part, schur_part),
    its outputs); ``lead``: the sequence axis of a launch of several.  The
    scratch is 8.4 MB a sequence at K = 17, N = 340."""
    kb = k * BLOCK
    kw = dict(dtype=dtype, device=device)
    tiles = -(-n // _LINEARIZE_TILE_LM)
    f64 = dict(dtype=torch.float64, device=device)
    scratch = (torch.empty(lead + (k * k * tiles, 16 * 16 + 16), **f64),
               torch.empty(lead + (k * k * n, _LINEARIZE_LM_OUT), **kw),
               torch.empty(lead + (k, kb * kb + kb), **f64))
    out = LinearSystem(torch.empty(lead + (kb, kb), **kw), torch.empty(lead + (kb,), **kw),
                       torch.empty(lead + (kb, kb), **kw), torch.empty(lead + (kb,), **kw),
                       torch.empty(lead + (k, n, k, BLOCK), **kw),
                       torch.empty(lead + (k, n), **kw), torch.empty(lead + (k, n), **kw))
    return scratch, out


def _linearize_from_ev_cuda(window: Window, model, ev: Evaluation, eps,
                            opts: PBAOptions, marg_pass: bool = False) -> LinearSystem:
    """Kernel K8: the outputs of :func:`_linearize_from_ev_plain` with the FEJ
    of :func:`_fej_cache_plain`, formed in the kernel from the window at its
    linearization point (``t_lin``, ``affine0``, ``exposure``, ``lm_uv``,
    ``lm_idepth``, ``lm_patch``) and the camera ``model``; the diagonal
    priors included, in new tensors (the evaluation as the kernel's buffer 0;
    inside the LM loop :func:`_solve_loop_cuda`'s C call launches it on the
    carried one of two)."""
    k, n, _, _ = _check_window(window)
    c = window.num_channels
    if k > _LINEARIZE_MAX_FRAMES:
        raise ValueError(f"ba_linearize_schur: {k} frame slots exceed the kernel's limit of "
                         f"{_LINEARIZE_MAX_FRAMES} (its Schur kernel's warps)")
    check = kernels.check
    check(ev.residuals, "residuals", (k, k, n, c, 8))
    check(ev.weight, "weight", (k, k, n))
    check(ev.gx, "gx", (k, k, n, c, 8))
    check(ev.gy, "gy", (k, k, n, c, 8))
    check(ev.ok, "ok", (k, k, n), torch.bool)
    check(eps, "eps", (k, BLOCK))
    check(window.frame_valid, "frame_valid", (k,), torch.bool)
    check(window.frame_fixed, "frame_fixed", (k,), torch.bool)
    check(window.frame_marg, "frame_marg", (k,), torch.bool)
    scratch, out = _linearize_buffers(k, n, eps.dtype, eps.device)
    _linearize_launch(window, model, ev, None, eps, opts, marg_pass, None, scratch, out)
    return out


def _linearize_launch(window: Window, model, ev0: Evaluation, ev1: Evaluation, eps,
                      opts: PBAOptions, marg_pass: bool, state, scratch, out: LinearSystem,
                      seqs: int = 1, seq=None, state_seq=None):
    """One launch of kernel K8 on checked tensors, into ``out`` (of
    :func:`_linearize_buffers`): from ``ev0`` without the LM loop's
    ``state``; with it, from the one of ``ev0`` and ``ev1`` that the state
    names carried (nothing when the loop is done).  ``seqs``, ``seq`` and
    ``state_seq`` as :func:`_evaluate_launch` takes them: the evaluation,
    the scratch and ``out`` are ``[seqs, ...]``."""
    k, n = window.t_lin_q.shape[-2], window.lm_uv.shape[-2]
    c = window.channel_bank.shape[-3] // 3
    second = (None,) * 5 if ev1 is None else (ev1.residuals, ev1.weight, ev1.gx, ev1.gy, ev1.ok)
    kernels.BA_LINEARIZE(window.t_lin_q, window.t_lin_t, window.affine0, window.exposure,
                         window.lm_uv, window.lm_idepth, window.lm_patch,
                         model.fx, model.fy, model.cx, model.cy, model.width, model.height,
                         ev0.residuals, ev0.weight, ev0.gx, ev0.gy, ev0.ok, *second, eps,
                         window.frame_valid, window.frame_fixed, window.frame_marg, k, n, c,
                         int(bool(marg_pass)), float(opts.idepth_nullspace_threshold),
                         float(opts.scale_nullspace_reg), float(opts.fixed_reg),
                         float(opts.affine_reg_a), float(opts.affine_reg_b),
                         -(-n // _LINEARIZE_TILE_LM), state, *scratch, *out, seqs, seq,
                         state_seq)


def _linearize_from_ev(window: Window, model, ev: Evaluation, eps,
                       opts: PBAOptions, marg_pass: bool = False) -> LinearSystem:
    """GN system and landmark Schur complement with the FEJ of the window's
    linearization point: the kernel K8 on CUDA tensors, the plain version on
    the plain FEJ on CPU ones."""
    if window.maps.is_cuda:
        return _linearize_from_ev_cuda(window, model, ev, eps, opts, marg_pass)
    return _linearize_from_ev_plain(window, _fej_cache_plain(window, model), ev, eps, opts,
                                    marg_pass)


def _landmark_sums(ev: Evaluation):
    """(Σ patch energies, the count of positive ones) of an evaluation: the
    part of the energy that lies in the landmark slots."""
    return torch.sum(ev.energy_patch), torch.sum(ev.energy_patch > 0)


def _total_energy(window: Window, e_land, eps, opts: PBAOptions):
    """Landmark + prior + ledger energy (ledger quadratic in float64)."""
    s = eps.reshape(-1).to(LEDGER_DTYPE)
    e_marg = (window.energy_marg + window.b_marg @ s) + 0.5 * (s @ (window.h_marg @ s))
    return e_land + _prior_energy(window, eps, opts) + e_marg.to(e_land.dtype)


def _energy_from_ev(window: Window, ev: Evaluation, eps, opts: PBAOptions):
    """Landmark + prior + ledger energy (ledger quadratic in float64) and the
    count of positive patch energies."""
    e_land, n_valid = _landmark_sums(ev)
    return _total_energy(window, e_land, eps, opts), n_valid


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


def _solve_step_scratch(k: int, n: int, dtype, device):
    """Kernel K9's scratch (step [8k], d_part [blocks], the assembled f64
    system [8k (8k + 1)])."""
    kw = dict(dtype=dtype, device=device)
    blocks = -(-(k * n) // _BACKSUB_BLOCK_LM)
    kb = k * BLOCK
    return (torch.empty((kb,), **kw), torch.empty((blocks,), **kw),
            torch.empty((kb * (kb + 1),), dtype=torch.float64, device=device))


def _solve_step_buffers(k: int, n: int, dtype, device, scratch=None):
    """What kernel K9 writes: its scratch (step, d_part, system; new unless
    given), then eps', idepth' and step_sq [2]."""
    kw = dict(dtype=dtype, device=device)
    return (*(scratch or _solve_step_scratch(k, n, dtype, device)),
            torch.empty((k, BLOCK), **kw), torch.empty((k, n), **kw), torch.empty((2,), **kw))


# K9's scratch by (k, n, dtype, device), reused by every call outside the LM
# loop: the kernels read it only after writing it, in stream order
_SOLVE_STEP_SCRATCH = {}


def _solve_step_launch(window: Window, sys: LinearSystem, eps, idepth, lam, lm_state,
                       buffers=None):
    """Kernel K9 → (eps', idepth', step_sq [2]), in ``buffers`` (of
    :func:`_solve_step_buffers`) where given.  ``lam`` is a host float, or
    ``None`` with ``lm_state``: the loop state's regularizer.  The solve
    runs K9 from C (``ba_solve_loop``); the ``lm_state`` mode is kept here
    only as the tests' entry into K9's loop-state behaviour (λ from the
    state, nothing written once the loop is done)."""
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
    step, d_part, system, eps_new, idepth_new, step_sq = \
        buffers or _solve_step_buffers(k, n, eps.dtype, eps.device)
    check(system, "system", (kb * (kb + 1),), torch.float64)
    kernels.BA_SOLVE(sys.h_pose, sys.b_pose, sys.h_schur, sys.b_schur, window.h_marg,
                     window.b_marg, eps, idepth, window.frame_valid, sys.hpd, sys.inv_hdd,
                     sys.b_d, k, n, 0.0 if lam is None else float(lam), d_part.shape[0],
                     lm_state, step, d_part, system, eps_new, idepth_new, step_sq, 1, None,
                     None)
    return eps_new, idepth_new, step_sq


def _solve_step_cuda(window: Window, sys: LinearSystem, eps, idepth, lam, opts: PBAOptions):
    """Kernel K9: same outputs as :func:`_solve_step_plain`, in new tensors
    (the scratch is kept per shape)."""
    key = (window.num_slots, window.num_landmark_slots, eps.dtype, eps.device)
    if key not in _SOLVE_STEP_SCRATCH:
        _SOLVE_STEP_SCRATCH[key] = _solve_step_scratch(*key)
    buffers = _solve_step_buffers(*key, scratch=_SOLVE_STEP_SCRATCH[key])
    eps_new, idepth_new, step_sq = _solve_step_launch(window, sys, eps, idepth, lam, None,
                                                      buffers)
    return eps_new, idepth_new, step_sq[0], step_sq[1]


def _solve_step(window: Window, sys: LinearSystem, eps, idepth, lam, opts: PBAOptions):
    """LM step from an assembled system: the kernel K9 on CUDA tensors, the
    plain version on CPU ones."""
    fn = _solve_step_cuda if window.maps.is_cuda else _solve_step_plain
    return fn(window, sys, eps, idepth, lam, opts)


def _without_prior(opts: PBAOptions) -> PBAOptions:
    """``opts`` with the diagonal priors' weights at zero: K8 and the plain
    linearization then add exact zeros where they add the priors."""
    return opts._replace(fixed_reg=0.0, affine_reg_a=0.0, affine_reg_b=0.0)


def _linearize(window: Window, model, eps, idepth, lm_mask, opts: PBAOptions,
               marg_pass: bool = False) -> LinearSystem:
    """The GN system at (eps, idepth): K7's evaluation, then K8 on it with the
    FEJ of the window's linearization point (the JAX package's ``_linearize``,
    whose FEJ cache argument K8 forms itself)."""
    ev = _evaluate(window, model, eps, idepth, lm_mask, opts)
    return _linearize_from_ev(window, model, ev, eps, opts, marg_pass)


def _energy(window: Window, model, eps, idepth, lm_mask, opts: PBAOptions):
    """Total energy at (eps, idepth) → (energy, num_valid, the residuals'
    candidate statuses): K7, then :func:`_energy_from_ev`."""
    ev = _evaluate(window, model, eps, idepth, lm_mask, opts)
    e, n_valid = _energy_from_ev(window, ev, eps, opts)
    return e, n_valid, ev.status_candidate


def _pba_iteration(window: Window, model, eps, idepth, lm_mask, regularizer,
                   opts: PBAOptions):
    """One LM iteration: linearize at (eps, idepth) (K7, K8), solve (K9) →
    (eps', idepth', |step|²).  ``regularizer``: λ, a host float."""
    sys = _linearize(window, model, eps, idepth, lm_mask, opts)
    eps_new, idepth_new, pose_sq, d_sq = _solve_step(window, sys, eps, idepth,
                                                     regularizer, opts)
    return eps_new, idepth_new, pose_sq + d_sq


def _lm_decide_plain(window: Window, ev_new: Evaluation, eps_new, pose_sq, d_sq, e, it: int,
                     opts: PBAOptions, sums=None):
    """The decision of LM iteration ``it`` on a trial → (accept, done, energy,
    num_valid of the trial).  ``sums``: the trial's :func:`_landmark_sums`
    where the caller has them (summed over the landmark shards).  Reads the
    two flags on the host."""
    e_land, n_new = _landmark_sums(ev_new) if sums is None else sums
    e_new = _total_energy(window, e_land, eps_new, opts)
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


class OneShard:
    """The whole window in one process: the landmark sums are the window's
    own.  :func:`_solve_loop_plain` takes its three landmark reductions from
    such an object; ``parallel/shard_map_ba.py``'s sums them over the ranks
    that hold the window's landmark shards."""

    def sum(self, *xs):
        """The sums of ``xs`` over the landmark shards."""
        return xs

    def linearize(self, window: Window, model, ev: Evaluation, eps,
                  opts: PBAOptions) -> LinearSystem:
        """The whole window's GN system from the evaluation ``ev``."""
        return _linearize_from_ev(window, model, ev, eps, opts)

    def point_status(self, window: Window, model, opts: PBAOptions) -> PointStatus:
        """The statuses after a solve, the threshold over every landmark."""
        return _point_status_kernel(window, model, opts)


def _solve_loop_plain(window: Window, model, opts: PBAOptions, log: list = None,
                      shards: OneShard = OneShard()):
    """The windowed LM solve → (window', energy, num_valid), driven from the
    host.

    Force-accept for the first ``min_iterations``; candidate statuses commit
    on accept; while the ledger is empty every accepted step is folded into
    the linearization point (fresh FEJ next iteration).  The loop reads its
    accept/done flags on the host; its parts are the dispatchers (kernels on
    CUDA tensors).  ``log`` receives the loop state after the initial
    evaluation and after every iteration, as :func:`lm_log_rows` gives it
    for the device loop.  ``shards``: where the landmark sums come from
    (:class:`OneShard`: this window's own)."""
    lm_mask = active_lm_mask(window)
    ledger_empty = bool(torch.max(torch.abs(window.h_marg)) == 0.0)
    ev = _evaluate(window, model, window.eps, window.lm_idepth, lm_mask, opts)
    e_land, n = shards.sum(*_landmark_sums(ev))
    e = _total_energy(window, e_land, window.eps, opts)
    tq, tt, ab0 = window.t_lin_q, window.t_lin_t, window.affine0
    eps, idepth, lin_idepth = window.eps, window.lm_idepth, window.lm_idepth
    status = window.res_status
    lam = opts.initial_regularizer
    done = bool(n == 0)
    relin = False
    it = 0

    def record(accept):
        if log is not None:
            log.append(dict(energy=float(e), lam=float(lam), count=int(n), it=it,
                            accept=accept, done=done, relin=relin))

    record(False)
    while it < opts.max_iterations and not done:
        win = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0,
                             lm_idepth=lin_idepth, res_status=status)
        sys = shards.linearize(win, model, ev, eps, opts)
        eps_new, idepth_new, pose_sq, d_sq = _solve_step(win, sys, eps, idepth, lam, opts)
        ev_new = _evaluate(win, model, eps_new, idepth_new, lm_mask, opts)
        d_sq, *sums = shards.sum(d_sq, *_landmark_sums(ev_new))
        accept, done, e_new, n_new = _lm_decide_plain(win, ev_new, eps_new, pose_sq, d_sq, e,
                                                      it, opts, sums)
        if accept:
            eps, idepth, status = eps_new, idepth_new, ev_new.status_candidate
            e, n, ev = e_new, n_new, ev_new
            lam = lam / opts.reg_decrease
        else:
            lam = lam * opts.reg_increase
        relin = accept and ledger_empty and not done
        if relin:
            t_new = SE3(tq, tt) @ SE3.exp(eps[:, :6])
            tq, tt, ab0 = t_new.q, t_new.t, ab0 + eps[:, 6:]
            lin_idepth = idepth
            eps = torch.zeros_like(eps)
        it += 1
        record(accept)

    out = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0, eps=eps,
                         lm_idepth=idepth, res_status=status)
    out = _relinearize_last(out)
    return _with_point_status(out, shards.point_status(out, model, opts)), e, n


def _lm_phase(phase: int, row: int, window: Window, opts: PBAOptions, trial_eps,
              trial_idepth, step_sq, ev0: Evaluation, ev1: Evaluation, carried, state, lm_log,
              reduced=None, out=(None, None)):
    """One launch of kernel K10 (``csrc/ba_lm.cu::ba_lm``), outside the one-call
    solve (the landmark-sharded solve issues it, chip_smoke times K10's
    control with it, the GPU tests hold it): phase 0 copies the window's
    fields into ``carried`` (of :func:`_carried_state`) and initialises the
    loop state from ``ev0``, the initial evaluation; 1 decides on the trial
    (the buffer of ``ev0`` and ``ev1`` that the state does not name carried)
    and commits it; 2 folds the newest frame's increment and writes the
    loop's energy and count into ``out`` where given.  ``carried`` =
    (t_lin_q, t_lin_t, affine0, eps, idepth, lin_idepth, res_status),
    updated in place.  ``reduced``: None, or the trial's (Σ patch energies,
    their positive count), float64 [2] summed over the landmark shards, which
    the kernel then takes in place of its own sums."""
    k, n = window.num_slots, window.num_landmark_slots
    start = (window.t_lin_q, window.t_lin_t, window.affine0, window.eps, window.lm_idepth,
             window.res_status) if phase == 0 else (None,) * 6
    kernels.BA_LM(phase, row, k, n, int(opts.min_iterations), int(bool(opts.force_accept)),
                  float(opts.initial_regularizer), float(opts.function_tolerance),
                  float(opts.parameter_tolerance), float(opts.reg_decrease),
                  float(opts.reg_increase), float(opts.affine_reg_a), float(opts.affine_reg_b),
                  window.frame_valid, window.h_marg, window.b_marg, window.energy_marg,
                  trial_eps, trial_idepth, step_sq, ev0.energy_patch, ev0.status_candidate,
                  ev1.energy_patch, ev1.status_candidate, reduced, *start, *carried, state,
                  lm_log, *out, lm_log.shape[0], 1, None)


def _carried_state(window: Window):
    """Buffers for what K10 carries, which its phase 0 writes from the window:
    (t_lin_q, t_lin_t, affine0, eps, idepth, lin_idepth, res_status)."""
    return tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (
        window.t_lin_q, window.t_lin_t, window.affine0, window.eps, window.lm_idepth,
        window.lm_idepth, window.res_status))


# the entries ``ba_solve_loop`` counts into its host array, in the order of
# csrc/ba_lm.cu::SolveCount
_SOLVE_LOOP_COUNTED = (kernels.BA_EVALUATE, kernels.BA_LINEARIZE, kernels.BA_SOLVE,
                       kernels.BA_LM, kernels.BA_STATUS)


def solve_loop_launches(max_iterations: int) -> dict:
    """Kernel name → its launches in :func:`_solve_loop_cuda`'s fixed
    sequence, as expected (the wrapper adds what the C call counted): K7 on
    the initial state, in every iteration and at the solved state; K8 and K9
    once an iteration; K10's init, steps and finish; K11 once."""
    m = int(max_iterations)
    return {kernels.BA_EVALUATE.name: m + 2, kernels.BA_LINEARIZE.name: m,
            kernels.BA_SOLVE.name: m, kernels.BA_LM.name: m + 2, kernels.BA_STATUS.name: 1}


# the one-call solve's internal buffers, carved from one workspace a call (256-byte
# aligned): (k, n, C, iterations, dtype, sequences) -> their byte offsets
_SOLVE_LOOP_LAYOUT = {}
_WORKSPACE_ALIGN = 256


def _solve_loop_layout(k: int, n: int, c: int, iterations: int, dtype, seqs: int = 1):
    """Where :func:`_solve_loop_cuda`'s internal buffers lie in its workspace
    → ({group: byte offsets of its buffers, in ``ba_solve_loop``'s order},
    workspace bytes, K8's tiles, K9's back-substitution blocks).  The shapes
    are those of :func:`_evaluation_buffers`, :func:`_linearize_buffers` and
    :func:`_solve_step_buffers`, each ``seqs`` times (one a sequence, in
    sequence order); worked out once a shape."""
    key = (k, n, c, iterations, dtype, seqs)
    if key not in _SOLVE_LOOP_LAYOUT:
        meta = "meta"
        scratch, system = _linearize_buffers(k, n, dtype, meta)
        step = _solve_step_buffers(k, n, dtype, meta)
        groups = dict(
            carried=(torch.empty((k, n), dtype=dtype, device=meta),            # lin_idepth
                     torch.empty((k, k, n), dtype=torch.int32, device=meta)),  # res_status
            ev0=_evaluation_buffers(k, n, c, dtype, meta),
            ev1=_evaluation_buffers(k, n, c, dtype, meta),
            mask=(torch.empty((k, n), dtype=torch.bool, device=meta),),
            linearize=(*scratch, *system),
            step=step,
            loop=(torch.empty((LM_FIELDS,), dtype=torch.int32, device=meta),  # state
                  torch.empty((iterations + 2, LM_FIELDS), dtype=torch.int32, device=meta),
                  torch.empty((1,), dtype=dtype, device=meta)))                # K11's threshold
        offsets, total = {}, 0
        for name, tensors in groups.items():
            offsets[name] = []
            for t in tensors:
                offsets[name].append(total)
                size = t.numel() * t.element_size() * seqs
                total += -(-size // _WORKSPACE_ALIGN) * _WORKSPACE_ALIGN
        _SOLVE_LOOP_LAYOUT[key] = (offsets, total, scratch[0].shape[0] // (k * k),
                                   step[1].shape[0])
    return _SOLVE_LOOP_LAYOUT[key]


def _check_solve_window(window: Window, lead: tuple = ()):
    """Validate the window tensors a solve on the card reads → (k, n, h, w).
    ``lead``: the leading axes of a stacked window ((B,)), none for one."""
    k, n, h, w = _check_window(window, lead)
    if k > _SOLVE_MAX_FRAMES:
        raise ValueError(f"ba_solve_loop: {k} frame slots exceed the limit of its solve step, "
                         f"{_SOLVE_MAX_FRAMES} (the 8k x 8k system in the 227 KB of shared "
                         "memory of one block); K8, K10 and K11 take "
                         f"{_LINEARIZE_MAX_FRAMES}")
    check = kernels.check
    check(window.eps, "eps", lead + (k, BLOCK))
    check(window.lm_valid, "lm_valid", lead + (k, n), torch.bool)
    check(window.frame_valid, "frame_valid", lead + (k,), torch.bool)
    check(window.frame_fixed, "frame_fixed", lead + (k,), torch.bool)
    check(window.frame_marg, "frame_marg", lead + (k,), torch.bool)
    check(window.res_status, "res_status", lead + (k, k, n), torch.int32)
    check(window.h_marg, "h_marg", lead + (k * BLOCK, k * BLOCK), LEDGER_DTYPE)
    check(window.b_marg, "b_marg", lead + (k * BLOCK,), LEDGER_DTYPE)
    check(window.energy_marg, "energy_marg", lead, LEDGER_DTYPE)
    check(window.lm_baseline, "lm_baseline", lead + (k, n))
    check(window.lm_outlier, "lm_outlier", lead + (k, n), torch.bool)
    check(window.lm_opt_count, "lm_opt_count", lead + (k, n), torch.int32)
    return k, n, h, w


# ---------------------------------------------------------------------------
# The sequence axis: S sequences of a stacked window in one call
# ---------------------------------------------------------------------------

# what a solve writes into a window (the rest of the window it leaves)
SOLVED_FIELDS = ("t_lin_q", "t_lin_t", "affine0", "eps", "lm_idepth", "res_status",
                 "lm_baseline", "lm_inliers", "lm_outlier", "lm_opt_count")


def stack_windows(windows) -> Window:
    """Same-shape Windows stacked on a new leading axis (contiguous); mixed
    shapes raise."""
    first = windows[0]
    for b, w in enumerate(windows[1:], 1):
        for f in dataclasses.fields(Window):
            a, x = getattr(first, f.name), getattr(w, f.name)
            if (a is None) != (x is None) or (a is not None and a.shape != x.shape):
                raise ValueError(f"window {b}'s {f.name} has another shape than window 0's")
    return Window(**{f.name: (None if getattr(first, f.name) is None else
                              torch.stack([getattr(w, f.name) for w in windows]))
                     for f in dataclasses.fields(Window)})


def window_at(windows: Window, b: int) -> Window:
    """Sequence ``b`` of a stacked window: views, not copies."""
    return Window(**{f.name: (None if getattr(windows, f.name) is None else
                              getattr(windows, f.name)[b])
                     for f in dataclasses.fields(Window)})


def _as_stack(window: Window) -> Window:
    """One window as a stack of one (views)."""
    return Window(**{f.name: (None if getattr(window, f.name) is None else
                              getattr(window, f.name).unsqueeze(0))
                     for f in dataclasses.fields(Window)})


def stack_size(windows: Window) -> int:
    """The number of sequences B of a stacked window; raises unless every
    field has the leading axis and one sequence's shape."""
    batch = windows.t_lin_q.shape[0]
    if windows.t_lin_q.dim() != 3:
        raise ValueError(f"t_lin_q {tuple(windows.t_lin_q.shape)}: not a stack [B, K, 4]")
    k, n = windows.t_lin_q.shape[1], windows.lm_uv.shape[2]
    want = dict(t_lin_q=(k, 4), t_lin_t=(k, 3), affine0=(k, 2), eps=(k, BLOCK), exposure=(k,),
                frame_valid=(k,), frame_fixed=(k,), frame_marg=(k,), frame_id=(k,),
                lm_uv=(k, n, 2), lm_idepth=(k, n), lm_valid=(k, n), lm_marg_flag=(k, n),
                lm_outlier=(k, n), lm_inliers=(k, n), lm_opt_count=(k, n),
                lm_baseline=(k, n), res_status=(k, k, n), h_marg=(k * BLOCK, k * BLOCK),
                b_marg=(k * BLOCK,), energy_marg=())
    for name, shape in want.items():
        got = tuple(getattr(windows, name).shape)
        if got != (batch,) + shape:
            raise ValueError(f"{name} {got}: the stack's sequences have mixed shapes "
                             f"(want {(batch,) + shape})")
    for name in ("lm_patch", "maps", "channel_maps"):
        x = getattr(windows, name)
        if x is not None and tuple(x.shape[:2]) != (batch, k):
            raise ValueError(f"{name} {tuple(x.shape)}: not a stack of [B, K, ...]")
    return batch


def sequence_list(seqs, batch: int) -> tuple:
    """The host list of S sequences of a stack of ``batch`` (None: every
    sequence in order) → a tuple of ints; raises on an empty list, a
    sequence out of range or a duplicate."""
    seqs = tuple(range(batch)) if seqs is None else tuple(int(b) for b in seqs)
    if not seqs:
        raise ValueError("an empty sequence list: a call takes at least one sequence")
    if any(b < 0 or b >= batch for b in seqs):
        raise ValueError(f"sequence list {seqs}: out of range for a stack of {batch}")
    if len(set(seqs)) != len(seqs):
        raise ValueError(f"sequence list {seqs}: a sequence appears twice")
    return seqs


@functools.lru_cache(maxsize=256)
def _device_sequences(seqs: tuple, device, dtype=torch.int32) -> torch.Tensor:
    """The [S] device list of ``seqs`` (int32: the kernels'; int64: torch's
    indexing), made once per (list, device, dtype); on the card from pinned
    memory, without a host synchronisation."""
    host = torch.tensor(seqs, dtype=dtype)
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _kernel_sequences(seqs: tuple, batch: int, device):
    """The kernels' list argument: None where the list is every sequence of
    the stack in order (each sequence then lies at its position), else the
    device list."""
    return None if seqs == tuple(range(batch)) else _device_sequences(seqs, device)


def solve_loop_sequences(windows: Window, model, opts: PBAOptions = PBAOptions(), seqs=None,
                         log: list = None):
    """The windowed LM solve of the sequences ``seqs`` (a host list; None:
    all) of a stacked window in one call → ({field of :data:`SOLVED_FIELDS`:
    [S, ...]}, energy [S], num_valid [S]).

    On CUDA tensors the one C call of kernels K7–K11 for all S sequences
    (:func:`_solve_loop_sequences_cuda`); on CPU tensors
    :func:`_solve_loop_plain` once per sequence.  ``log`` (diagnostics; it
    reads the device) receives each sequence's state log."""
    batch = stack_size(windows)
    seqs = sequence_list(seqs, batch)
    if windows.maps.is_cuda:
        return _solve_loop_sequences_cuda(windows, model, opts, seqs, log)
    outs = []
    for b in seqs:
        rows = None if log is None else []
        outs.append(_solve_loop_plain(window_at(windows, b), model, opts, log=rows))
        if log is not None:
            log.append(rows)
    solved = {name: torch.stack([getattr(w, name) for w, _, _ in outs])
              for name in SOLVED_FIELDS}
    return (solved, torch.stack([e for _, e, _ in outs]),
            torch.stack([torch.as_tensor(n) for _, _, n in outs]))


def _solve_loop_sequences_cuda(windows: Window, model, opts: PBAOptions, seqs: tuple,
                               log: list = None, stacked: bool = True):
    """Kernels K7–K11 under K10's control in one C call
    (``csrc/ba_lm.cu::ba_solve_loop``) for the S sequences ``seqs`` (a
    checked host list) of a stacked window: each sequence the solve of
    :func:`_solve_loop_plain` without a host read, one launch per kernel for
    all of them.  ``opts.max_iterations`` iterations are issued whatever
    happens; each sequence's loop state lives on the device and its kernels
    return at once when it says done.  The wrapper checks the stack,
    allocates the ``[S, ...]`` outputs and one workspace for every internal
    buffer (:func:`_solve_loop_layout`) with ``torch.empty`` and makes the
    one call; ``log`` (diagnostics only: it reads the device) receives each
    sequence's decoded state log.  ``stacked=False``: ``windows`` is one
    window and ``seqs`` (0,), the outputs without the sequence axis (the
    kernels see the same memory: a list of one, null)."""
    lead = windows.t_lin_q.shape[:1] if stacked else ()
    batch = lead[0] if stacked else 1
    k, n, h, w = _check_solve_window(windows, tuple(lead))
    c = windows.channel_bank.shape[-3] // 3
    dtype, dev = windows.eps.dtype, windows.eps.device
    size = len(seqs)
    seq = _kernel_sequences(seqs, batch, dev)
    out = (size,) if stacked else ()
    offsets, total, tiles, blocks = _solve_loop_layout(k, n, c, opts.max_iterations, dtype,
                                                       size)
    workspace = torch.empty((total,), dtype=torch.uint8, device=dev)
    base = workspace.data_ptr()
    at = {name: [base + offset for offset in group] for name, group in offsets.items()}
    # what the solved windows keep: the carried state and K11's outputs (its
    # threshold stays in the workspace)
    solved = {name: torch.empty(out + tuple(getattr(windows, name).shape[len(lead):]),
                                dtype=getattr(windows, name).dtype, device=dev)
              for name in SOLVED_FIELDS}
    energy = torch.empty(out, dtype=torch.float32, device=dev)
    count = torch.empty(out, dtype=torch.int32, device=dev)
    state, lm_log, thresh = at["loop"]
    launched = (ctypes.c_int * len(_SOLVE_LOOP_COUNTED))()
    win = windows
    try:
        kernels.BA_SOLVE_LOOP(
            win.t_lin_q, win.t_lin_t, win.affine0, win.eps, win.exposure, win.lm_uv,
            win.lm_idepth, win.lm_patch, win.lm_valid, win.frame_valid, win.frame_fixed,
            win.frame_marg, win.res_status, win.h_marg, win.b_marg, win.energy_marg,
            win.channel_bank, 3 * c * h * w, win.lm_baseline, win.lm_outlier, win.lm_opt_count,
            k, n, h, w, c, model.fx, model.fy, model.cx, model.cy, model.width, model.height,
            int(opts.max_iterations), int(opts.min_iterations), int(bool(opts.force_accept)),
            float(opts.initial_regularizer), float(opts.function_tolerance),
            float(opts.parameter_tolerance), float(opts.reg_decrease), float(opts.reg_increase),
            float(opts.affine_reg_a), float(opts.affine_reg_b), float(opts.fixed_reg),
            float(opts.idepth_nullspace_threshold), float(opts.scale_nullspace_reg),
            _huber_sigma(c, opts), float(opts.huber_sigma), OUTLIER_QUANTILE,
            int(opts.min_valid_reprojections), solved["t_lin_q"], solved["t_lin_t"],
            solved["affine0"], solved["eps"], solved["lm_idepth"], *at["carried"],
            *at["ev0"], *at["ev1"], *at["mask"], tiles, *at["linearize"], blocks, *at["step"],
            state, lm_log, energy, count, *_status_workspace(k, n, dev, size), thresh,
            solved["res_status"], solved["lm_baseline"], solved["lm_inliers"],
            solved["lm_outlier"], solved["lm_opt_count"], size, seq,
            ctypes.addressof(launched))
    finally:
        # the calls the C loop made to each entry, counted there, also up to a
        # step that failed
        for kernel, n_calls in zip(_SOLVE_LOOP_COUNTED, launched):
            kernel.launches += n_calls
    if log is not None:
        start = offsets["loop"][1]
        rows = opts.max_iterations + 2
        logs = (workspace[start:start + size * rows * LM_FIELDS * 4]
                .view(torch.int32).view(size, rows, LM_FIELDS))
        log.extend(lm_log_rows(x) for x in logs)
    return solved, energy, count


def _solve_loop_cuda(window: Window, model, opts: PBAOptions, log: list = None):
    """Kernels K7–K11 under K10's control in one C call
    (``csrc/ba_lm.cu::ba_solve_loop``): the same solve as
    :func:`_solve_loop_plain` without a host read, the one-sequence case of
    :func:`_solve_loop_sequences_cuda`; ``log`` (diagnostics only: it reads
    the device) receives the decoded state log."""
    logs = None if log is None else []
    solved, energy, count = _solve_loop_sequences_cuda(window, model, opts, (0,), logs,
                                                       stacked=False)
    if log is not None:
        log.extend(logs[0])
    return window.replace(**solved), energy, count


def lm_log_rows(lm_log) -> list:
    """The device loop's state log (int32 [rows, 9]) → one dict for the initial
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
    """The windowed LM solve → (window', energy, num_valid): kernels K7–K11
    without a host read on CUDA tensors, the host-driven plain loop on CPU
    ones."""
    fn = _solve_loop_cuda if window.maps.is_cuda else _solve_loop_plain
    return fn(window, model, opts)


def solve_window(window: Window, model, opts: PBAOptions = PBAOptions(),
                 readback: bool = True):
    """The full backend solve (EigenPBA::solve): FEJ → LM loop → relinearize
    → outlier rejection, :func:`_solve_loop_device` (on the card one C call
    of kernels K7–K11), then one host read of (energy, num_valid).

    ``readback=False`` reads nothing and returns the two device scalars, so
    that a caller can fold them into a transfer of its own."""
    out, e, n = _solve_loop_device(window, model, opts)
    if not readback:
        return out, (e, n)
    energy, n_valid = torch.stack([e.to(torch.float64), n.to(torch.float64)]).tolist()
    return out, {"energy": energy, "num_valid": int(n_valid)}


# the diagonal of a dead slot's rows in :func:`pose_covariances`: its block reads
# as ~0 covariance and never as the scale nullspace
DEAD_SLOT_INFORMATION = 1e18


def pose_information(window: Window, model, opts: PBAOptions = PBAOptions()):
    """The reduced pose system that :func:`pose_covariances` inverts
    ([K·8, K·8], float64): H_pose + priors − H_schur + H_m at the window's
    state, from K7's evaluation and K8's system on CUDA tensors (the plain
    versions on CPU ones), with the ledger; dead slots' rows and columns
    zeroed and their diagonal set to ``DEAD_SLOT_INFORMATION``."""
    ev = _evaluate(window, model, window.eps, window.lm_idepth, active_lm_mask(window), opts)
    sys = _linearize_from_ev(window, model, ev, window.eps, opts)
    h = (sys.h_pose - sys.h_schur).to(LEDGER_DTYPE) + window.h_marg
    live = torch.repeat_interleave(window.frame_valid, BLOCK)
    h = torch.where(live[:, None] & live[None, :], h, torch.zeros_like(h))
    h = h + torch.diag(torch.where(live, 0.0, DEAD_SLOT_INFORMATION).to(h.dtype))
    return 0.5 * (h + h.T)


def pose_covariances(window: Window, model, opts: PBAOptions = PBAOptions()):
    """Pose-pose covariance of the window (the estimate_uncertainty path)
    → (cov [K·8, K·8] in the window's dtype, cov_rel [K, K, 6, 6]).

    The pseudo-inverse of :func:`pose_information` that drops the one
    eigenvalue of least magnitude (the monocular scale nullspace) and
    inverts the others with their sign, as the reference's
    ``svd(hermitian=True)`` does (it orders by |λ|); then the relative 6×6
    covariances by the adjoint sandwich
        Σ_rel[i,j] = Adj Σ_ii Adjᵀ − Σ_ijᵀ Adjᵀ − Adj Σ_ij + Σ_jj,
    Adj = Adj(T_wj⁻¹ T_wi).  The decomposition is ``torch.linalg.eigh`` in
    float64, which reads the device: this is no part of the tracker's device
    loop."""
    k = window.num_slots
    lam, vec = torch.linalg.eigh(pose_information(window, model, opts))
    keep = torch.arange(lam.shape[0], device=lam.device) != torch.argmin(torch.abs(lam))
    inv = torch.where(keep, 1.0 / lam, torch.zeros_like(lam))
    cov = ((vec * inv[None, :]) @ vec.T).to(window.eps.dtype)

    c = cov.reshape(k, BLOCK, k, BLOCK).permute(0, 2, 1, 3)[:, :, :6, :6]
    idx = torch.arange(k, device=c.device)
    sigma_d = c[idx, idx]                                              # [K, 6, 6]
    adj = _relative_poses(window.t_lin_q, window.t_lin_t, window.eps[:, :6]).adjoint()
    adj_t = adj.transpose(-1, -2)
    sig_rel = (adj @ sigma_d[:, None] @ adj_t - c.transpose(-1, -2) @ adj_t - adj @ c
               + sigma_d[None, :])
    return cov, sig_rel


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


def _status_workspace(k: int, n: int, device, seqs: int = 1):
    """Kernel K11's buffers on the current stream for ``seqs`` sequences → (its
    workspace, a header a sequence (``kernels.workspace``: zero between
    launches), its bytes, and the candidates, k·k·n words a sequence
    (``kernels.scratch``))."""
    nbytes = kernels.STATUS_WORKSPACE_BYTES * seqs
    return (kernels.workspace(kernels.BA_STATUS, nbytes, device), nbytes,
            kernels.scratch(kernels.BA_STATUS, 4 * k * k * n * seqs, device))


def _point_status_from_ev_cuda(window: Window, ev: Evaluation, lm_mask,
                               opts: PBAOptions) -> PointStatus:
    """Kernel K11: same outputs as :func:`_point_status_from_ev_plain`.  It
    reads the window's poses and its ``lm_idepth``, ``lm_baseline``,
    ``lm_outlier`` and ``lm_opt_count``, whose landmark axis is that of
    ``lm_mask`` and the evaluation."""
    k, n = lm_mask.shape
    if k > _LINEARIZE_MAX_FRAMES:
        raise ValueError(f"ba_point_status: {k} frame slots exceed the kernel's limit of "
                         f"{_LINEARIZE_MAX_FRAMES}")
    check = kernels.check
    check(window.t_lin_q, "t_lin_q", (k, 4))
    check(window.t_lin_t, "t_lin_t", (k, 3))
    check(window.eps, "eps", (k, BLOCK))
    check(window.lm_idepth, "lm_idepth", (k, n))
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
                      int(opts.min_valid_reprojections), *_status_workspace(k, n, dev), thresh,
                      new_status, baseline, inliers, outlier, opt_count, 1, None, None)
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


def _marg_pass(window: Window, model, opts: PBAOptions):
    """The marginalization pass at the current state (FEJ Jacobians): K7's
    evaluation and K8's system of the flagged landmarks, with the flagged
    frames' priors in its pose part → (the system, their energy); the
    one-sequence case of :func:`_marg_pass_sequences`."""
    sys, e_land = _marg_pass_sequences(_as_stack(window), model, opts, (0,))
    return LinearSystem(*(x[0] for x in sys)), e_land[0]


def _points_system(window: Window, h_pose, b_pose, h_schur, b_schur, opts: PBAOptions):
    """The flagged landmarks' system from the marginalization pass's: less
    the flagged frames' priors and the Schur complement."""
    h_pr, b_pr = _prior_system(window, window.eps, opts, marg_pass=True)
    return h_pose - h_pr - h_schur, b_pose - b_pr - b_schur


def _marg_system_kernel(window: Window, model, opts: PBAOptions):
    """H/b/E of the flagged landmarks at the current state (FEJ Jacobians),
    minus their Schur complement and without the priors."""
    sys, e_land = _marg_pass(window, model, opts)
    return (*_points_system(window, sys.h_pose, sys.b_pose, sys.h_schur, sys.b_schur, opts),
            e_land)


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


def _marginalize_system_plain(window: Window, h_pose, b_pose, h_schur, b_schur, e_land, perm,
                              opts: PBAOptions):
    """:func:`_marginalize_plain` from the marginalization pass's system
    (:func:`_marg_pass`): the plain counterpart of :func:`_marginalize_cuda`."""
    h_pts, b_pts = _points_system(window, h_pose, b_pose, h_schur, b_schur, opts)
    return _marginalize_plain(window, h_pts, b_pts, e_land, perm, opts)


def _marginalize_cuda(window: Window, h_pose, b_pose, h_schur, b_schur, e_land, perm,
                      opts: PBAOptions, sweeps=None):
    """Kernel K15 from the marginalization pass's system (K8's outputs and
    K7's energy, :func:`_marg_pass`): the outputs of
    :func:`_marginalize_system_plain`, the flagged landmarks' system formed
    in the kernel; reads nothing on the host (the number of flagged frames
    stays on the device).  ``sweeps``, an int32 [1] CUDA tensor or None,
    receives the number of Jacobi sweeps that rotated: ``MARG_MAX_SWEEPS``
    when the decomposition did not converge.  The one-sequence case of
    :func:`_marginalize_sequences_cuda`."""
    return _marginalize_sequences_cuda(window, (0,), h_pose, b_pose, h_schur, b_schur, e_land,
                                       perm, opts, sweeps, stacked=False)


def _marginalize_sequences_cuda(windows: Window, seqs: tuple, h_pose, b_pose, h_schur, b_schur,
                                e_land, perm, opts: PBAOptions, sweeps=None,
                                stacked: bool = True):
    """Kernel K15 for the S sequences ``seqs`` (a checked host list) of a
    stacked window in one launch a kernel: the marginalization pass's
    systems ``h_pose`` ... ``b_schur`` [S, ...], their energies ``e_land``
    [S] and the kept-first permutations ``perm`` [S, K] → the new ledgers
    (h [S, 8K, 8K], b [S, 8K], e [S], float64).  ``sweeps``: None or int32
    [S] (at one sequence [1]).  ``stacked=False``: one window, ``seqs``
    (0,), every argument and output without the sequence axis."""
    lead = windows.t_lin_q.shape[:1] if stacked else ()
    batch = lead[0] if stacked else 1
    k = windows.t_lin_q.shape[-2]
    kb, size = k * BLOCK, len(seqs)
    own = (size,) if stacked else ()
    check = kernels.check
    check(h_pose, "h_pose", own + (kb, kb))
    check(b_pose, "b_pose", own + (kb,))
    check(h_schur, "h_schur", own + (kb, kb))
    check(b_schur, "b_schur", own + (kb,))
    check(e_land, "e_land", own)
    check(windows.eps, "eps", lead + (k, BLOCK))
    check(windows.affine0, "affine0", lead + (k, 2))
    for name in ("frame_valid", "frame_fixed", "frame_marg"):
        check(getattr(windows, name), name, lead + (k,), torch.bool)
    check(perm, "perm", own + (k,), torch.int64)
    check(windows.h_marg, "h_marg", lead + (kb, kb), LEDGER_DTYPE)
    check(windows.b_marg, "b_marg", lead + (kb,), LEDGER_DTYPE)
    check(windows.energy_marg, "energy_marg", lead, LEDGER_DTYPE)
    dev = windows.eps.device
    kw = dict(dtype=LEDGER_DTYPE, device=dev)
    h_out, b_out, e_out = (torch.empty(own + (kb, kb), **kw), torch.empty(own + (kb,), **kw),
                           torch.empty(own, **kw))
    scratch = torch.empty((size * _marg_scratch_words(k),), **kw)
    if sweeps is not None:
        check(sweeps, "sweeps", (size,), torch.int32)
    kernels.MARG_FOLD(h_pose, b_pose, h_schur, b_schur, e_land, windows.eps, windows.affine0,
                      windows.frame_valid, windows.frame_fixed, windows.frame_marg, perm,
                      windows.h_marg, windows.b_marg, windows.energy_marg, k,
                      pinv_rtol(kb, windows.eps.dtype), float(opts.fixed_reg),
                      float(opts.affine_reg_a), float(opts.affine_reg_b), scratch, h_out, b_out,
                      e_out, sweeps, size, _kernel_sequences(seqs, batch, dev))
    return h_out, b_out, e_out


MARG_MAX_SWEEPS = 40   # csrc/marg_fold.cu kMaxSweeps


def _marg_scratch_words(k: int) -> int:
    """float64 words of kernel K15's scratch (csrc/marg_fold.cu): H_m [8k, 8k],
    b_m, hs and b_pts [8k], five [n, n] matrices (the compact block, its
    eigenvectors, X0, I − H_ee X0, X) and the correction [8k, n], for n =
    8(k − 1) flagged rows at most."""
    kb, n = k * BLOCK, (k - 1) * BLOCK
    return kb * kb + 3 * kb + 5 * n * n + kb * n


def _marginalize_device(window: Window, model, perm, opts: PBAOptions) -> Window:
    """Fold flagged landmarks and frames into the float64 ledger, then
    compact the frame slots by ``perm``: the one-sequence case of
    :func:`marginalize_sequences` (the fold kernel K15 on CUDA tensors, the
    plain version on CPU ones).  Nothing is read on the host."""
    return window_at(marginalize_sequences(_as_stack(window), model, perm[None], opts, (0,)), 0)


def _marginalize_with(fold, window: Window, model, perm, opts: PBAOptions) -> Window:
    """:func:`_marginalize_device` with the ledger fold ``fold``
    (:func:`_marginalize_cuda` or :func:`_marginalize_system_plain`), which
    takes the marginalization pass's system."""
    sys, e_land = _marg_pass(window, model, opts)
    return _fold_and_permute(fold, window, sys.h_pose, sys.b_pose, sys.h_schur, sys.b_schur,
                             e_land, perm, opts)


def _fold_and_permute(fold, window: Window, h_pose, b_pose, h_schur, b_schur, e_land, perm,
                      opts: PBAOptions) -> Window:
    """The ledger fold ``fold`` of the marginalization pass's system (the
    flagged frames' priors in its pose part), then the flagged landmarks
    dropped and the frame slots compacted by ``perm``."""
    h_m, b_m, e_m = fold(window, h_pose, b_pose, h_schur, b_schur, e_land, perm, opts)
    compact = _compact_sequences(_as_stack(window), (0,), perm[None],
                                 (h_m[None], b_m[None], e_m.reshape(1)))
    return window_at(compact, 0)


def marginalize(window: Window, model, opts: PBAOptions = PBAOptions(),
                frame_flags=None, lm_any=None) -> Window:
    """Fold the flagged landmarks and frames into the ledger, then compact
    the frame slots (updateMarginalizedLinearSystem): the window unchanged
    when nothing is flagged, else :func:`_marginalize_device` (on the card
    the marginalization pass's K7 and K8, then K15) with the kept-first slot
    permutation.

    ``frame_flags`` ([K] bool, numpy) and ``lm_any`` (bool): host copies of
    ``frame_marg & frame_valid`` and of whether a live landmark is flagged,
    when the caller has them; each one not given is read from the device.
    With both given nothing is read: the permutation is formed on the
    device from the window's own flags."""
    from dsopp_tpu_torch.tracker.marginalization import kept_first_perm

    if lm_any is None:
        lm_any = bool((window.lm_marg_flag & window.lm_valid).any())
    if frame_flags is None:
        frame_flags = (window.frame_marg & window.frame_valid).cpu().numpy()
    if not (lm_any or bool(np.asarray(frame_flags).any())):
        return window
    perm = kept_first_perm(window.frame_valid, window.frame_marg & window.frame_valid)
    return _marginalize_device(window, model, perm, opts)


def _sequence_energies(energy_patch):
    """[S] the Σ of each sequence's patch energies of an evaluation [S, K, K,
    N]: each ``torch.sum`` of a tensor of its own, as a pass of one sequence
    sums its own evaluation (at S > 1 a sequence's slice is copied first, so
    that no sum depends on where its slice lies in the stack)."""
    if energy_patch.shape[0] == 1:
        return torch.sum(energy_patch).reshape(1)
    return torch.stack([torch.sum(x.clone()) for x in energy_patch])


def _marg_pass_sequences(windows: Window, model, opts: PBAOptions, seqs: tuple):
    """:func:`_marg_pass` of the S sequences ``seqs`` (a checked host list) of
    a stacked window → (the systems [S, ...], their energies [S]): on CUDA
    tensors one launch of K7 and one of K8 for all S, on CPU tensors the
    plain version once per sequence."""
    if not windows.maps.is_cuda:
        passes = []
        for b in seqs:
            w = window_at(windows, b)
            lm_mask = w.lm_marg_flag & w.lm_valid & w.frame_valid[:, None]
            ev = _evaluate_plain(w, model, w.eps, w.lm_idepth, lm_mask, opts)
            sys = _linearize_from_ev_plain(w, _fej_cache_plain(w, model), ev, w.eps, opts,
                                           marg_pass=True)
            passes.append((sys, torch.sum(ev.energy_patch)))
        return (LinearSystem(*(torch.stack(xs) for xs in zip(*(p[0] for p in passes)))),
                torch.stack([p[1] for p in passes]))
    batch = windows.t_lin_q.shape[0]
    k, n, _, _ = _check_window(windows, (batch,))
    c = windows.channel_bank.shape[-3] // 3
    if k > _LINEARIZE_MAX_FRAMES:
        raise ValueError(f"ba_linearize_schur: {k} frame slots exceed the kernel's limit of "
                         f"{_LINEARIZE_MAX_FRAMES} (its Schur kernel's warps)")
    check = kernels.check
    check(windows.eps, "eps", (batch, k, BLOCK))
    check(windows.res_status, "res_status", (batch, k, k, n), torch.int32)
    for name in ("frame_valid", "frame_fixed", "frame_marg"):
        check(getattr(windows, name), name, (batch, k), torch.bool)
    dtype, dev = windows.eps.dtype, windows.eps.device
    size = len(seqs)
    seq = _kernel_sequences(seqs, batch, dev)
    lm_mask = windows.lm_marg_flag & windows.lm_valid & windows.frame_valid[..., None]
    ev = _evaluation_buffers(k, n, c, dtype, dev, (size,))
    _evaluate_launch(windows, model, windows.eps, windows.lm_idepth, lm_mask, opts, None, ev,
                     seqs=size, seq=seq, state_seq=seq)
    scratch, sys = _linearize_buffers(k, n, dtype, dev, (size,))
    _linearize_launch(windows, model, ev, None, windows.eps, opts, True, None, scratch, sys,
                      size, seq, seq)
    return sys, _sequence_energies(ev.energy_patch)


def _compact_sequences(windows: Window, seqs: tuple, perm, ledger) -> Window:
    """The window after the fold of the S sequences ``seqs`` of a stacked
    window, each compacted by its own ``perm`` [S, K] → a [S] stack of new
    tensors: the flagged landmarks dropped, the frame slots compacted
    kept-first (one gather a field; a flagged frame's slot invalid), and
    ``ledger`` = (h [S, 8K, 8K], b [S, 8K], e [S]) as its ledger."""
    dev = perm.device
    slots = slot_rows(seqs, perm)

    def take(x):
        return take_slots(x, slots)

    drop = take(windows.frame_marg & windows.frame_valid)
    valid = take(windows.frame_valid) & ~drop
    res = take(windows.res_status)                                   # [S, K(i), K(j), N]
    k, n = res.shape[1], res.shape[3]
    h_m, b_m, e_m = ledger
    return windows.replace(
        t_lin_q=take(windows.t_lin_q), t_lin_t=take(windows.t_lin_t),
        affine0=take(windows.affine0), eps=take(windows.eps), exposure=take(windows.exposure),
        frame_valid=valid, frame_fixed=take(windows.frame_fixed) & ~drop,
        frame_marg=torch.zeros_like(drop),
        frame_id=torch.where(valid, take(windows.frame_id), -1).to(torch.int32),
        lm_uv=take(windows.lm_uv), lm_patch=take(windows.lm_patch),
        lm_idepth=take(windows.lm_idepth),
        lm_valid=take(windows.lm_valid & ~windows.lm_marg_flag) & ~drop[..., None],
        lm_marg_flag=torch.zeros((len(seqs), k, n), dtype=torch.bool, device=dev),
        lm_outlier=take(windows.lm_outlier), lm_inliers=take(windows.lm_inliers),
        lm_opt_count=take(windows.lm_opt_count), lm_baseline=take(windows.lm_baseline),
        res_status=torch.gather(res, 2, perm[:, None, :, None].expand(-1, k, -1, n)),
        maps=take(windows.maps),
        channel_maps=None if windows.channel_maps is None else take(windows.channel_maps),
        h_marg=h_m, b_marg=b_m, energy_marg=e_m)


def slot_rows(seqs, perm, k: int = None):
    """[S·J] long: the rows of a stack's slots flattened to [B·K] that
    sequence ``seqs[z]``'s slots ``perm[z]`` [S, J] lie in (K: ``k``, or J
    where ``perm`` names every slot)."""
    rows = _device_sequences(tuple(seqs), perm.device, torch.int64)
    return (rows[:, None] * (perm.shape[1] if k is None else k) + perm).reshape(-1)


def take_slots(x, rows):
    """``x`` [B, K, ...] at the slot rows ``rows`` of :func:`slot_rows` →
    [S, K, ...], one ``index_select``."""
    k, tail = x.shape[1], x.shape[2:]
    return x.reshape((-1,) + tail).index_select(0, rows).view((-1, k) + tail)


def marginalize_sequences(windows: Window, model, perm, opts: PBAOptions = PBAOptions(),
                          seqs=None) -> Window:
    """:func:`_marginalize_device` of the sequences ``seqs`` (a host list;
    None: all) of a stacked window, each by its own kept-first permutation
    ``perm`` [S, K] → the S folded and compacted windows, a [S] stack of new
    tensors.  On CUDA tensors the marginalization pass's K7 and K8 and the
    fold K15 run one launch each for all S sequences; on CPU tensors the
    plain versions run once per sequence.  Nothing is read on the host."""
    batch = stack_size(windows)
    seqs = sequence_list(seqs, batch)
    sys, e_land = _marg_pass_sequences(windows, model, opts, seqs)
    if windows.maps.is_cuda:
        ledger = _marginalize_sequences_cuda(windows, seqs, *sys[:4], e_land, perm, opts)
    else:
        folds = [_marginalize_system_plain(window_at(windows, b), *(x[z] for x in sys[:4]),
                                           e_land[z], perm[z], opts)
                 for z, b in enumerate(seqs)]
        ledger = tuple(torch.stack(xs) for xs in zip(*folds))
    return _compact_sequences(windows, seqs, perm, ledger)


def put_sequences(windows: Window, seqs, part):
    """Write ``part`` into the sequences ``seqs`` (a host list) of the stacked
    window ``windows``, in place, one ``index_copy_`` a field: ``part`` is a
    [S] stack (every field) or a dict of some fields' [S] tensors."""
    index = _device_sequences(tuple(seqs), windows.t_lin_q.device, torch.int64)
    items = part.items() if isinstance(part, dict) else (
        (f.name, getattr(part, f.name)) for f in dataclasses.fields(Window))
    for name, x in items:
        if x is not None:
            getattr(windows, name).index_copy_(0, index, x)


def with_sequences(windows: Window, seqs: tuple, part) -> Window:
    """``windows`` with ``part`` (as :func:`put_sequences` takes it) at the
    sequences ``seqs``: where ``seqs`` is every sequence of the stack in
    order, a window of ``part``'s tensors and the stack's others, no tensor
    written; else :func:`put_sequences` in place → ``windows``."""
    if tuple(seqs) == tuple(range(windows.t_lin_q.shape[0])):
        return windows.replace(**part) if isinstance(part, dict) else part
    put_sequences(windows, seqs, part)
    return windows


def slot_mask(num_slots: int, slot, device):
    """[K] bool, true at frame slot ``slot``: an int, or a device tensor of
    one element, which is then never read on the host."""
    return torch.arange(num_slots, device=device) == slot


def into_sequences(x, seqs: tuple, value):
    """``x`` [B, ...] with ``value`` [S, ...] at the sequences ``seqs``:
    ``value`` itself where ``seqs`` is every sequence of the stack in order
    (``x`` is not written), else written into ``x`` in place, one
    ``index_copy_`` → ``x``."""
    if tuple(seqs) == tuple(range(x.shape[0])):
        return value
    return x.index_copy_(0, _device_sequences(tuple(seqs), x.device, torch.int64), value)


def host_values(values, dtype, device):
    """[S] device tensor of host ``values``; on the card from pinned memory,
    without a host synchronisation."""
    host = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def slot_view(x):
    """``x`` [B, K, ...] viewed as [B·K, ...], the rows :func:`slot_rows`
    names (a view: an in-place write reaches ``x``; a stack that cannot be
    viewed so raises)."""
    return x.view((-1,) + tuple(x.shape[2:]))


def push_frame_sequences(windows: Window, seqs, slots, pose_q, pose_t, affine, exposure,
                         fixed: bool, frame_ids, pixel_maps, channel_maps=None) -> Window:
    """Insert a keyframe with no landmarks into each of the sequences ``seqs``
    (a host list; None: all) of a stacked window (pushFrame over a sequence
    axis): sequence ``seqs[z]``'s at its slot ``slots[z]`` ([S] long, on the
    device, never read on the host), with pose ``pose_q`` [S, 4], ``pose_t``
    [S, 3], ``affine`` [S, 2], ``exposure`` [S] and frame id
    ``frame_ids[z]`` (host ints); its landmark rows cleared, its residual
    statuses reset, and its level-0 map, ``pixel_maps`` [B, 3, H, W] (the
    tick's, read at the sequence), into ``maps``.  ``channel_maps``: the S
    keyframes' [S, 3C, H, W] maps of the embedded channels, which a window of
    C > 1 channels needs and a window of one refuses.  Where ``seqs`` is every
    sequence of the stack in order, a window of new tensors (nothing
    written); else the S slots are written in place (one write a field, the
    maps of the S keyframes only) → ``windows``."""
    if (channel_maps is None) != (windows.channel_maps is None):
        c = windows.channel_bank.shape[-3] // 3
        raise ValueError(f"a {c}-channel window takes "
                         + ("no channel map" if channel_maps is not None
                            else "the keyframe's channel map"))
    batch = stack_size(windows)
    seqs = sequence_list(seqs, batch)
    k = windows.t_lin_q.shape[1]
    dev = windows.frame_valid.device
    frame_ids = tuple(int(f) for f in frame_ids)
    # one keyframe: its id a scalar; more: a device list
    frame_id = frame_ids[0] if len(frame_ids) == 1 else host_values(frame_ids, torch.int32, dev)
    if seqs == tuple(range(batch)):
        at = torch.arange(k, device=dev) == slots.view(-1, 1)                # [B, K]

        def put(x, v):
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                v = v.unsqueeze(1)
            return torch.where(at.reshape(at.shape + (1,) * (x.dim() - 2)), v, x)

        status = torch.where(at[:, :, None, None] | at[:, None, :, None], RES_OK,
                             windows.res_status)
        fid = frame_id if isinstance(frame_id, int) else frame_id.view(-1, 1)
        return windows.replace(
            t_lin_q=put(windows.t_lin_q, pose_q), t_lin_t=put(windows.t_lin_t, pose_t),
            affine0=put(windows.affine0, affine), eps=put(windows.eps, 0.0),
            exposure=put(windows.exposure, exposure),
            frame_valid=put(windows.frame_valid, True),
            frame_fixed=put(windows.frame_fixed, fixed),
            frame_id=torch.where(at, fid, windows.frame_id),
            lm_uv=put(windows.lm_uv, 0.0), lm_patch=put(windows.lm_patch, 0.0),
            lm_idepth=put(windows.lm_idepth, 0.0), lm_valid=put(windows.lm_valid, False),
            lm_outlier=put(windows.lm_outlier, False), lm_inliers=put(windows.lm_inliers, 0),
            lm_opt_count=put(windows.lm_opt_count, 0),
            lm_baseline=put(windows.lm_baseline, 0.0), res_status=status,
            maps=put(windows.maps, pixel_maps),
            channel_maps=(None if channel_maps is None
                          else put(windows.channel_maps, channel_maps)))
    seq_rows = _device_sequences(seqs, dev, torch.int64)
    rows = slot_rows(seqs, slots.view(-1, 1), k)                           # [S] of [B·K]
    for name, value in (("t_lin_q", pose_q), ("t_lin_t", pose_t), ("affine0", affine),
                        ("exposure", exposure)):
        slot_view(getattr(windows, name)).index_copy_(0, rows, value)
    for name, value in (("eps", 0.0), ("frame_valid", True), ("frame_fixed", fixed),
                        ("lm_uv", 0.0), ("lm_patch", 0.0), ("lm_idepth", 0.0),
                        ("lm_valid", False), ("lm_outlier", False), ("lm_inliers", 0),
                        ("lm_opt_count", 0), ("lm_baseline", 0.0), ("res_status", RES_OK)):
        slot_view(getattr(windows, name)).index_fill_(0, rows, value)
    if isinstance(frame_id, int):
        slot_view(windows.frame_id).index_fill_(0, rows, frame_id)
    else:
        slot_view(windows.frame_id).index_copy_(0, rows, frame_id)
    # the residual statuses of every anchor against the new frames as targets
    windows.res_status.index_put_(
        (seq_rows.view(-1, 1), torch.arange(k, device=dev).view(1, -1), slots.view(-1, 1)),
        torch.zeros((), dtype=windows.res_status.dtype, device=dev))
    slot_view(windows.maps).index_copy_(0, rows, pixel_maps.index_select(0, seq_rows))
    if channel_maps is not None:
        slot_view(windows.channel_maps).index_copy_(0, rows, channel_maps)
    return windows


def push_frame_slot(window: Window, slot, pose_q, pose_t, affine, exposure,
                    fixed: bool, frame_id: int, pixel_map, channel_map=None) -> Window:
    """Insert a keyframe with no landmarks into ``slot`` (pushFrame); ``slot``
    as :func:`slot_mask` takes it.  ``channel_map``: the [3C, H, W] map of the
    keyframe's embedded channels, which a window of C > 1 channels needs and
    a window of one refuses.  :func:`push_frame_sequences` on a stack of this
    one window → new tensors."""
    dev = window.frame_valid.device
    slots = (slot.reshape(1) if isinstance(slot, torch.Tensor)
             else torch.full((1,), int(slot), dtype=torch.int64, device=dev))
    exposure = torch.as_tensor(exposure, dtype=window.exposure.dtype, device=dev).reshape(1)
    return window_at(push_frame_sequences(
        _as_stack(window), (0,), slots, pose_q.reshape(1, 4), pose_t.reshape(1, 3),
        torch.as_tensor(affine, dtype=window.affine0.dtype, device=dev).reshape(1, 2), exposure,
        fixed, (frame_id,), pixel_map.unsqueeze(0),
        None if channel_map is None else channel_map.unsqueeze(0)), 0)
