"""Immature-landmark activation (counterpart of
``dsopp_tpu/tracker/activation.py``).

A ready immature point (traced, interval < 8 px, uniqueness > 3, positive
idepth) activates when it reprojects validly into the newest keyframe and no
ACTIVE landmark projects within ``min_distance`` of it; activating points
get a 3-iteration scalar LM on idepth against every window frame (newest
host bank first, at most ``REFINE_CAP`` per keyframe) and are then paired
rank for rank with free landmark slots of their host frame (the pairing
also applies the refinement's outcome to the banks: kept points take the
refined idepth, refined points not kept are deleted).

Immature points carry intensity patches (the epipolar tracer is C = 1, as
the reference's), and the refinement samples channel 0 of the window's
channel bank, as the JAX package does.  In a window of C > 1 embedder
channels a landmark's reference patch is its C-channel one, sampled from
its host keyframe's bank when it activates (:func:`embedded_patches`).

The three steps have hand-written CUDA kernels beside their plain versions:
K13 (``csrc/activation.cu``) for :func:`_activation_kernel`, K14
(``csrc/refine.cu``) for :func:`_refine_idepth_kernel` and
:func:`_activation_scatter`.  Each dispatches on the window's device: CUDA
tensors go to the kernel or raise.  Each also runs over a sequence axis
(:func:`activation_sequences`, :func:`refine_idepth_sequences`,
:func:`activation_scatter_sequences`): S sequences of a stacked window and
its stacked banks, named by a host list, in one call (on the card one launch
a kernel, each sequence's blocks its solo launch's; on the CPU the plain
version once a sequence); the solo CUDA wrappers are its S = 1 case.
"""

from __future__ import annotations

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.interpolate import pad_images, sample_window, window_base
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.core.pattern import PATTERN_CENTER, PATTERN_SIZE, shift_pattern
from dsopp_tpu_torch.core.reproject import reproject, reproject_jacobian
from dsopp_tpu_torch.solvers.pba import (RES_OK, Window, _kernel_sequences, active_lm_mask,
                                         newest_slot, sequence_list, stack_size, window_at)
from dsopp_tpu_torch.tracker.depth_estimation import (
    STATUS_GOOD, STATUS_ILL_CONDITIONED, STATUS_OOB, STATUS_OUTLIER,
    STATUS_SKIPPED, ImmaturePoints)

MAX_SEARCH_INTERVAL = 8.0
MIN_UNIQUENESS = 3.0
P_GAIN = 0.001
MIN_DISTANCE = 0.0
MAX_DISTANCE = 10.0
MAX_ENERGY_FOR_INLIERS = PATTERN_SIZE * 12.0 * 12.0
REFINE_ITERATIONS = 3
REFINE_REG0 = 0.1
REFINE_REG_DEC = 2.0
REFINE_REG_INC = 5.0
REFINE_CAP = 512
_REFINE_MAX_FRAMES = 40   # frame slots K14's refine kernel sums over in shared memory
_ACTIVATION_MAX_FRAMES = 64   # frame slots K13's kernels hold poses for in shared memory


def ready_for_activation(points: ImmaturePoints):
    s = points.status
    status_ok = ((s == STATUS_GOOD) | (s == STATUS_SKIPPED)
                 | (s == STATUS_ILL_CONDITIONED) | (s == STATUS_OOB))
    return (points.valid & points.traced & status_ok
            & (points.search_interval < MAX_SEARCH_INTERVAL)
            & (points.uniqueness > MIN_UNIQUENESS) & (points.idepth > 0))


def _to_newest(window: Window):
    """[K] poses newest ← each frame."""
    k = window.num_slots
    newest = newest_slot(window)
    poses = window.poses()
    t_n = SE3(poses.q.index_select(0, newest)[0], poses.t.index_select(0, newest)[0]).inverse()
    return SE3(t_n.q.expand(k, 4), t_n.t.expand(k, 3)).compose(poses), newest


def _check_poses(window: Window, lead: tuple = ()):
    """Validate the window's pose tensors the K13 and K14 kernels read (with
    the leading ``lead`` axes of a stack)."""
    k = window.t_lin_q.shape[-2]
    check = kernels.check
    check(window.t_lin_q, "t_lin_q", lead + (k, 4))
    check(window.t_lin_t, "t_lin_t", lead + (k, 3))
    check(window.eps, "eps", lead + (k, 8))
    check(window.frame_valid, "frame_valid", lead + (k,), torch.bool)


def _bank(imm: ImmaturePoints, b: int) -> ImmaturePoints:
    """Sequence ``b``'s banks of stacked banks (views)."""
    return ImmaturePoints(*(x[b] for x in imm))


def _stacked(outs):
    """The per-sequence outputs of a plain loop, stacked field by field."""
    return tuple(torch.stack(xs) for xs in zip(*outs))


def _lead(windows: Window, stacked: bool):
    """(the stack's leading axes, its sequences B) of a sequence wrapper's
    window: ((B,), B) for a stack, ((), 1) for one window."""
    return ((windows.t_lin_q.shape[0],), windows.t_lin_q.shape[0]) if stacked else ((), 1)


def _activation_terms_plain(window: Window, model, imm: ImmaturePoints):
    """→ (ready [K, M], reprojection valid [K, M], least distance to an active
    landmark's projection [K, M], n_active, reprojected uv [K, M, 2])."""
    k = window.num_slots
    t_rel, newest = _to_newest(window)
    t_b = SE3(t_rel.q[:, None], t_rel.t[:, None])
    act_mask = active_lm_mask(window) & ~window.lm_outlier
    rp_act = reproject(model, model, window.lm_uv, window.lm_idepth, t_b)
    act_ok = act_mask & rp_act.valid
    n_active = torch.sum(act_ok)
    act_uv = torch.where(act_ok[..., None], rp_act.uv,
                         torch.full_like(rp_act.uv, float("inf"))).reshape(-1, 2)

    ready = ready_for_activation(imm)
    ready = ready & ~(torch.arange(k, device=newest.device) == newest)[:, None]
    rp_imm = reproject(model, model, imm.uv, imm.idepth, t_b)
    cu = rp_imm.uv.reshape(-1, 2)
    d2 = (cu[:, None, 0] - act_uv[None, :, 0]) ** 2 + (cu[:, None, 1] - act_uv[None, :, 1]) ** 2
    min_d = torch.sqrt(torch.min(d2, dim=1).values).reshape(imm.uv.shape[:2])
    return ready, rp_imm.valid, min_d, n_active, rp_imm.uv


def _activation_plain(window: Window, model, imm: ImmaturePoints, min_distance):
    """→ (activate [K, M] bool, delete [K, M] bool, n_active)."""
    ready, rp_valid, min_d, n_active, _ = _activation_terms_plain(window, model, imm)
    spaced = torch.where(n_active > 0, min_d > min_distance, torch.ones_like(ready))
    activate = ready & rp_valid & spaced
    dead_status = (imm.status == STATUS_OUTLIER) | ((imm.status == STATUS_OOB) & ~ready)
    delete = imm.valid & (dead_status | (ready & ~rp_valid))
    return activate, delete, n_active


def _check_banks(imm: ImmaturePoints, lead: tuple = ()):
    """Validate the bank tensors the kernels read (with the leading ``lead``
    axes of a stack) → (k, m)."""
    k, m = imm.uv.shape[-3:-1]
    check = kernels.check
    check(imm.uv, "immature uv", lead + (k, m, 2))
    check(imm.patch, "immature patch", lead + (k, m, PATTERN_SIZE))
    for name in ("idepth_min", "idepth_max", "uniqueness", "search_interval"):
        check(getattr(imm, name), f"immature {name}", lead + (k, m))
    check(imm.status, "immature status", lead + (k, m), torch.int32)
    check(imm.traced, "immature traced", lead + (k, m), torch.bool)
    check(imm.valid, "immature valid", lead + (k, m), torch.bool)
    return k, m


def _activation_cuda(window: Window, model, imm: ImmaturePoints, min_distance):
    """Kernel K13: same outputs as :func:`_activation_plain`, with no
    [K·M, K·N] distance matrix and no host read.  ``min_distance`` may be a
    device scalar (the density controller's state) or a float.  The kernels
    take the window's raw tensors (poses, masks) and write every output.  The
    one-sequence case of :func:`_activation_sequences_cuda`."""
    if isinstance(min_distance, torch.Tensor):
        kernels.check(min_distance, "min_distance", tuple(min_distance.shape))
        if min_distance.numel() != 1:
            raise ValueError(f"min_distance: expected one value, got {min_distance.numel()}")
    else:
        min_distance = torch.full((1,), float(min_distance), dtype=torch.float32,
                                  device=window.lm_uv.device)
    return _activation_sequences_cuda(window, model, imm, min_distance, (0,), stacked=False)


def _activation_scratch_floats(k: int, n: int) -> int:
    """K13's scratch of one sequence, floats: csrc/activation.cu::scratch_floats."""
    return -(-(2 * k * n + 8 * k + 1) // 64) * 64


def _activation_sequences_cuda(windows: Window, model, imm: ImmaturePoints, min_distance,
                               seqs: tuple, stacked: bool = True):
    """Kernel K13 for the S sequences ``seqs`` (a checked host list) of a
    stacked window, its stacked banks and ``min_distance`` [B] (each
    sequence's controller state), read through the list, two launches for
    all S → (activate [S, K, M], delete [S, K, M], n_active [S]).
    ``stacked=False``: one window, ``seqs`` (0,), ``min_distance`` one value,
    the outputs without the sequence axis."""
    lead, batch = _lead(windows, stacked)
    k, n = windows.t_lin_q.shape[-2], windows.lm_uv.shape[-2]
    km, m = _check_banks(imm, lead)
    check = kernels.check
    if km != k:
        raise ValueError(f"{km} immature banks for {k} frame slots")
    if k > _ACTIVATION_MAX_FRAMES:
        raise ValueError(f"the activation kernels take at most {_ACTIVATION_MAX_FRAMES} frame"
                         f" slots, got {k}")
    _check_poses(windows, lead)
    check(windows.lm_uv, "lm_uv", lead + (k, n, 2))
    check(windows.lm_idepth, "lm_idepth", lead + (k, n))
    check(windows.lm_valid, "lm_valid", lead + (k, n), torch.bool)
    check(windows.lm_outlier, "lm_outlier", lead + (k, n), torch.bool)
    if stacked:
        check(min_distance, "min_distance", lead)
    dev = windows.lm_uv.device
    size = len(seqs)
    own = (size,) if stacked else ()
    activate = torch.empty(own + (k, m), dtype=torch.bool, device=dev)
    delete = torch.empty(own + (k, m), dtype=torch.bool, device=dev)
    n_active = torch.empty(own, dtype=torch.int64, device=dev)
    kernels.ACTIVATION(
        windows.t_lin_q, windows.t_lin_t, windows.eps, windows.frame_valid, windows.lm_uv,
        windows.lm_idepth, windows.lm_valid, windows.lm_outlier, k, n, m, model.fx, model.fy,
        model.cx, model.cy, model.width, model.height, imm.uv, imm.idepth_min, imm.idepth_max,
        imm.status, imm.traced, imm.uniqueness, imm.search_interval, imm.valid,
        MAX_SEARCH_INTERVAL, MIN_UNIQUENESS, min_distance,
        torch.empty((size * _activation_scratch_floats(k, n),), dtype=torch.float32, device=dev),
        activate, delete, n_active, size, _kernel_sequences(seqs, batch, dev))
    return activate, delete, n_active


def activation_sequences(windows: Window, model, imm: ImmaturePoints, min_distance, seqs=None):
    """Which immature points activate and which are deleted, for the
    sequences ``seqs`` (a host list; None: all) of a stacked window with its
    stacked banks and ``min_distance`` [B] → (activate [S, K, M], delete [S,
    K, M], n_active [S]): the kernel K13 in one call (two launches for all S)
    on CUDA tensors, :func:`_activation_plain` once a sequence on CPU ones."""
    seqs = sequence_list(seqs, stack_size(windows))
    if windows.lm_uv.is_cuda:
        return _activation_sequences_cuda(windows, model, imm, min_distance, seqs)
    return _stacked(_activation_plain(window_at(windows, b), model, _bank(imm, b),
                                      min_distance[b]) for b in seqs)


def _activation_kernel(window: Window, model, imm: ImmaturePoints, min_distance):
    """Which immature points activate and which are deleted: the kernel K13
    on CUDA tensors, the plain version on CPU ones."""
    fn = _activation_cuda if window.lm_uv.is_cuda else _activation_plain
    return fn(window, model, imm, min_distance)


def _refine_idepth_plain(window: Window, model, imm: ImmaturePoints, activate,
                         huber_sigma: float, cap: int = REFINE_CAP, trace: list = None):
    """Idepth refinement of the activating points → (idepth [K, M],
    keep [K, M], selected [K, M]).  ``trace`` (a list) receives the decisions
    of the refined candidates in refinement order, [cap, 3, 4]: energy, trial
    energy, λ and accept per trial."""
    k, m = imm.uv.shape[:2]
    dev = imm.uv.device
    n_flat = k * m
    flat_act = activate.reshape(-1)
    flat_idx = torch.arange(n_flat, device=dev)
    rank = (k - 1 - flat_idx // m) * m + flat_idx % m       # newest bank first
    order = torch.argsort(torch.where(flat_act, rank, n_flat + flat_idx), stable=True)[:cap]
    sel = flat_act[order]
    host = order // m
    uv = imm.uv.reshape(n_flat, 2)[order]
    patch0 = imm.patch.reshape(n_flat, -1)[order]
    idepth = imm.idepth.reshape(n_flat)[order]

    poses = window.poses()
    t_inv = poses.inverse()
    t_cj = SE3(t_inv.q[None], t_inv.t[None]).compose(SE3(poses.q[host][:, None], poses.t[host][:, None]))
    affine = window.affine()
    ratio = window.exposure[None, :] / torch.clamp(window.exposure[host][:, None], min=1e-12)
    scale = ratio * torch.exp(affine[None, :, 0] - affine[host][:, None, 0])
    pair = (window.frame_valid[None, :] & sel[:, None]
            & (torch.arange(k, device=dev)[None, :] != host[:, None]))
    pattern = shift_pattern(uv)[:, None]                       # [cap,1,P,2]
    t_b = SE3(t_cj.q[:, :, None, :], t_cj.t[:, :, None, :])
    corrected = scale[:, :, None] * (patch0[:, None] - affine[host][:, None, None, 1])
    h_px, w_px = window.maps.shape[-2:]
    padded = pad_images(window.channel_bank[:, 0])   # channel 0 of the bank
    target = torch.arange(k, device=dev)[None, :, None]
    zero_k = torch.zeros_like(corrected[..., 0])

    def eval_full(idep):
        rj = reproject_jacobian(model, model, pattern, idep[:, None, None], t_b)
        bx, by = window_base(rj.uv[..., PATTERN_CENTER, :], h_px, w_px)
        vals, gxs, gys, inside = sample_window(padded, rj.uv, bx[..., None], by[..., None],
                                               h_px, w_px, img_idx=target)
        ok = torch.all(rj.valid & inside, dim=-1) & pair
        r = (vals - affine[None, :, None, 1]) - corrected
        r = torch.where(ok[..., None], r, torch.zeros_like(r))
        r2 = torch.sum(r * r, dim=-1)
        rnorm = torch.sqrt(torch.clamp(r2, min=1e-30))
        w = torch.where(rnorm > huber_sigma, huber_sigma / rnorm, torch.ones_like(rnorm))
        inlier = ok & (r2 < MAX_ENERGY_FOR_INLIERS)
        e_term = torch.where(inlier, w * r2,
                             torch.where(ok, MAX_ENERGY_FOR_INLIERS, zero_k))
        d = gxs * rj.d_uv_d_idepth[..., 0] + gys * rj.d_uv_d_idepth[..., 1]
        d = torch.where(ok[..., None], d, torch.zeros_like(d))
        return (torch.sum(e_term, dim=1), torch.sum(inlier, dim=1),
                torch.sum(w[..., None] * d * d, dim=(1, 2)),
                torch.sum(w[..., None] * d * r, dim=(1, 2)))

    e, inliers, h, b = eval_full(idepth)
    lam = torch.full_like(idepth, REFINE_REG0)
    rows = []
    for _ in range(REFINE_ITERATIONS):
        trial = idepth - b / torch.clamp(h * (1.0 + lam), min=1e-20)
        e_new, inl_new, h_new, b_new = eval_full(trial)
        accept = (e_new < e) & (h > 0)
        rows.append(torch.stack([e, e_new, lam, accept.to(e.dtype)], dim=-1))
        idepth = torch.where(accept, trial, idepth)
        e = torch.where(accept, e_new, e)
        inliers = torch.where(accept, inl_new, inliers)
        h = torch.where(accept, h_new, h)
        b = torch.where(accept, b_new, b)
        lam = torch.where(accept, lam / REFINE_REG_DEC, lam * REFINE_REG_INC)

    min_inliers = torch.clamp(window.frame_valid.sum() - 1, max=1)
    keep_c = sel & (inliers >= min_inliers) & (idepth > 0)
    idep_flat = imm.idepth.reshape(n_flat).clone()
    idep_flat[order] = torch.where(keep_c, idepth, idep_flat[order])
    keep_flat = torch.zeros(n_flat, dtype=torch.bool, device=dev)
    keep_flat[order] = keep_c
    sel_flat = torch.zeros(n_flat, dtype=torch.bool, device=dev)
    sel_flat[order] = sel
    if trace is not None:
        trace.append(torch.stack(rows, dim=1))
    return idep_flat.reshape(k, m), keep_flat.reshape(k, m), sel_flat.reshape(k, m)


def _refine_idepth_cuda(window: Window, model, imm: ImmaturePoints, activate,
                        huber_sigma: float, cap: int = REFINE_CAP, trace: list = None):
    """Kernel K14 (refine): same outputs as :func:`_refine_idepth_plain`; the
    maps are read in place, the kernels take the window's raw tensors (poses,
    affine, exposure) and write every output, and nothing is read on the
    host.  The one-sequence case of :func:`_refine_idepth_sequences_cuda`."""
    return _refine_idepth_sequences_cuda(window, model, imm, activate, huber_sigma, (0,), cap,
                                         trace, stacked=False)


def _refine_idepth_sequences_cuda(windows: Window, model, imm: ImmaturePoints, activate,
                                  huber_sigma: float, seqs: tuple, cap: int = REFINE_CAP,
                                  trace: list = None, stacked: bool = True):
    """Kernel K14 (refine) for the S sequences ``seqs`` (a checked host list)
    of a stacked window and its stacked banks, read through the list, with
    ``activate`` [S, K, M] (K13's): two launches for all S, each sequence its
    own cap, order and pair table → (idepth, keep, selected), each [S, K, M];
    ``trace`` receives [S, cap, 3, 4].  ``stacked=False``: one window,
    ``seqs`` (0,), no sequence axis."""
    lead, batch = _lead(windows, stacked)
    k, m = _check_banks(imm, lead)
    check = kernels.check
    h_px, w_px = windows.maps.shape[-2:]
    c = windows.channel_bank.shape[-3] // 3
    size = len(seqs)
    own = (size,) if stacked else ()
    check(windows.channel_bank, "channel bank", lead + (k, 3 * c, h_px, w_px))
    check(activate, "activate", own + (k, m), torch.bool)
    if k > _REFINE_MAX_FRAMES:
        raise ValueError(f"the refine kernel takes at most {_REFINE_MAX_FRAMES} frame slots,"
                         f" got {k}")
    _check_poses(windows, lead)
    check(windows.affine0, "affine0", lead + (k, 2))
    check(windows.exposure, "exposure", lead + (k,))
    dev = imm.uv.device
    idepth = torch.empty(own + (k, m), dtype=torch.float32, device=dev)
    keep = torch.empty(own + (k, m), dtype=torch.bool, device=dev)
    selected = torch.empty(own + (k, m), dtype=torch.bool, device=dev)
    rows = None
    if trace is not None:
        rows = torch.empty(own + (cap, REFINE_ITERATIONS, 4), dtype=torch.float32, device=dev)
        trace.append(rows)
    # the refinement samples plane 0 of channel_bank[f] (at C = 1, the intensity)
    kernels.REFINE(activate, imm.uv, imm.patch, imm.idepth_min, imm.idepth_max,
                   windows.t_lin_q, windows.t_lin_t, windows.eps, windows.affine0,
                   windows.exposure, windows.frame_valid, windows.channel_bank,
                   3 * c * h_px * w_px, k, m, h_px, w_px, cap,
                   model.fx, model.fy, model.cx, model.cy, model.width, model.height,
                   float(huber_sigma), torch.empty((size * cap,), dtype=torch.int32, device=dev),
                   torch.empty((size * (8 * k * k + k),), dtype=torch.float32, device=dev),
                   selected, idepth, keep, rows, size, _kernel_sequences(seqs, batch, dev))
    return idepth, keep, selected


def refine_idepth_sequences(windows: Window, model, imm: ImmaturePoints, activate,
                            huber_sigma: float, seqs=None, cap: int = REFINE_CAP):
    """The refinement of the sequences ``seqs`` (a host list; None: all) of a
    stacked window with its stacked banks and ``activate`` [S, K, M] →
    (idepth, keep, selected), each [S, K, M]: the kernel K14 in one call on
    CUDA tensors, :func:`_refine_idepth_plain` once a sequence on CPU ones."""
    seqs = sequence_list(seqs, stack_size(windows))
    if windows.maps.is_cuda:
        return _refine_idepth_sequences_cuda(windows, model, imm, activate, huber_sigma, seqs,
                                             cap)
    return _stacked(_refine_idepth_plain(window_at(windows, b), model, _bank(imm, b),
                                         activate[z], huber_sigma, cap)
                    for z, b in enumerate(seqs))


def _refine_idepth_kernel(window: Window, model, imm: ImmaturePoints, activate,
                          huber_sigma: float, cap: int = REFINE_CAP):
    """The refinement: the kernel K14 on CUDA tensors, the plain version on
    CPU ones."""
    fn = _refine_idepth_cuda if window.maps.is_cuda else _refine_idepth_plain
    return fn(window, model, imm, activate, huber_sigma, cap)


def embedded_patches(window: Window, uv):
    """[K, M, C·P] channel-major reference patches of points ``uv`` [K, M, 2]
    of each host slot, sampled from that slot's channel bank under the
    10×10-window rule (:func:`sample_window`, window based at ``floor(uv) −
    4``; values only, a point outside the window reads its clamped corners,
    pixels outside the image read 0), as the JAX package's
    ``embedded_patches`` reads its patch tables."""
    k, m = uv.shape[:2]
    c = window.num_channels
    h, w = window.maps.shape[-2:]
    bx, by = window_base(uv, h, w)                                     # [K, M]
    plane = (torch.arange(k, device=uv.device)[:, None, None, None] * c
             + torch.arange(c, device=uv.device)[:, None])              # [K, 1, C, 1]
    vals, _, _, _ = sample_window(pad_images(window.channel_bank[:, :c]),
                                  shift_pattern(uv)[:, :, None], bx[..., None, None],
                                  by[..., None, None], h, w, img_idx=plane)  # [K, M, C, P]
    return vals.reshape(k, m, c * PATTERN_SIZE)


def _activation_scatter_plain(window: Window, imm: ImmaturePoints, activate, delete,
                              idepth=None, selected=None):
    """Move accepted immature points into free landmark slots, per slot; in a
    window of C > 1 channels their patches are :func:`embedded_patches`.
    ``idepth``, ``selected``: the refinement's outputs, or None where none ran;
    then ``activate`` is its keep mask, and first the kept points' idepth
    bounds become the refined idepth and the refined points not kept are
    deleted (``fused_keyframe_push``'s glue in the JAX package)."""
    if idepth is not None:
        delete = delete | (selected & ~activate)
        imm = imm._replace(idepth_min=torch.where(activate, idepth, imm.idepth_min),
                           idepth_max=torch.where(activate, idepth, imm.idepth_max))
    k, n = window.lm_valid.shape
    m = imm.uv.shape[1]
    r = min(n, m)
    dev = imm.uv.device
    ar_n = torch.arange(n, device=dev)[None, :]
    ar_m = torch.arange(m, device=dev)[None, :]
    free_order = torch.argsort(torch.where(~window.lm_valid, ar_n, n + ar_n), dim=1, stable=True)
    act_order = torch.argsort(torch.where(activate, ar_m, m + ar_m), dim=1, stable=True)
    take = torch.minimum(torch.sum(~window.lm_valid, dim=1), torch.sum(activate, dim=1))
    mask = torch.arange(r, device=dev)[None, :] < take[:, None]          # [K, r]
    dst = torch.where(mask, free_order[:, :r], n)                        # n = dropped
    src = act_order[:, :r]

    def scatter(dst_buf, values, dim):
        """Write ``values`` at ``dst`` along ``dim`` of a buffer with one
        extra (dropped) slot; the result is a dense buffer again (the
        BA kernels take contiguous window tensors)."""
        ext = torch.cat([dst_buf, torch.zeros_like(dst_buf.narrow(dim, 0, 1))], dim=dim)
        idx = dst.reshape(dst.shape + (1,) * (ext.dim() - dst.dim()))
        if dim == 2:
            idx = dst[:, None, :]
        idx = idx.expand(values.shape)
        return ext.scatter(dim, idx, values).narrow(dim, 0, dst_buf.shape[dim]).contiguous()

    def take_src(x):
        idx = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand((k, r) + tuple(x.shape[2:]))
        return torch.gather(x, 1, idx)

    lm_uv = scatter(window.lm_uv, take_src(imm.uv), 1)
    patch = imm.patch if window.num_channels == 1 else embedded_patches(window, imm.uv)
    lm_patch = scatter(window.lm_patch, take_src(patch), 1)
    lm_idepth = scatter(window.lm_idepth, take_src(imm.idepth), 1)
    lm_valid = scatter(window.lm_valid, torch.ones((k, r), dtype=torch.bool, device=dev), 1)
    status = scatter(window.res_status,
                     torch.full((k, k, r), RES_OK, dtype=torch.int32, device=dev), 2)
    taken = torch.zeros((k, m), dtype=torch.bool, device=dev).scatter(1, src, mask)
    imm_valid = imm.valid & ~taken & ~delete
    window = window.replace(lm_uv=lm_uv, lm_patch=lm_patch, lm_idepth=lm_idepth,
                            lm_valid=lm_valid, res_status=status)
    return window, imm._replace(valid=imm_valid), torch.sum(take)


def _activation_scatter_cuda(window: Window, imm: ImmaturePoints, activate, delete,
                             idepth=None, selected=None):
    """Kernel K14 (pairing): same outputs as :func:`_activation_scatter_plain`,
    the refinement's glue included, in one C call with no host read.  The
    kernel writes every entry of new window tensors and banks once (the
    untouched ones copied), so the caller's window and banks stay as they
    were; every output is dense.  At C > 1 it samples the moved points'
    C-channel patches from their host slots' channel bank.  The one-sequence
    case of :func:`_activation_scatter_sequences_cuda`."""
    part, bank, n_activated = _activation_scatter_sequences_cuda(
        window, imm, activate, delete, idepth, selected, (0,), stacked=False)
    return window.replace(**part), imm._replace(**bank), n_activated


# the window fields and the bank fields the pairing writes
PAIRED_FIELDS = ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "res_status")
PAIRED_BANK_FIELDS = ("valid", "idepth_min", "idepth_max")


def _activation_scatter_sequences_cuda(windows: Window, imm: ImmaturePoints, activate, delete,
                                       idepth, selected, seqs: tuple, stacked: bool = True):
    """Kernel K14 (pairing) for the S sequences ``seqs`` (a checked host
    list) of a stacked window and its stacked banks, read through the list,
    with the [S, K, M] flags of K13 and the refinement: one launch for all S
    → ({field of :data:`PAIRED_FIELDS`: [S, ...]}, {the banks' valid and,
    after a refinement, idepth bounds: [S, K, M]}, n_activated [S]), new
    dense tensors.  ``stacked=False``: one window, ``seqs`` (0,), no sequence
    axis."""
    lead, batch = _lead(windows, stacked)
    k, n = windows.t_lin_q.shape[-2], windows.lm_uv.shape[-2]
    c = windows.channel_bank.shape[-3] // 3
    km, m = _check_banks(imm, lead)
    check = kernels.check
    if km != k:
        raise ValueError(f"{km} immature banks for {k} frame slots")
    size = len(seqs)
    own = (size,) if stacked else ()
    check(activate, "activate", own + (k, m), torch.bool)
    check(delete, "delete", own + (k, m), torch.bool)
    if (idepth is None) != (selected is None):
        raise ValueError("the refinement's idepth and selected come together")
    if idepth is not None:
        check(idepth, "refined idepth", own + (k, m))
        check(selected, "selected", own + (k, m), torch.bool)
    check(windows.lm_uv, "lm_uv", lead + (k, n, 2))
    check(windows.lm_patch, "lm_patch", lead + (k, n, c * PATTERN_SIZE))
    h_px, w_px = windows.maps.shape[-2:]
    check(windows.channel_bank, "channel bank", lead + (k, 3 * c, h_px, w_px))
    check(windows.lm_idepth, "lm_idepth", lead + (k, n))
    check(windows.lm_valid, "lm_valid", lead + (k, n), torch.bool)
    check(windows.res_status, "res_status", lead + (k, k, n), torch.int32)
    dev = imm.uv.device
    f32, u8 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.bool, device=dev)
    part = dict(lm_uv=torch.empty(own + (k, n, 2), **f32),
                lm_patch=torch.empty(own + (k, n, c * PATTERN_SIZE), **f32),
                lm_idepth=torch.empty(own + (k, n), **f32),
                lm_valid=torch.empty(own + (k, n), **u8),
                res_status=torch.empty(own + (k, k, n), dtype=torch.int32, device=dev))
    bank = dict(valid=torch.empty(own + (k, m), **u8))
    if idepth is not None:
        bank.update(idepth_min=torch.empty(own + (k, m), **f32),
                    idepth_max=torch.empty(own + (k, m), **f32))
    n_activated = torch.empty(own, dtype=torch.int64, device=dev)
    ws = kernels.workspace(kernels.ACTIVATION_SCATTER, size * kernels.PAIR_WORKSPACE_BYTES, dev)
    kernels.ACTIVATION_SCATTER(
        activate, delete, selected, idepth, imm.uv, imm.patch, imm.idepth_min, imm.idepth_max,
        imm.valid, windows.channel_bank, c, h_px, w_px, k, n, m, windows.lm_uv,
        windows.lm_patch, windows.lm_idepth, windows.lm_valid, windows.res_status,
        *part.values(), bank["valid"], bank.get("idepth_min"), bank.get("idepth_max"),
        n_activated, ws, ws.numel(), size, _kernel_sequences(seqs, batch, dev))
    return part, bank, n_activated


def activation_scatter_sequences(windows: Window, imm: ImmaturePoints, activate, delete,
                                 idepth=None, selected=None, seqs=None):
    """The move into landmark slots of the sequences ``seqs`` (a host list;
    None: all) of a stacked window and its stacked banks, with the [S, K, M]
    flags of K13 and (or None) the refinement → ({field of
    :data:`PAIRED_FIELDS`: [S, ...]}, {the banks' valid and, after a
    refinement, idepth bounds: [S, K, M]}, n_activated [S]): the kernel K14
    in one launch on CUDA tensors, :func:`_activation_scatter_plain` once a
    sequence on CPU ones."""
    seqs = sequence_list(seqs, stack_size(windows))
    if windows.lm_uv.is_cuda:
        return _activation_scatter_sequences_cuda(windows, imm, activate, delete, idepth,
                                                  selected, seqs)
    outs = [_activation_scatter_plain(window_at(windows, b), _bank(imm, b), activate[z],
                                      delete[z], None if idepth is None else idepth[z],
                                      None if selected is None else selected[z])
            for z, b in enumerate(seqs)]
    names = PAIRED_BANK_FIELDS if idepth is not None else PAIRED_BANK_FIELDS[:1]
    return ({name: torch.stack([getattr(w, name) for w, _, _ in outs]) for name in PAIRED_FIELDS},
            {name: torch.stack([getattr(b, name) for _, b, _ in outs]) for name in names},
            torch.stack([x for _, _, x in outs]))


def _activation_scatter(window: Window, imm: ImmaturePoints, activate, delete, idepth=None,
                        selected=None):
    """The move into landmark slots, after the refinement's glue where
    ``idepth`` and ``selected`` (its outputs) are given: the kernel K14 on
    CUDA tensors, the plain version on CPU ones."""
    fn = _activation_scatter_cuda if window.lm_uv.is_cuda else _activation_scatter_plain
    return fn(window, imm, activate, delete, idepth, selected)
