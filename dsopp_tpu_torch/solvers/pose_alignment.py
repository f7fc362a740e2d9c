"""Frontend two-frame direct pose alignment (counterpart of
``dsopp_tpu/solvers/pose_alignment.py``) — kernel K2 and its LM loop K3.

Coarse-to-fine LM over a batch of pose hypotheses.  The relative pose is
left-incremented (t ← exp(δ)·t), the target affine (a, b) additively;
whole-point Huber; affine priors.

:func:`align_level` solves one pyramid level.  On a CUDA map it is one
launch of ``csrc/align_level.cu`` (K3): the whole LM loop of every
hypothesis on the device, no host read.  On a CPU map it is
:func:`align_level_plain`: a Python loop that builds the 8×8 systems
(6 pose + 2 affine) of all hypotheses with :func:`residual_system` and
solves the damped systems batched.  :func:`residual_system` in turn is the
CUDA kernel ``csrc/align.cu`` (K2, the body K3 runs per iteration) on a
CUDA map and :func:`residual_system_plain` on a CPU one.

:func:`align_level` also takes B sequences' hypotheses in one call (the
batched tick): ``seq`` [M] gives each hypothesis's sequence, whose points
(``[B, N, ...]``), map (``[B, 3C, H, W]``), reference affine (``[B, 2]``)
and exposure ratio (``[B]``) it reads.  On the card that is the same one
launch of K3, a sequence's result that of its own launch to the bit; the
plain version runs each sequence's hypotheses through
:func:`align_level_plain` in turn, so a sequence's result is that of its
own call there too.

Every function takes a map of C channels, ``[3C, H, W]`` (values C | dx C |
dy C), with reference intensities ``[N]`` at C = 1 or ``[N, C]``: a point
has C residuals, the whole-point Huber runs on their summed squares at
σ·√C, and each channel adds a Jacobian row (the JAX package's
``pose_alignment.py:101-161``).  C = 1 keeps the scalar form.  The tracker's
frontend runs C = 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.interpolate import sample
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.core.reproject import reproject_jacobian
from dsopp_tpu_torch.solvers.linear import solve
from dsopp_tpu_torch.solvers.measure import huber_energy_weight

# plain version only: LM iterations between host reads of "every hypothesis
# done" (on CUDA tensors each read is a device synchronisation; every
# iteration would cost more than it saves)
DONE_CHECK_EVERY = 4
# a row of the optional decision trace of :func:`align_level_plain` and
# :func:`align_level_cuda` (kTraceFields of csrc/align_level.cu), one per pass
# and hypothesis: energy before, trial energy, λ before, |step|², accept + 2·done
TRACE_FIELDS = 5


class AlignmentOptions(NamedTuple):
    max_iterations: int = 50
    initial_regularizer: float = 1e-2
    function_tolerance: float = 1e-5
    parameter_tolerance: float = 1e-5
    huber_sigma: float = 20.0
    affine_reg_a: float = 1e12
    affine_reg_b: float = 1e8
    reg_decrease: float = 2.0
    reg_increase: float = 10.0


class LevelPoints(NamedTuple):
    """Semi-dense reference points at one pyramid level (N slots)."""

    uv: torch.Tensor         # [N, 2]
    idepth: torch.Tensor     # [N]
    intensity: torch.Tensor  # [N], or [N, C] against a map of C channels
    valid: torch.Tensor      # [N] bool


class AlignmentResult(NamedTuple):
    t_t_r: SE3              # [B]
    affine: torch.Tensor    # [B, 2]
    energy: torch.Tensor    # [B] (incl. priors)
    num_valid: torch.Tensor  # [B] int32
    rmse: torch.Tensor      # [B]
    iterations: torch.Tensor  # [B] int32, LM iterations until done


def huber_sigma(pixel_map, opts: "AlignmentOptions") -> float:
    """The whole-point Huber sigma against a map of C channels ([3C, H, W],
    or B sequences' [B, 3C, H, W]): σ·√C."""
    return opts.huber_sigma * float(pixel_map.shape[-3] // 3) ** 0.5


def residual_system_plain(pts: LevelPoints, pixel_map, model, t_t_r: SE3,
                          affine, affine_ref, exposure_ratio, sigma):
    """H [B,8,8], b [B,8], energy [B] (no priors), num_valid [B] int32 of
    ``B`` hypotheses ``t_t_r`` (q [B,4], t [B,3]) and ``affine`` [B,2];
    ``sigma`` is the whole-point Huber sigma (:func:`huber_sigma`)."""
    scale = exposure_ratio * torch.exp(affine[:, 0] - affine_ref[0])      # [B]
    rj = reproject_jacobian(model, model, pts.uv[None], pts.idepth[None],
                            SE3(t_t_r.q[:, None], t_t_r.t[:, None]))
    patch, inside = sample(pixel_map, rj.uv)                              # [B,N,3C]
    c = pixel_map.shape[0] // 3
    if c > 1:
        return _residual_system_channels(pts, patch, inside, rj, scale, affine, affine_ref,
                                         sigma, c)
    vals, gx, gy = patch[..., 0], patch[..., 1], patch[..., 2]
    corrected_ref = scale[:, None] * (pts.intensity[None] - affine_ref[1])
    r = (vals - affine[:, 1:2]) - corrected_ref
    ok = pts.valid[None] & rj.valid & inside
    r2 = torch.where(ok, r * r, torch.zeros_like(r))
    energies, weights = huber_energy_weight(r2, sigma)
    energy = torch.sum(torch.where(ok, energies, torch.zeros_like(energies)), dim=-1)
    weights = torch.where(ok, weights, torch.zeros_like(weights))
    duv = -rj.d_uv_d_eps_tgt                                              # [B,N,2,6]
    dr_dpose = gx[..., None] * duv[..., 0, :] + gy[..., None] * duv[..., 1, :]
    j = torch.cat([dr_dpose, -corrected_ref[..., None],
                   -torch.ones_like(r)[..., None]], dim=-1)              # [B,N,8]
    jw = j * weights[..., None]
    h = torch.einsum("bni,bnj->bij", jw, j)
    b = torch.einsum("bni,bn->bi", jw, r)
    return h, b, energy, torch.sum(ok, dim=-1, dtype=torch.int32)


def _residual_system_channels(pts: LevelPoints, patch, inside, rj, scale, affine,
                              affine_ref, sigma, c: int):
    """:func:`residual_system_plain` at C > 1 channels: C residuals and
    Jacobian rows a point, Huber on their summed squares."""
    vals, gx, gy = patch[..., :c], patch[..., c:2 * c], patch[..., 2 * c:]  # [B,N,C]
    ref = pts.intensity.reshape(pts.intensity.shape[0], c)
    corrected_ref = scale[:, None, None] * (ref[None] - affine_ref[1])    # [B,N,C]
    r = (vals - affine[:, None, 1:2]) - corrected_ref
    ok = pts.valid[None] & rj.valid & inside
    r2 = torch.where(ok, torch.sum(r * r, dim=-1), torch.zeros_like(r[..., 0]))
    energies, weights = huber_energy_weight(r2, sigma)
    energy = torch.sum(torch.where(ok, energies, torch.zeros_like(energies)), dim=-1)
    weights = torch.where(ok, weights, torch.zeros_like(weights))
    duv = -rj.d_uv_d_eps_tgt                                              # [B,N,2,6]
    dr_dpose = (gx[..., None] * duv[..., None, 0, :]
                + gy[..., None] * duv[..., None, 1, :])                  # [B,N,C,6]
    j = torch.cat([dr_dpose, -corrected_ref[..., None],
                   -torch.ones_like(r)[..., None]], dim=-1)              # [B,N,C,8]
    jw = j * weights[..., None, None]
    h = torch.einsum("bnci,bncj->bij", jw, j)
    b = torch.einsum("bnci,bnc->bi", jw, r)
    return h, b, energy, torch.sum(ok, dim=-1, dtype=torch.int32)


def _check_problem(pts: LevelPoints, pixel_map, t_t_r: SE3, affine, affine_ref,
                   exposure_ratio, batch: int = 0):
    """Validate the tensors K2 and K3 share → (n, nb, h_px, w_px, c, ref)
    with ``ref`` = [a_ref, b_ref, exposure ratio] on the device; ``batch`` >
    0: B sequences' points, maps and references ([B, 3] ``ref``)."""
    lead = (batch,) if batch else ()
    n = pts.uv.shape[-2]
    nb = t_t_r.q.shape[0]
    check = kernels.check
    c = pixel_map.shape[-3] // 3
    check(pixel_map, "pixel_map", lead + (3 * c,) + tuple(pixel_map.shape[-2:]))
    h_px, w_px = pixel_map.shape[-2:]
    check(pts.uv, "uv", lead + (n, 2))
    check(pts.idepth, "idepth", lead + (n,))
    check(pts.intensity, "intensity", lead + ((n,) if c == 1 else (n, c)))
    check(pts.valid, "valid", lead + (n,), torch.bool)
    check(t_t_r.q, "pose_q", (nb, 4))
    check(t_t_r.t, "pose_t", (nb, 3))
    check(affine, "affine", (nb, 2))
    ratio = torch.as_tensor(exposure_ratio, dtype=affine.dtype, device=affine.device)
    ref = torch.stack([affine_ref[..., 0], affine_ref[..., 1], ratio], dim=-1).contiguous()
    check(ref, "ref", lead + (3,))
    return n, nb, h_px, w_px, c, ref


def residual_system_cuda(pts: LevelPoints, pixel_map, model, t_t_r: SE3,
                         affine, affine_ref, exposure_ratio, sigma):
    """Kernel K2: same outputs as :func:`residual_system_plain`."""
    n, nb, h_px, w_px, c, ref = _check_problem(pts, pixel_map, t_t_r, affine,
                                               affine_ref, exposure_ratio)
    dev, dt = affine.device, affine.dtype
    h = torch.empty((nb, 8, 8), dtype=dt, device=dev)
    b = torch.empty((nb, 8), dtype=dt, device=dev)
    energy = torch.empty((nb,), dtype=dt, device=dev)
    num_valid = torch.empty((nb,), dtype=torch.int32, device=dev)
    kernels.ALIGN(pts.uv, pts.idepth, pts.intensity, pts.valid, n, pixel_map,
                  h_px, w_px, c, t_t_r.q, t_t_r.t, affine, ref, nb,
                  model.fx, model.fy, model.cx, model.cy, model.width,
                  model.height, float(sigma), h, b, energy, num_valid)
    return h, b, energy, num_valid


def residual_system(pts: LevelPoints, pixel_map, model, t_t_r: SE3, affine,
                    affine_ref, exposure_ratio, opts: AlignmentOptions):
    """(energy [B], num_valid [B], H [B,8,8], b [B,8]) including the affine
    priors; the kernel on CUDA tensors, the plain version on CPU ones."""
    fn = residual_system_cuda if pixel_map.is_cuda else residual_system_plain
    h, b, energy, num_valid = fn(pts, pixel_map, model, t_t_r, affine,
                                 affine_ref, exposure_ratio, huber_sigma(pixel_map, opts))
    ra, rb = opts.affine_reg_a, opts.affine_reg_b
    a, bb = affine[:, 0], affine[:, 1]
    energy = energy + 0.5 * (ra * a * a + rb * bb * bb)
    h = h.clone()
    h[:, 6, 6] += ra
    h[:, 7, 7] += rb
    b = torch.cat([b[:, :6], b[:, 6:7] + ra * affine[:, 0:1], b[:, 7:8] + rb * affine[:, 1:2]],
                  dim=-1)
    return energy, num_valid, h, b


def align_level_plain(pts: LevelPoints, pixel_map, model, t_init: SE3, affine_init,
                      affine_ref, exposure_ratio,
                      opts: AlignmentOptions = AlignmentOptions(), trace: list = None):
    """LM solve of one level for a batch of hypotheses (q [B,4], t [B,3]).

    The iteration count is fixed at ``opts.max_iterations`` with a per-
    hypothesis ``done`` mask freezing converged hypotheses (the reference's
    while-loop semantics); every ``DONE_CHECK_EVERY`` iterations one host
    read ends the loop early once all hypotheses are done.  ``trace``
    (diagnostics) receives one tensor [B, passes, TRACE_FIELDS]: the decision
    of every pass, NaN where the hypothesis was done before it.
    """
    dt = affine_init.dtype
    q, t, affine = t_init.q, t_init.t, affine_init
    e, n, h, b = residual_system(pts, pixel_map, model, SE3(q, t), affine,
                                 affine_ref, exposure_ratio, opts)
    reg = torch.full(e.shape, opts.initial_regularizer, dtype=dt, device=e.device)
    done = n == 0
    iterations = torch.zeros(e.shape, dtype=torch.int32, device=e.device)
    eye = torch.eye(8, dtype=dt, device=e.device)
    rows = []
    if trace is not None:
        rows.append(torch.stack([e, e, reg, torch.zeros_like(e), 2.0 * done.to(dt)], dim=-1))
    for it in range(opts.max_iterations):
        if it % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        diag = torch.diagonal(h, dim1=-2, dim2=-1)
        h_d = h + eye * (reg[:, None] * diag + 1e-24)[:, None, :]
        step = -solve(h_d, b)
        step = torch.where(torch.isfinite(step), step, torch.zeros_like(step))
        t_new = SE3.exp(step[:, :6]) @ SE3(q, t)
        affine_new = affine + step[:, 6:]
        e_new, n_new, h_new, b_new = residual_system(
            pts, pixel_map, model, t_new, affine_new, affine_ref,
            exposure_ratio, opts)

        accept = (e_new < e) & (n_new > 0) & torch.isfinite(e_new)
        ftol = (torch.abs(e - e_new) / torch.clamp(e, min=1e-30)
                < opts.function_tolerance)
        state_sq = torch.sum(affine * affine, dim=-1)
        ptol = torch.sum(step * step, dim=-1) < opts.parameter_tolerance * (
            state_sq + opts.parameter_tolerance)
        converged = (ftol & torch.isfinite(e_new)) | (accept & ptol)

        live = ~done
        take = live & accept
        if trace is not None:
            row = torch.stack([e, e_new, reg, torch.sum(step * step, dim=-1),
                               accept.to(dt) + 2.0 * converged.to(dt)], dim=-1)
            rows.append(torch.where(live[:, None], row, torch.full_like(row, float("nan"))))
        q = torch.where(take[:, None], t_new.q, q)
        t = torch.where(take[:, None], t_new.t, t)
        affine = torch.where(take[:, None], affine_new, affine)
        e = torch.where(take, e_new, e)
        n = torch.where(take, n_new, n)
        h = torch.where(take[:, None, None], h_new, h)
        b = torch.where(take[:, None], b_new, b)
        reg = torch.where(live, torch.where(accept, reg / opts.reg_decrease,
                                            reg * opts.reg_increase), reg)
        iterations = iterations + live.to(torch.int32)
        done = done | (live & converged)
    rmse = torch.sqrt(e / torch.clamp(n, min=1).to(dt))
    if trace is not None:
        trace.append(torch.stack(rows, dim=1))
    return AlignmentResult(SE3(q, t), affine, e, n, rmse, iterations)


def align_level_cuda(pts: LevelPoints, pixel_map, model, t_init: SE3, affine_init,
                     affine_ref, exposure_ratio,
                     opts: AlignmentOptions = AlignmentOptions(), trace: list = None,
                     seq=None, per_seq: int = None):
    """Kernel K3: same result as :func:`align_level_plain`, in one launch
    (a cluster of blocks per hypothesis) and without a host read.  ``trace``
    as there, with ``opts.max_iterations + 1`` passes.  ``seq``: [M] int32
    sequence of each hypothesis, with B sequences' points, maps and
    references (:func:`align_level`); ``per_seq``: the hypotheses each
    sequence has in the call, which sizes the clusters as its own launch
    would."""
    batch = 0 if seq is None else pts.uv.shape[0]
    n, nb, h_px, w_px, c, ref = _check_problem(pts, pixel_map, t_init, affine_init,
                                               affine_ref, exposure_ratio, batch)
    if seq is not None:
        kernels.check(seq, "seq", (nb,), torch.int32)
    per_seq = nb if seq is None else int(per_seq)
    dev, dt = affine_init.device, affine_init.dtype
    q = torch.empty((nb, 4), dtype=dt, device=dev)
    t = torch.empty((nb, 3), dtype=dt, device=dev)
    affine = torch.empty((nb, 2), dtype=dt, device=dev)
    energy = torch.empty((nb,), dtype=dt, device=dev)
    num_valid = torch.empty((nb,), dtype=torch.int32, device=dev)
    rmse = torch.empty((nb,), dtype=dt, device=dev)
    iterations = torch.empty((nb,), dtype=torch.int32, device=dev)
    rows = None
    if trace is not None:
        rows = torch.full((nb, opts.max_iterations + 1, TRACE_FIELDS), float("nan"),
                          dtype=dt, device=dev)
        trace.append(rows)
    kernels.ALIGN_LEVEL(
        pts.uv, pts.idepth, pts.intensity, pts.valid, n, pixel_map, h_px, w_px, c,
        t_init.q, t_init.t, affine_init, ref, seq, nb, per_seq, model.fx, model.fy,
        model.cx, model.cy, model.width, model.height, float(huber_sigma(pixel_map, opts)),
        int(opts.max_iterations), float(opts.initial_regularizer),
        float(opts.function_tolerance), float(opts.parameter_tolerance),
        float(opts.affine_reg_a), float(opts.affine_reg_b), float(opts.reg_decrease),
        float(opts.reg_increase), q, t, affine, energy, num_valid, rmse, iterations,
        rows)
    return AlignmentResult(SE3(q, t), affine, energy, num_valid, rmse, iterations)


def align_level_sequences_plain(pts: LevelPoints, pixel_map, model, t_init: SE3,
                                affine_init, affine_ref, exposure_ratio, seq,
                                opts: AlignmentOptions = AlignmentOptions()):
    """:func:`align_level` over B sequences on the CPU: each sequence's
    hypotheses (``seq`` [M], CPU) through :func:`align_level_plain` on its own
    points, map and reference, the results in the hypotheses' order."""
    order = seq.tolist()
    parts, where = [], []
    for b in sorted(set(order)):
        idx = torch.tensor([i for i, s in enumerate(order) if s == b], dtype=torch.long)
        parts.append(align_level_plain(
            LevelPoints(*(x[b] for x in pts)), pixel_map[b], model,
            SE3(t_init.q[idx], t_init.t[idx]), affine_init[idx], affine_ref[b],
            exposure_ratio[b], opts))
        where.append(idx)
    back = torch.argsort(torch.cat(where))
    q, t = (torch.cat([getattr(r.t_t_r, f) for r in parts])[back] for f in ("q", "t"))
    return AlignmentResult(SE3(q, t), *(torch.cat([getattr(r, f) for r in parts])[back]
                                        for f in AlignmentResult._fields[1:]))


def align_level(pts: LevelPoints, pixel_map, model, t_init: SE3, affine_init,
                affine_ref, exposure_ratio,
                opts: AlignmentOptions = AlignmentOptions(), seq=None,
                per_seq: int = None):
    """LM solve of one level for a batch of hypotheses: the kernel K3 on
    CUDA tensors, the plain loop on CPU ones.  ``seq`` (with ``per_seq``, the
    hypotheses a sequence has in the call): B sequences' hypotheses in one
    call, each reading its sequence's ``[B, ...]`` points, map, reference
    affine and exposure ratio."""
    if pixel_map.is_cuda:
        return align_level_cuda(pts, pixel_map, model, t_init, affine_init, affine_ref,
                                exposure_ratio, opts, seq=seq, per_seq=per_seq)
    if seq is None:
        return align_level_plain(pts, pixel_map, model, t_init, affine_init, affine_ref,
                                 exposure_ratio, opts)
    return align_level_sequences_plain(pts, pixel_map, model, t_init, affine_init,
                                       affine_ref, exposure_ratio, seq, opts)
