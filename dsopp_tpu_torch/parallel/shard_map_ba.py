"""The landmark-sharded BA with explicit collectives: one iteration, the whole
LM solve and the ledger fold (counterpart of
``dsopp_tpu/parallel/shard_map_ba.py``, and of ``pba._solve_loop_device`` and
``pba._marginalize_device`` as the JAX package runs them on its ``lm`` mesh
axis).

Each rank of a mesh's ``lm`` group holds its shard of the window's landmark
slots (:func:`place_window`), evaluates its residuals (K7) and linearizes
them (K8) into partial (K·8)² photometric systems and its landmarks' Schur
terms.  Every rank of the group issues the same collectives in the same
order, and nothing else is communicated:

* the GN system: ``h_pose``, ``b_pose``, ``h_schur`` and ``b_schur`` packed
  in one buffer and all-reduced, the frame priors added once after the sum;
  every rank then solves the small dense pose system alike (K9), and the
  idepth back-substitution stays shard-local;
* the trial's |idepth step|², its landmark energy and the count of its
  positive patch energies, in one float64 all-reduce (K10 takes the energy
  and the count in place of its own sums);
* K11's inputs, gathered exactly along the landmark axis: each rank writes
  its slice of a zero buffer as integer bits, and the all-reduce of those
  buffers is the whole window's, bit for bit, so the outlier threshold (the
  75th percentile of every shard's energies) is the unsharded one.

This replaces the reference's mutex-merged TBB accumulators, as the JAX
module's ``psum`` over its ``lm`` axis does.  The ledger is f64 in the port
and replicated, so the priors and the marginalized quadratic are the same
arithmetic on every rank.  On the card the solve is the fixed sequence of
``ba_solve_loop`` issued from Python, collectives between the kernels; the
loop's decisions live in K10's device state, which every rank computes from
the same reduced inputs, so no rank reads a flag on the host and every rank
issues the same launches.  Results equal the single-process solve's up to
the reduction order of the all-reduced sums; on a mesh of one ``lm`` rank
there is no collective and they are its bits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from dsopp_tpu_torch.parallel.mesh import Mesh
from dsopp_tpu_torch.solvers.pba import LM_FIELDS as LM_STATE_WORDS
from dsopp_tpu_torch.solvers.pba import (LM_CARRIED, Evaluation, LinearSystem,
                                         OneShard, PBAOptions, PointStatus, Window,
                                         _carried_state, _check_solve_window,
                                         _evaluate, _evaluate_launch, _evaluation_buffers,
                                         _fold_and_permute, _landmark_sums, _lm_phase,
                                         _linearize_buffers, _linearize_from_ev,
                                         _linearize_launch, _marg_pass, _marginalize_cuda,
                                         _marginalize_device, _marginalize_system_plain,
                                         _point_status_from_ev_cuda, _point_status_from_ev_plain,
                                         _prior_system, _solve_loop_cuda, _solve_loop_plain,
                                         _solve_step, _solve_step_buffers, _solve_step_launch,
                                         _total_energy, _with_point_status, _without_prior,
                                         active_lm_mask, lm_log_rows)

# the Window fields that carry the landmark slot axis N: [K, N, ...] ...
LM_FIELDS = ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "lm_marg_flag", "lm_outlier",
             "lm_inliers", "lm_opt_count", "lm_baseline")
# ... and [K, K, N]
RES_FIELDS = ("res_status",)


def _shard_bounds(n: int, mesh: Mesh) -> tuple:
    if n % mesh.num_lm:
        raise ValueError(f"{n} landmark slots do not split into {mesh.num_lm} shards")
    size = n // mesh.num_lm
    return mesh.lm_index * size, (mesh.lm_index + 1) * size


def place_window(window: Window, mesh: Mesh) -> Window:
    """This rank's landmark shard of ``window``: the ``lm_*`` fields' N axis
    and ``res_status``'s last axis sliced by the rank's ``lm`` coordinate
    (contiguous copies, as the kernels take them); the frame fields, the
    ledger and the maps are the window's own (replicated)."""
    lo, hi = _shard_bounds(window.num_landmark_slots, mesh)
    changes = {name: getattr(window, name)[:, lo:hi].contiguous() for name in LM_FIELDS}
    changes.update({name: getattr(window, name)[..., lo:hi].contiguous()
                    for name in RES_FIELDS})
    return dataclasses.replace(window, **changes)


def _sharded(mesh: Mesh) -> bool:
    """Whether the landmark slots are split over several ranks."""
    return mesh.lm_group is not None and mesh.num_lm > 1


def _all_reduce(xs, mesh: Mesh) -> list:
    """The sums of the same-dtype tensors ``xs`` over the rank's ``lm`` group
    (``xs`` themselves on one rank): one all-reduce of one packed buffer, on
    the device where they lie (gloo takes CUDA tensors: chip_smoke
    ``[parallel]``)."""
    if not _sharded(mesh):
        return list(xs)
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, group=mesh.lm_group)
    return [part.view(x.shape) for part, x in zip(flat.split([x.numel() for x in xs]), xs)]


def _reduced_system(window: Window, sys: LinearSystem, eps, opts: PBAOptions,
                    mesh: Mesh) -> LinearSystem:
    """A shard's photometric system (K8 with the priors' weights at zero)
    summed over the group, with the frame priors at ``eps`` (frame-indexed,
    replicated) added once after the sum."""
    h_pose, b_pose, h_schur, b_schur = _all_reduce(sys[:4], mesh)
    h_pr, b_pr = _prior_system(window, eps, opts)
    return sys._replace(h_pose=h_pose + h_pr, b_pose=b_pose + b_pr, h_schur=h_schur,
                        b_schur=b_schur)


# bits of each dtype in the exact gather: a float travels as its bit pattern
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def pack_shards(xs, lm_index: int, num_lm: int):
    """Shard ``lm_index`` of ``num_lm`` of each tensor of ``xs`` (the last
    axis the landmark slots) written as integers (a float's bit pattern)
    into its slice of one zero buffer of the whole tensors: the sum of the
    ``num_lm`` shards' buffers is the whole tensors' (:func:`unpack_shards`),
    each entry one shard's value plus zeros."""
    wide = torch.int64 if any(x.element_size() == 8 for x in xs) else torch.int32
    n = xs[0].shape[-1]
    shapes = [(*x.shape[:-1], n * num_lm) for x in xs]
    sizes = [int(torch.Size(shape).numel()) for shape in shapes]
    flat = torch.zeros(sum(sizes), dtype=wide, device=xs[0].device)
    for x, part, shape in zip(xs, flat.split(sizes), shapes):
        bits = x.view(_BITS[x.dtype]) if x.dtype in _BITS else x
        part.view(shape)[..., lm_index * n:(lm_index + 1) * n] = bits
    return flat


def unpack_shards(flat, xs, num_lm: int) -> list:
    """The whole tensors in a sum of :func:`pack_shards` buffers, each in the
    dtype of its shard in ``xs``."""
    shapes = [(*x.shape[:-1], x.shape[-1] * num_lm) for x in xs]
    parts = flat.split([int(torch.Size(shape).numel()) for shape in shapes])
    out = []
    for x, part, shape in zip(xs, parts, shapes):
        whole = part.view(shape)
        if x.dtype == torch.bool:
            out.append(whole != 0)
        elif x.dtype in _BITS:
            out.append(whole.to(_BITS[x.dtype]).view(x.dtype))
        else:
            out.append(whole.to(x.dtype))
    return out


def gather_landmarks(xs, mesh: Mesh) -> list:
    """The whole landmark axis (the last) of each of this rank's shards
    ``xs``, on every rank of its ``lm`` group, equal to the unsharded tensors
    to the bit: the group's all-reduce of their :func:`pack_shards` buffers.
    ``xs`` themselves on one rank."""
    if not _sharded(mesh):
        return list(xs)
    flat = pack_shards(xs, mesh.lm_index, mesh.num_lm)
    dist.all_reduce(flat, group=mesh.lm_group)
    return unpack_shards(flat, xs, mesh.num_lm)


def _point_status_gathered(window: Window, ev: Evaluation, lm_mask, opts: PBAOptions,
                           mesh: Mesh) -> PointStatus:
    """K11 (or its plain version on CPU tensors) on the evaluation and the
    landmark fields gathered over the group, then this rank's slice of its
    outputs: the threshold is the whole window's, equal to the bit to the
    unsharded one."""
    status = _point_status_from_ev_cuda if ev.energy_patch.is_cuda else \
        _point_status_from_ev_plain
    if not _sharded(mesh):
        return status(window, ev, lm_mask, opts)
    energy, ok, candidate, mask, idepth, baseline, outlier, opt_count = gather_landmarks(
        (ev.energy_patch, ev.ok, ev.status_candidate, lm_mask, window.lm_idepth,
         window.lm_baseline, window.lm_outlier, window.lm_opt_count), mesh)
    whole = window.replace(lm_idepth=idepth, lm_baseline=baseline, lm_outlier=outlier,
                           lm_opt_count=opt_count)
    ps = status(whole, ev._replace(energy_patch=energy, ok=ok, status_candidate=candidate),
                mask, opts)
    lo, hi = _shard_bounds(mask.shape[-1], mesh)
    return PointStatus(*(x[..., lo:hi].contiguous() for x in ps[:-1]), ps.threshold)


class LmShards(OneShard):
    """The landmark sums of :func:`pba._solve_loop_plain` over the ranks of a
    mesh's ``lm`` group (this rank's window a shard of :func:`place_window`);
    with one ``lm`` rank, the window's own."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def sum(self, *xs):
        """The sums of the scalars ``xs`` over the shards, in one float64
        all-reduce, each back in its dtype."""
        if not _sharded(self.mesh):
            return xs
        (total,) = _all_reduce([torch.stack([x.to(torch.float64) for x in xs])], self.mesh)
        return tuple(t.to(x.dtype) for t, x in zip(total, xs))

    def linearize(self, window: Window, model, ev: Evaluation, eps,
                  opts: PBAOptions) -> LinearSystem:
        if not _sharded(self.mesh):
            return _linearize_from_ev(window, model, ev, eps, opts)
        sys = _linearize_from_ev(window, model, ev, eps, _without_prior(opts))
        return _reduced_system(window, sys, eps, opts, self.mesh)

    def point_status(self, window: Window, model, opts: PBAOptions) -> PointStatus:
        lm_mask = active_lm_mask(window)
        ev = _evaluate(window, model, window.eps, window.lm_idepth, lm_mask, opts)
        return _point_status_gathered(window, ev, lm_mask, opts, self.mesh)


def pba_iteration_shard_map(window: Window, model, regularizer, opts: PBAOptions,
                            mesh: Mesh):
    """One LM iteration of a placed window (:func:`place_window`) with the
    all-reduced pose system → (eps' [K, 8] replicated, idepth' [K, N/lm] of
    the shard, step_sq, energy', n_valid'), the single-process step's
    quantities up to reduction order.  ``regularizer``: λ, a host float."""
    shards = LmShards(mesh)
    lm_mask = active_lm_mask(window)
    ev = _evaluate(window, model, window.eps, window.lm_idepth, lm_mask, opts)
    sys = shards.linearize(window, model, ev, window.eps, opts)
    eps_new, idepth_new, pose_sq, d_sq = _solve_step(window, sys, window.eps,
                                                     window.lm_idepth, regularizer, opts)
    # the energy at the candidate: the landmark sums over the shards, the
    # priors and the ledger once
    ev = _evaluate(window, model, eps_new, idepth_new, lm_mask, opts)
    d_sq, e_land, n_valid = shards.sum(d_sq, *_landmark_sums(ev))
    energy = _total_energy(window, e_land, eps_new, opts)
    return eps_new, idepth_new, pose_sq + d_sq, energy, n_valid


def _trial_sums(ev: Evaluation, mesh: Mesh):
    """(Σ patch energies, their positive count) of ``ev`` summed over the
    shards: float64 [2], as K10 takes them."""
    e = ev.energy_patch
    (pair,) = _all_reduce([torch.stack([e.sum(dtype=torch.float64),
                                        (e > 0).sum(dtype=torch.float64)])], mesh)
    return pair


def _step_sums(ev0: Evaluation, ev1: Evaluation, state, step_sq, mesh: Mesh):
    """After K9 and the trial's K7 inside the loop: the trial's sums (K10's
    pair) and its |idepth step|² summed over the shards in one float64
    all-reduce; the step's norm is written back into ``step_sq[1]``.  The
    trial is the evaluation buffer the state does not name carried, picked
    on the device."""
    e = torch.where(state[LM_CARRIED] == 1, ev0.energy_patch, ev1.energy_patch)
    (sums,) = _all_reduce([torch.stack([step_sq[1].to(torch.float64),
                                        e.sum(dtype=torch.float64),
                                        (e > 0).sum(dtype=torch.float64)])], mesh)
    step_sq[1:].copy_(sums[:1])
    return sums[1:]


def _solve_loop_issued(window: Window, model, opts: PBAOptions, mesh: Mesh,
                       log: list = None):
    """The solve of :func:`pba._solve_loop_cuda` on CUDA tensors, its fixed
    sequence (``csrc/ba_lm.cu::ba_solve_loop``) issued from Python with the
    collectives between the kernels: K7 on the initial state → the sums →
    K10's init; ``opts.max_iterations`` × (K8 → the system's all-reduce →
    K9 → K7 on the trial → the step's sums → K10's step); K10's finish, K7
    at the solved state and K11 on the gathered evaluation.  Every launch
    takes the loop's device state, as in the one C call; nothing is read on
    the host.  With one ``lm`` rank there is no collective, K10 sums the
    trial itself and K11 runs on the window: the one C call's launches, and
    its bits."""
    k, n, _, _ = _check_solve_window(window)
    c, m = window.num_channels, int(opts.max_iterations)
    dtype, dev = window.eps.dtype, window.eps.device
    sharded = _sharded(mesh)
    ev0 = _evaluation_buffers(k, n, c, dtype, dev)
    ev1 = _evaluation_buffers(k, n, c, dtype, dev)
    mask = torch.empty((k, n), dtype=torch.bool, device=dev)
    carried = _carried_state(window)
    state = torch.empty((LM_STATE_WORDS,), dtype=torch.int32, device=dev)
    lm_log = torch.empty((m + 2, LM_STATE_WORDS), dtype=torch.int32, device=dev)
    scratch, system = _linearize_buffers(k, n, dtype, dev)
    step = _solve_step_buffers(k, n, dtype, dev)
    energy = torch.empty((), dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    linearize_opts = _without_prior(opts) if sharded else opts

    _evaluate_launch(window, model, window.eps, window.lm_idepth, window.lm_valid, opts, None,
                     ev0, ev1, mask)
    _lm_phase(0, 0, window, opts, window.eps, window.lm_idepth, None, ev0, ev1, carried, state,
              lm_log, reduced=_trial_sums(ev0, mesh) if sharded else None)
    tq, tt, ab0, eps, idepth, lin_idepth, status = carried
    at = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0, lm_idepth=lin_idepth,
                        res_status=status)
    for it in range(1, m + 1):
        _linearize_launch(at, model, ev0, ev1, eps, linearize_opts, False, state, scratch,
                          system)
        sys = _reduced_system(at, system, eps, opts, mesh) if sharded else system
        eps_new, idepth_new, step_sq = _solve_step_launch(at, sys, eps, idepth, None, state,
                                                          step)
        _evaluate_launch(at, model, eps_new, idepth_new, window.lm_valid, opts, state, ev0, ev1)
        reduced = _step_sums(ev0, ev1, state, step_sq, mesh) if sharded else None
        _lm_phase(1, it, window, opts, eps_new, idepth_new, step_sq, ev0, ev1, carried, state,
                  lm_log, reduced=reduced)
    _lm_phase(2, m + 1, window, opts, eps, idepth, None, ev0, ev1, carried, state, lm_log,
              out=(energy, count))
    _evaluate_launch(at, model, eps, idepth, window.lm_valid, opts, None, ev0, ev1)
    solved = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0, eps=eps, lm_idepth=idepth,
                            res_status=status)
    ps = _point_status_gathered(solved, ev0, mask, opts, mesh)
    if log is not None:
        log.extend(lm_log_rows(lm_log))
    return _with_point_status(solved, ps), energy, count


def solve_loop_shard_map(window: Window, model, opts: PBAOptions, mesh: Mesh,
                         log: list = None):
    """The windowed LM solve of a placed window (:func:`place_window`) →
    (window' with this rank's landmark shard, energy, num_valid), as
    ``pba._solve_loop_device`` gives them for the whole window, up to the
    reduction order of the sums over the shards: on CUDA tensors the one C
    call's sequence issued with its collectives (:func:`_solve_loop_issued`),
    or the one C call itself on a mesh of one ``lm`` rank; on CPU tensors the
    host-driven plain loop with its landmark sums over the shards
    (:class:`LmShards`).  ``log`` receives the loop's state log."""
    if not window.maps.is_cuda:
        return _solve_loop_plain(window, model, opts, log, LmShards(mesh))
    if not _sharded(mesh):
        return _solve_loop_cuda(window, model, opts, log=log)
    return _solve_loop_issued(window, model, opts, mesh, log)


def marginalize_shard_map(window: Window, model, perm, opts: PBAOptions, mesh: Mesh) -> Window:
    """``pba._marginalize_device`` of a placed window: the marginalization
    pass (K7, K8) on this rank's flagged landmarks, its system and energy
    summed over the shards in one all-reduce with the flagged frames' priors
    added once, the ledger fold (K15, or its plain version on CPU tensors)
    on every rank alike, then the slots compacted by ``perm`` (the landmark
    fields along K only: local)."""
    if not _sharded(mesh):
        return _marginalize_device(window, model, perm, opts)
    fold = _marginalize_cuda if window.maps.is_cuda else _marginalize_system_plain
    sys, e_land = _marg_pass(window, model, _without_prior(opts))
    h_pose, b_pose, h_schur, b_schur, e_land = _all_reduce(
        (sys.h_pose, sys.b_pose, sys.h_schur, sys.b_schur, e_land), mesh)
    h_pr, b_pr = _prior_system(window, window.eps, opts, marg_pass=True)
    return _fold_and_permute(fold, window, h_pose + h_pr, b_pose + b_pr, h_schur, b_schur,
                             e_land, perm, opts)
