"""The landmark-sharded BA iteration with explicit collectives (counterpart
of ``dsopp_tpu/parallel/shard_map_ba.py``).

Each rank of a mesh's ``lm`` group holds its shard of the window's landmark
slots (:func:`place_window`), evaluates its residuals (K7) and linearizes
them (K8) into partial (K·8)² photometric systems and its landmarks' Schur
terms.  The group all-reduces ``h_pose``, ``b_pose``, ``h_schur`` and
``b_schur`` — the only communication of the solve — adds the frame priors
once, and every rank solves the small dense pose system alike (K9); the
idepth back-substitution stays shard-local.  The step's |idepth step|², the
landmark energy and the valid count are all-reduced too.  This replaces the
reference's mutex-merged TBB accumulators with one all-reduce of the
partial systems, as the JAX module's ``psum`` over its ``lm`` axis does.

The ledger is f64 in the port, so the replicated energy (priors and the
marginalized quadratic) is plain f64 arithmetic, with no double-float
pairs.  Results equal the single-process step's up to the reduction order
of the all-reduced sums.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from dsopp_tpu_torch.parallel.mesh import Mesh
from dsopp_tpu_torch.solvers.pba import (LEDGER_DTYPE, PBAOptions, Window, _evaluate,
                                         _linearize, _prior_energy, _prior_system,
                                         _solve_step, active_lm_mask)

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


def _all_reduce(x, mesh: Mesh):
    """The sum of ``x`` over the rank's ``lm`` group (``x`` itself on one
    rank), on the device where ``x`` lies (gloo takes CUDA tensors: chip_smoke
    ``[parallel]``)."""
    if mesh.lm_group is None or mesh.num_lm == 1:
        return x
    y = x.reshape(-1).clone()
    dist.all_reduce(y, group=mesh.lm_group)
    return y.reshape(x.shape)


def _replicated_energy(window: Window, eps, opts: PBAOptions):
    """Prior + marginalized-quadratic energy (the same on every shard), with
    the ledger's quadratic in f64 as ``pba._energy_from_ev`` forms it."""
    s = eps.reshape(-1).to(LEDGER_DTYPE)
    e_marg = (window.energy_marg + window.b_marg @ s) + 0.5 * (s @ (window.h_marg @ s))
    return _prior_energy(window, eps, opts) + e_marg.to(eps.dtype)


def pba_iteration_shard_map(window: Window, model, regularizer, opts: PBAOptions,
                            mesh: Mesh):
    """One LM iteration of a placed window (:func:`place_window`) with the
    all-reduced pose system → (eps' [K, 8] replicated, idepth' [K, N/lm] of
    the shard, step_sq, energy', n_valid'), the single-process step's
    quantities up to reduction order.  ``regularizer``: λ, a host float."""
    lm_mask = active_lm_mask(window)
    sys = _linearize(window, model, window.eps, window.lm_idepth, lm_mask, opts,
                     with_prior=False)
    h_pose, b_pose, h_schur, b_schur = (_all_reduce(x, mesh) for x in (
        sys.h_pose, sys.b_pose, sys.h_schur, sys.b_schur))
    # the priors are frame-indexed (replicated): added once, after the sum
    h_pr, b_pr = _prior_system(window, window.eps, opts)
    sys = sys._replace(h_pose=h_pose + h_pr, b_pose=b_pose + b_pr, h_schur=h_schur,
                       b_schur=b_schur)
    eps_new, idepth_new, pose_sq, d_sq = _solve_step(window, sys, window.eps,
                                                     window.lm_idepth, regularizer, opts)
    step_sq = pose_sq + _all_reduce(d_sq, mesh)
    # the energy at the candidate: the landmark sums over the shards, the
    # priors and the ledger once
    ev = _evaluate(window, model, eps_new, idepth_new, lm_mask, opts)
    e_land = _all_reduce(torch.sum(ev.energy_patch), mesh)
    n_valid = _all_reduce(torch.sum(ev.energy_patch > 0), mesh)
    energy = e_land + _replicated_energy(window, eps_new, opts)
    return eps_new, idepth_new, step_sq, energy, n_valid
