"""Many sequences over a mesh: the sequence-batched BA step, solve and fold,
and the batched tracker over ``seq`` ranks (counterpart of
``dsopp_tpu/parallel/sharded.py`` and of the JAX package's multi-chip
program, ``__graft_entry__.py::dryrun_multichip``).

The JAX module stacks B sequences' windows on a leading axis, annotates
their sharding — the sequence axis over the mesh's ``seq`` axis, the
landmark slots over ``lm`` — and lets XLA's SPMD partitioner insert the
all-reduces.  PyTorch has no SPMD partitioner, so the port makes the same
split explicit: :func:`shard_windows` gives this rank its ``seq``
coordinate's share of the B sequences, each as its landmark shard
(:func:`shard_map_ba.place_window`); :func:`batched_train_step` runs
:func:`shard_map_ba.pba_iteration_shard_map` (the explicit all-reduce of the
partial pose systems over the rank's ``lm`` group) for each of them, and
:func:`batched_solve_and_marginalize` the whole LM solve and the ledger
fold (:func:`shard_map_ba.solve_loop_shard_map`,
:func:`shard_map_ba.marginalize_shard_map`).  On one process without a
mesh they are the single-process functions for each sequence.
:func:`window_pspec` documents which fields shard along which axis.

:class:`SeqRankTracker` runs the tracker over the ``seq`` ranks: each rank
tracks its share of the B sequences in one
:class:`~dsopp_tpu_torch.tracker.batched_loop.BatchedPipelinedTracker`, a
tick makes no collective (the sequences are independent), and at the end
the trajectories are gathered over the mesh's ``seq`` group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from dsopp_tpu_torch.parallel.mesh import LM_AXIS, SEQ_AXIS, Mesh, rank_device
from dsopp_tpu_torch.parallel.shard_map_ba import (LM_FIELDS, RES_FIELDS,
                                                   marginalize_shard_map,
                                                   pba_iteration_shard_map, place_window,
                                                   solve_loop_shard_map)
from dsopp_tpu_torch.solvers.pba import (PBAOptions, Window, _energy, _marginalize_device,
                                         _pba_iteration, _solve_loop_device, active_lm_mask,
                                         marginalize_sequences, sequence_list, slot_mask,
                                         solve_loop_sequences, stack_size, stack_windows,
                                         window_at)


def window_pspec(batched: bool = True) -> dict:
    """{field: its axes' mesh axes} of a (stacked) Window: the landmark axis
    N of the ``lm_*`` fields and ``res_status`` over ``lm``, everything else
    replicated within a sequence; with ``batched`` the leading sequence axis
    over ``seq``."""
    s = (SEQ_AXIS,) if batched else ()
    spec = {}
    for f in dataclasses.fields(Window):
        if f.name in LM_FIELDS:
            spec[f.name] = s + (None, LM_AXIS)
        elif f.name in RES_FIELDS:
            spec[f.name] = s + (None, None, LM_AXIS)
        else:
            spec[f.name] = s
    return spec


def _local_sequences(batch: int, mesh: Mesh) -> range:
    """This rank's share of B sequences: its ``seq`` coordinate's block."""
    if batch % mesh.num_seq:
        raise ValueError(f"{batch} sequences do not split over {mesh.num_seq} seq ranks")
    per = batch // mesh.num_seq
    return range(mesh.seq_index * per, (mesh.seq_index + 1) * per)


def shard_windows(windows: Window, mesh: Mesh) -> Window:
    """This rank's part of a stacked Window (leading B axis): its ``seq``
    coordinate's sequences, each as its ``lm`` coordinate's landmark shard."""
    return stack_windows([place_window(window_at(windows, b), mesh)
                          for b in _local_sequences(windows.t_lin_q.shape[0], mesh)])


def _single_step(window: Window, model, regularizer, opts: PBAOptions):
    """One LM iteration and the energy at its candidate, one sequence →
    (eps, idepth, energy, n_valid, step_sq)."""
    lm_mask = active_lm_mask(window)
    eps, idepth, step_sq = _pba_iteration(window, model, window.eps, window.lm_idepth,
                                          lm_mask, regularizer, opts)
    energy, n_valid, _ = _energy(window, model, eps, idepth, lm_mask, opts)
    return eps, idepth, energy, n_valid, step_sq


def batched_train_step(windows: Window, model, regularizer, opts: PBAOptions = PBAOptions(),
                       mesh: Mesh = None):
    """One BA iteration over a batch of sequences → (eps [B, K, 8], idepth
    [B, K, N], energy [B], n_valid [B], step_sq [B]).

    Without ``mesh``: ``windows`` holds all B sequences, each stepped by
    :func:`_single_step`.  With one: ``windows`` is this rank's part
    (:func:`shard_windows`), each sequence stepped by the all-reduced
    landmark-sharded iteration, and the results are this rank's sequences'
    (idepth: its landmark shard)."""
    batch = windows.t_lin_q.shape[0]
    outs = []
    for b in range(batch):
        window = window_at(windows, b)
        if mesh is None:
            outs.append(_single_step(window, model, regularizer, opts))
        else:
            eps, idepth, step_sq, energy, n_valid = pba_iteration_shard_map(
                window, model, regularizer, opts, mesh)
            outs.append((eps, idepth, energy, n_valid, step_sq))
    return tuple(torch.stack(xs) for xs in zip(*outs))


# the slot the JAX tests' solve_and_marginalize marginalizes: the oldest frame
# that is not fixed
MARGINALIZED_SLOT = 1


def solve_and_marginalize(window: Window, model, opts: PBAOptions = PBAOptions(),
                          mesh: Mesh = None):
    """The JAX tests' ``solve_and_marginalize`` of one sequence
    (``tests/parallel/test_sharded_solver.py:48-58``) → (window', energy,
    num_valid): the windowed LM solve, then slot ``MARGINALIZED_SLOT`` and
    its live landmarks flagged and folded into the ledger with the
    kept-first slot permutation.  With ``mesh``, ``window`` is this rank's
    landmark shard and both steps run sharded over its ``lm`` group."""
    if mesh is None:
        window, energy, n_valid = _solve_loop_device(window, model, opts)
    else:
        window, energy, n_valid = solve_loop_shard_map(window, model, opts, mesh)
    return marginalize_slot(window, model, opts, mesh), energy, n_valid


def marginalize_slot(window: Window, model, opts: PBAOptions = PBAOptions(),
                     mesh: Mesh = None) -> Window:
    """The fold of :func:`solve_and_marginalize`: slot ``MARGINALIZED_SLOT``
    and its live landmarks flagged, folded into the ledger
    (``pba._marginalize_device``, or sharded over ``mesh``'s ``lm`` group)
    and the slots compacted kept-first."""
    from dsopp_tpu_torch.tracker.marginalization import kept_first_perm

    frame_flags = slot_mask(window.num_slots, MARGINALIZED_SLOT, window.frame_valid.device)
    window = window.replace(frame_marg=frame_flags,
                            lm_marg_flag=window.lm_valid & frame_flags[:, None])
    perm = kept_first_perm(window.frame_valid, frame_flags)
    if mesh is None:
        return _marginalize_device(window, model, perm, opts)
    return marginalize_shard_map(window, model, perm, opts, mesh)


def solve_and_marginalize_sequences(windows: Window, model, opts: PBAOptions = PBAOptions(),
                                    seqs=None):
    """:func:`solve_and_marginalize` of the sequences ``seqs`` (a host list;
    None: all) of a stacked window, one process, in one solve call and one
    fold call for all of them (on the card each kernel one launch for the S
    sequences) → (the S windows', a [S] stack of new tensors, energy [S],
    num_valid [S])."""
    from dsopp_tpu_torch.tracker.marginalization import kept_first_perm

    batch = stack_size(windows)
    seqs = sequence_list(seqs, batch)
    solved, energy, n_valid = solve_loop_sequences(windows, model, opts, seqs)
    if seqs != tuple(range(batch)):
        windows = stack_windows([window_at(windows, b) for b in seqs])
    k = windows.t_lin_q.shape[1]
    frame_flags = slot_mask(k, MARGINALIZED_SLOT, windows.frame_valid.device).expand(
        len(seqs), k).contiguous()
    windows = windows.replace(**solved, frame_marg=frame_flags,
                              lm_marg_flag=windows.lm_valid & frame_flags[..., None])
    perm = kept_first_perm(windows.frame_valid, frame_flags)
    return marginalize_sequences(windows, model, perm, opts), energy, n_valid


def batched_solve_and_marginalize(windows: Window, model, opts: PBAOptions = PBAOptions(),
                                  mesh: Mesh = None):
    """:func:`solve_and_marginalize` over a batch of sequences, the JAX tests'
    ``jax.vmap`` of it → (stacked windows', energy [B], num_valid [B]).
    Without ``mesh``, or on a mesh without landmark shards: ``windows`` holds
    this process's sequences, solved in one call and folded in one call
    (:func:`solve_and_marginalize_sequences`).  With ``lm`` ranks:
    ``windows`` is this rank's part (:func:`shard_windows`), each sequence
    solved and folded across the rank's ``lm`` group, and the results are
    its part too (the landmark fields: its shard)."""
    if mesh is None or mesh.num_lm == 1:
        return solve_and_marginalize_sequences(windows, model, opts)
    outs = [solve_and_marginalize(window_at(windows, b), model, opts, mesh)
            for b in range(windows.t_lin_q.shape[0])]
    return (stack_windows([w for w, _, _ in outs]), torch.stack([e for _, e, _ in outs]),
            torch.stack([n for _, _, n in outs]))


class SeqRankTracker:
    """B sequences tracked over the ``seq`` ranks of a mesh (the JAX package's
    ``__graft_entry__.py::_dryrun_tracked_segment``: B sequences sharded over
    ``seq``, each running the batched tick).

    ``make_tracker(b, device)`` returns sequence b's bootstrapped
    :class:`~dsopp_tpu_torch.tracker.monocular.MonocularTracker`; this rank
    makes those of its share (:attr:`sequences`, its ``seq`` coordinate's
    block) on its device (:func:`mesh.rank_device`: the card ``LOCAL_RANK``
    names under nccl, the shared card under gloo, or ``device``) and runs
    them in one :class:`~dsopp_tpu_torch.tracker.batched_loop.BatchedPipelinedTracker`.
    :meth:`tick` takes this rank's sequences' frames and makes no
    collective; :meth:`finalize` gathers every sequence's trajectory over
    the mesh's ``seq`` group.  The tracker shards sequences only: a mesh
    with ``lm`` ranks is refused."""

    def __init__(self, make_tracker, batch: int, mesh: Mesh, device=None):
        from dsopp_tpu_torch.tracker.batched_loop import BatchedPipelinedTracker

        if mesh.num_lm != 1:
            raise ValueError(f"the tracker shards sequences only: a {mesh.num_seq} x "
                             f"{mesh.num_lm} mesh has lm ranks")
        self.mesh = mesh
        self.device = rank_device(device)
        self.sequences = _local_sequences(batch, mesh)
        self.pipe = BatchedPipelinedTracker([make_tracker(b, self.device)
                                             for b in self.sequences])
        self.frame_ids, self.timestamps, self.poses, self.keyframes = [], [], [], []

    def tick(self, frame_ids, timestamps, images, force_keyframes=None, exposures=None):
        """Advance this rank's sequences by one frame (their ids, timestamps,
        [b, H, W] frames, as ``BatchedPipelinedTracker.tick`` takes them)."""
        diag = self.pipe.tick(frame_ids, timestamps, images, force_keyframes, exposures)
        self.frame_ids.append(list(frame_ids))
        self.timestamps.append(list(timestamps))
        self.poses.append(torch.cat([diag.pose_q, diag.pose_t], dim=-1))
        self.keyframes.append(diag.is_keyframe)
        return diag

    def finalize(self) -> list:
        """Write each sequence's state back into its tracker, then gather →
        every sequence's trajectory on every rank of the ``seq`` group, in
        sequence order: dicts of ``sequence``, its tick poses ``poses`` [T,
        7] (q w-first, t; numpy, the window's dtype), ``frame_ids``,
        ``timestamps``, ``keyframes`` ([T] bool) and the track's full-rate
        ``trajectory`` (timestamps [M] and T_wc [M, 4, 4], the window's
        BA-refined keyframes with their attached frames)."""
        trackers = self.pipe.finalize()
        poses = torch.stack(self.poses, dim=1).cpu().numpy() if self.poses else None
        local = []
        for j, (b, tracker) in enumerate(zip(self.sequences, trackers)):
            entries = tracker.track.trajectory(tracker.window)
            local.append(dict(
                sequence=b, poses=None if poses is None else poses[j],
                frame_ids=np.asarray([f[j] for f in self.frame_ids], np.int64),
                timestamps=np.asarray([t[j] for t in self.timestamps], np.float64),
                keyframes=np.asarray([k[j] for k in self.keyframes], bool),
                trajectory=(np.asarray([t for t, _ in entries], np.float64),
                            np.asarray([m for _, m in entries], np.float64))))
        if self.mesh.seq_group is None:
            return local
        shares = [None] * self.mesh.num_seq
        dist.all_gather_object(shares, local, group=self.mesh.seq_group)
        return [entry for share in shares for entry in share]
