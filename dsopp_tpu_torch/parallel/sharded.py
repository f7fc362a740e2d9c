"""The sequence-batched BA step over a mesh (counterpart of
``dsopp_tpu/parallel/sharded.py``).

The JAX module stacks B sequences' windows on a leading axis, annotates
their sharding — the sequence axis over the mesh's ``seq`` axis, the
landmark slots over ``lm`` — and lets XLA's SPMD partitioner insert the
all-reduces.  PyTorch has no SPMD partitioner, so the port makes the same
split explicit: :func:`shard_windows` gives this rank its ``seq``
coordinate's share of the B sequences, each as its landmark shard
(:func:`shard_map_ba.place_window`), and :func:`batched_train_step` runs
:func:`shard_map_ba.pba_iteration_shard_map` (the explicit all-reduce of the
partial pose systems over the rank's ``lm`` group) for each of them.  On one
process without a mesh it is the plain composition of ``pba._pba_iteration``
and ``pba._energy`` for each sequence.  :func:`window_pspec` documents which
fields shard along which axis.
"""

from __future__ import annotations

import dataclasses

import torch

from dsopp_tpu_torch.parallel.mesh import LM_AXIS, SEQ_AXIS, Mesh
from dsopp_tpu_torch.parallel.shard_map_ba import (LM_FIELDS, RES_FIELDS,
                                                   pba_iteration_shard_map, place_window)
from dsopp_tpu_torch.solvers.pba import (PBAOptions, Window, _energy, _pba_iteration,
                                         active_lm_mask)


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


def stack_windows(windows) -> Window:
    """Stack same-shape Windows on a new leading axis."""
    return Window(**{f.name: (None if getattr(windows[0], f.name) is None else
                              torch.stack([getattr(w, f.name) for w in windows]))
                     for f in dataclasses.fields(Window)})


def _window_at(windows: Window, b: int) -> Window:
    return Window(**{f.name: (None if getattr(windows, f.name) is None else
                              getattr(windows, f.name)[b])
                     for f in dataclasses.fields(Window)})


def _local_sequences(batch: int, mesh: Mesh) -> range:
    """This rank's share of B sequences: its ``seq`` coordinate's block."""
    if batch % mesh.num_seq:
        raise ValueError(f"{batch} sequences do not split over {mesh.num_seq} seq ranks")
    per = batch // mesh.num_seq
    return range(mesh.seq_index * per, (mesh.seq_index + 1) * per)


def shard_windows(windows: Window, mesh: Mesh) -> Window:
    """This rank's part of a stacked Window (leading B axis): its ``seq``
    coordinate's sequences, each as its ``lm`` coordinate's landmark shard."""
    return stack_windows([place_window(_window_at(windows, b), mesh)
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
        window = _window_at(windows, b)
        if mesh is None:
            outs.append(_single_step(window, model, regularizer, opts))
        else:
            eps, idepth, step_sq, energy, n_valid = pba_iteration_shard_map(
                window, model, regularizer, opts, mesh)
            outs.append((eps, idepth, energy, n_valid, step_sq))
    return tuple(torch.stack(xs) for xs in zip(*outs))
