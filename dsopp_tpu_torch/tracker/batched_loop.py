"""Batched multi-sequence tracking: B independent odometry streams on one card
(counterpart of ``dsopp_tpu/tracker/batched_loop.py``).

One sequence's tick is latency-bound: small tensors, long chains of short
kernels, and on the card the host's time around them (``PERF.md`` §5).  B
sequences in one tick make the same launches and run the same torch
operators as one: the regular tick's glue (``tracker/fused_tick.py``)
carries a leading ``[B]`` sequence axis, K1 builds the B frames' pyramids in
one launch, K3 runs every sequence's hypotheses in one launch a level (each
hypothesis with its sequence's index), K4 and K5 take the B sequences on a
grid axis, and the tick copies K5's ``[B, STATS]`` statistics to the host
once (with the re-track armed, the ``[B]`` gate flags once more).  The
re-track's chunks 1..21 run in one chain for the sequences that escalated
only (the JAX package runs them for every sequence and selects, as
``lax.cond`` under ``vmap`` is a select).

The keyframe backend runs :func:`device_loop.keyframe_update`'s three
phases once each for the S sequences whose keyframe decision (or forced
keyframe) is set, every kernel one launch for all S (the solo
``keyframe_update`` runs the same three functions on a stack of one):

1. the push, the immature banks (K12), the activation (K13) and the
   refinement and pairing (K14), with at C > 1 the S keyframes' embedder
   channels in one convolution and their maps in one K1 launch
   (``fused_keyframe.keyframe_front_sequences``);
2. the windowed BA solve (K7–K11 in one C call), the batch's new affine and
   poses, the min-distance controller, the marginalization policy (K15p),
   the snapshot, the marginalization pass (K7, K8) and the ledger fold
   (K15), the compaction and the immature banks' permutation
   (``device_loop.keyframe_solver_sequences``);
3. the frontend depth maps and point sets (K16,
   ``depth_map.build_frontend_state_sequences``).

Each reads the stacked state and the tick's [B, ...] pyramid through the
list of the S sequences; where only some of the B sequences keyframe, their
rows of the stack are written in place (the push and the new banks at each
sequence's slot, the other outputs one ``index_copy_`` a field; the stacked
``maps`` keeps its storage), and where all of them do, the phases return
new tensors.

Semantics: there is no interaction between sequences.  Each kernel runs a
sequence's work with the arithmetic and reduction order of its own launch,
so sequence b's trajectory is the one ``device_tick`` gives it alone, as far
as the torch operators of the glue give the same bits on a ``[B]`` batch as
on one sequence.  ``models``, ``mask`` and ``cfg`` are shared by the batch;
the state, image, frame id, forced flag and exposure are per sequence.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import torch

from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.solvers.pba import Window, _device_sequences, into_sequences, newest_slot
from dsopp_tpu_torch.solvers.pose_alignment import LevelPoints
from dsopp_tpu_torch.tracker.device_loop import (DeviceLoopConfig, DeviceTrackerState,
                                                 PipelinedTracker, TickDiag,
                                                 keyframe_embeddings, keyframe_solver_sequences,
                                                 with_rows)
from dsopp_tpu_torch.tracker.depth_map import (STAT_KF_RMSE, STAT_NEED, STAT_RMSE_LAST0,
                                               build_frontend_state_sequences)
from dsopp_tpu_torch.tracker.fused_keyframe import keyframe_front_sequences
from dsopp_tpu_torch.tracker.fused_tick import fused_regular_tick

# TickDiag's fields that only a keyframe fills (None in a regular frame's
# sequence view)
_KEYFRAME_FIELDS = TickDiag._fields[TickDiag._fields.index("energy"):-1]


def _tree_map(fn, *trees):
    """``fn`` over the tensors of equally shaped states (named tuples, tuples,
    the Window dataclass; None stays None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, Window):
        return Window(**{f.name: _tree_map(fn, *(getattr(t, f.name) for t in trees))
                         for f in dataclasses.fields(Window)})
    if hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"unexpected state leaf {type(first).__name__}")


def stack_states(states: List[DeviceTrackerState]) -> DeviceTrackerState:
    """One state whose tensors carry a leading [B] axis, stored contiguously."""
    return _tree_map(lambda *xs: torch.stack(xs), *states)


def unstack_state(states: DeviceTrackerState, b: int) -> DeviceTrackerState:
    """Sequence ``b``'s state: views of the stacked tensors, not copies."""
    return _tree_map(lambda x: x[b], states)


class BatchedTickDiag(NamedTuple):
    """One batched tick's diagnostics: the frontend's values of every
    sequence ([B, ...] tensors), the host's flags, and the keyframe backend's
    diagnostics of the sequences that took a keyframe."""

    is_keyframe: tuple          # B bools
    escalated: tuple            # B bools
    rmse_chunk0: torch.Tensor   # [B]
    pose_q: torch.Tensor        # [B, 4]
    pose_t: torch.Tensor        # [B, 3]
    affine: torch.Tensor        # [B, 2]
    rmse: torch.Tensor          # [B]
    flow: torch.Tensor          # [B]
    flow_no_rot: torch.Tensor   # [B]
    num_valid_align: torch.Tensor  # [B] int32
    t_kf_frame_mat: torch.Tensor   # [B, 4, 4]
    min_distance: torch.Tensor  # [B], after the tick
    host_stats: object          # [B, STATS] numpy, or None when every keyframe was forced
    keyframes: tuple            # B entries: the sequence's keyframe TickDiag, or None

    def sequence(self, b: int) -> TickDiag:
        """Sequence ``b``'s :class:`TickDiag` (views).  A regular frame's
        keyframe fields are None (``device_tick`` fills them with zeros)."""
        if self.keyframes[b] is not None:
            return self.keyframes[b]
        return TickDiag(
            is_keyframe=False, escalated=self.escalated[b], rmse_chunk0=self.rmse_chunk0[b],
            pose_q=self.pose_q[b], pose_t=self.pose_t[b], affine=self.affine[b],
            rmse=self.rmse[b], flow=self.flow[b], flow_no_rot=self.flow_no_rot[b],
            num_valid_align=self.num_valid_align[b], t_kf_frame_mat=self.t_kf_frame_mat[b],
            **{name: None for name in _KEYFRAME_FIELDS},
            host_stats=None if self.host_stats is None else self.host_stats[b])._replace(
                min_distance=self.min_distance[b])


def batched_device_tick(states: DeviceTrackerState, images, frame_ids, force_kfs, models,
                        mask, cfg: DeviceLoopConfig, exposures=None):
    """One tracked frame for B sequences → (states', :class:`BatchedTickDiag`).

    ``states``: a stacked state (:func:`stack_states`); it is consumed (where
    only some sequences keyframe, their rows are written in place), as the
    JAX entry point donates it.  ``images``: [B, H, W] on the state's device; ``frame_ids``,
    ``force_kfs``: B host ints and bools; ``exposures``: B host floats
    (default 1.0); ``models``, ``mask`` (a [H, W] CameraMask or None) and
    ``cfg`` are shared."""
    window = states.window
    batch = images.shape[0]
    dtype, dev = images.dtype, images.device
    forced = tuple(bool(f) for f in force_kfs)
    if len(forced) != batch or len(frame_ids) != batch:
        raise ValueError(f"{batch} images, {len(frame_ids)} frame ids, {len(forced)} flags")
    if exposures is None:
        exposure = torch.full((batch,), 1.0, dtype=dtype, device=dev)
    else:
        exposure = torch.tensor([float(e) for e in exposures], dtype=dtype, device=dev)
    poses = window.poses()
    out = fused_regular_tick(
        images, states.level_points, states.flow_points, poses.q, poses.t,
        window.affine(), window.exposure, exposure, newest_slot(window), states.immature,
        states.last_q, states.last_t, states.prev_q, states.prev_t, states.last_affine,
        models, cfg.align_opts, cfg.with_perturbations, cfg.num_levels, cfg.huber_sigma,
        states.rmse_last0, states.kf_rmse, cfg.keyframe_factor, forced)
    host = None
    if not all(forced):
        host = out.stats.cpu().numpy()      # the tick's one copy of [B, STATS]
    need = tuple(f or bool(host[b, STAT_NEED]) for b, f in enumerate(forced))

    t_w_t = SE3(out.pose_q, out.pose_t)
    t_prev_rel = SE3(states.last_q, states.last_t).inverse() @ t_w_t
    base = states._replace(immature=out.immature, last_q=t_w_t.q, last_t=t_w_t.t,
                           prev_q=t_prev_rel.q, prev_t=t_prev_rel.t, last_affine=out.affine,
                           rmse_last0=out.stats[:, STAT_RMSE_LAST0],
                           kf_rmse=out.stats[:, STAT_KF_RMSE])
    keyframes = [None] * batch
    seqs = tuple(b for b in range(batch) if need[b])
    if seqs:
        if seqs == tuple(range(batch)):
            pick = lambda x: x                                           # noqa: E731
        else:
            rows = _device_sequences(seqs, dev, torch.int64)
            pick = lambda x: x.index_select(0, rows)                     # noqa: E731
        front = keyframe_front_sequences(
            base.window, models[0], base.immature, out.maps[0], seqs, pick(out.pose_q),
            pick(out.pose_t), pick(out.affine), tuple(int(frame_ids[b]) for b in seqs),
            base.min_distance, pick(exposure), cfg.refine, cfg.huber_sigma,
            cfg.immature_per_frame, mask=mask,
            embed=keyframe_embeddings(pick(out.maps[0])[:, 0], cfg))
        half = keyframe_solver_sequences(front.window, front.immature, base.min_distance, seqs,
                                         front.slot, front.n_active, models[0], cfg)
        idep, wei, points, flow_pts = build_frontend_state_sequences(
            half.window, models[0], out.maps, seqs, cfg.height, cfg.width, cfg.num_levels,
            cfg.frontend_points)

        def put(x, value):
            return into_sequences(x, seqs, value)

        base = base._replace(
            window=half.window, immature=half.immature,
            depth_idepth=tuple(map(put, base.depth_idepth, idep)),
            depth_weight=tuple(map(put, base.depth_weight, wei)),
            level_points=tuple(LevelPoints(*map(put, x, v))
                               for x, v in zip(base.level_points, points)),
            flow_points=LevelPoints(*map(put, base.flow_points, flow_pts)),
            min_distance=with_rows(base.min_distance, seqs, half.min_distance),
            last_affine=with_rows(base.last_affine, seqs, half.new_affine))
        for z, b in enumerate(seqs):
            keyframes[b] = TickDiag(
                is_keyframe=True, escalated=out.escalated[b], rmse_chunk0=out.rmse_chunk0[b],
                pose_q=out.pose_q[b], pose_t=out.pose_t[b], affine=out.affine[b],
                rmse=out.rmse[b], flow=out.flow[b], flow_no_rot=out.flow_no_rot[b],
                num_valid_align=out.num_valid[b], t_kf_frame_mat=out.t_kf_frame_mat[b],
                energy=half.energy[z], num_valid_solve=half.num_valid[z],
                n_active=front.n_active[z], n_activated=front.n_activated[z],
                min_distance=half.min_distance[z],
                **{name: x[z] for name, x in half.snap.items()},
                host_stats=None if host is None else host[b])
    diag = BatchedTickDiag(
        is_keyframe=need, escalated=out.escalated, rmse_chunk0=out.rmse_chunk0,
        pose_q=out.pose_q, pose_t=out.pose_t, affine=out.affine, rmse=out.rmse,
        flow=out.flow, flow_no_rot=out.flow_no_rot, num_valid_align=out.num_valid,
        t_kf_frame_mat=out.t_kf_frame_mat, min_distance=base.min_distance, host_stats=host,
        keyframes=tuple(keyframes))
    return base, diag


class BatchedPipelinedTracker:
    """The host loop of B concurrent sequences on one card.

    Wraps B initialized :class:`~dsopp_tpu_torch.tracker.monocular.MonocularTracker`\\ s
    sharing one camera model and configuration; every ``tick`` runs one
    :func:`batched_device_tick`, and the per-sequence diagnostics are drained
    in batches into each tracker's host track through
    :meth:`PipelinedTracker._bookkeep`, as :class:`PipelinedTracker` does for
    one; ``finalize`` writes each sequence's state back."""

    def __init__(self, trackers, flush_every: int = 16):
        if not trackers:
            raise ValueError("need at least one tracker")
        self.pipes = [PipelinedTracker(t, flush_every=10 ** 9) for t in trackers]
        cfgs = {p.cfg for p in self.pipes}
        if len(cfgs) != 1:
            raise ValueError("all trackers must share one config")
        first = self.pipes[0]
        if any((p.dtype, p.device) != (first.dtype, first.device) for p in self.pipes):
            raise ValueError("all trackers must share one dtype and device")
        self.cfg = first.cfg
        self.models = first.models
        self.mask = first.mask
        self.dtype = first.dtype
        self.device = first.device
        self.states = stack_states([p.state for p in self.pipes])
        self.flush_every = flush_every
        self.pending = []   # (frame_ids, timestamps, BatchedTickDiag)

    @property
    def batch(self) -> int:
        return len(self.pipes)

    def tick(self, frame_ids, timestamps, images, force_keyframes=None, exposures=None):
        """Advance every sequence by one frame.

        ``frame_ids``: B ints; ``timestamps``: B floats; ``images``: a [B, H,
        W] tensor or B [H, W] images; ``force_keyframes``: B bools;
        ``exposures``: B exposure times (default 1.0)."""
        b = self.batch
        if force_keyframes is None:
            force_keyframes = [False] * b
        if isinstance(images, torch.Tensor) and images.dim() == 3:
            images = images.to(self.device, self.dtype)
        else:
            images = torch.stack([torch.as_tensor(im, dtype=self.dtype, device=self.device)
                                  for im in images])
        self.states, diag = batched_device_tick(
            self.states, images, list(frame_ids), list(force_keyframes), self.models,
            self.mask, self.cfg, exposures=exposures)
        self.pending.append((list(frame_ids), list(timestamps), diag))
        if len(self.pending) >= self.flush_every:
            self.drain()
        return diag

    def drain(self):
        """Fold the queued diagnostics into each sequence's host track."""
        pending, self.pending = self.pending, []
        for fids, tss, diag in pending:
            for b, pipe in enumerate(self.pipes):
                pipe._bookkeep(fids[b], tss[b], diag.sequence(b))

    def finalize(self):
        """Drain bookkeeping and write each sequence's state back (its views
        of the stacked state) into its tracker → the trackers."""
        self.drain()
        out = []
        for b, pipe in enumerate(self.pipes):
            pipe.state = unstack_state(self.states, b)
            out.append(pipe.finalize())
        return out
