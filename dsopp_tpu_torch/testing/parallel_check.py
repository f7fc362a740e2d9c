"""Gloo worlds of processes running the sharded BA and the ``seq``-rank
tracker (the CPU tests' 4-rank meshes and chip_smoke's two ranks on one
card).

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``, each
joining a gloo group at ``tcp://localhost:<a free port>`` whose collectives
give up after ``timeout`` seconds, and running one task of this module on
the inputs in ``payload`` (a ``.npz`` of JAX window fields, ``window_*`` /
``window1_*``, and the camera ``cam_*``; or a ``.pt`` of port tensors), then
writing ``rank<r>.pt`` into ``out_dir``.  A task that raises on one rank
fails the spawn, which ends the other ranks.  Tasks:

* ``meshes`` (CPU, world 4): the 2 × 2 mesh (two sequences over ``seq``,
  two landmark shards each) through ``sharded.batched_train_step`` and
  ``sharded.batched_solve_and_marginalize``, and each of its rows stepping
  the first window through ``shard_map_ba.pba_iteration_shard_map``; the
  1 × 4 mesh through all three; ``make_hybrid_mesh`` with two "nodes" of
  two ranks (``LOCAL_WORLD_SIZE`` = 2) through ``batched_train_step``; and
  the 4 × 1 mesh tracking the four segment sequences (``sequences``, a
  ``.pt`` of :func:`segment_sequences`) with ``sharded.SeqRankTracker``;
* ``skip`` (world 2): rank 0 all-reduces, rank 1 never does;
* ``card`` (one card, world 2): the 1 × 2 mesh on CUDA tensors: one step,
  each rank's K7, K8 and K9 launches and its time three times after it
  (from a barrier of the two ranks to the step's end on the card); then the
  full solve and the fold (``sharded.solve_and_marginalize``) of each start
  window in ``payload["starts"]``, with its launches, LM log, host syncs and
  times; then K11 on the two shards of ``payload["status"]``'s evaluation;
* ``card_seq`` (one card, world 2): the 2 × 1 mesh tracking
  ``payload["batch"]`` offset copies of ``payload["seq"]`` at the standart
  point with ``sharded.SeqRankTracker``, timed, then profiled.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
import warnings

import numpy as np
import torch

REG = 1e-5   # the JAX tests' regularizer
# seconds a collective waits for the other ranks before it raises
COLLECTIVE_TIMEOUT = 120.0
# __graft_entry__.py::_dryrun_tracked_segment: the frames, the known-pose
# bootstrap's and the tracked ones
SEGMENT_HEIGHT, SEGMENT_WIDTH = 64, 80
SEGMENT_INIT, SEGMENT_FRAMES = 4, 20


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(world: int, task: str, payload: str, out_dir: str,
          timeout: float = COLLECTIVE_TIMEOUT, **options):
    """Run ``task`` on ``world`` gloo ranks (joined; raises if one fails)."""
    import torch.multiprocessing as mp

    port = free_port()
    mp.spawn(_worker, args=(world, port, task, payload, out_dir, timeout, options),
             nprocs=world, join=True)


def _worker(rank, world, port, task, payload, out_dir, timeout, options):
    import torch.distributed as dist

    from dsopp_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"tcp://localhost:{port}", world, rank, "gloo", timeout=timeout)
    try:
        out = TASKS[task](rank, payload, **options)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        # every rank's file is written before any process leaves
        dist.barrier()
    finally:
        dist.destroy_process_group()


def window_from_npz(data, prefix: str, device=None):
    """The port Window of the JAX window fields saved under ``prefix``."""
    from dsopp_tpu_torch import convert

    fields = {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}
    return convert.window(fields, device=device)


def camera_from_npz(data):
    from dsopp_tpu_torch import convert

    return convert.pinhole(*(float(data[f"cam_{k}"]) for k in ("fx", "fy", "cx", "cy")),
                           data["cam_size"])


def segment_config():
    """``_dryrun_tracked_segment``'s tracker configuration."""
    from dsopp_tpu_torch.tracker.monocular import TrackerConfig

    return TrackerConfig(num_frame_slots=6, landmarks_per_frame=32, immature_per_frame=64,
                         desired_points=120, frontend_points=200, keyframe_factor=3.0,
                         window_min=3, window_max=4, pyramid_levels=3,
                         use_rotation_perturbations=False)


def segment_sequences(batch: int = 4, device="cpu"):
    """``_dryrun_tracked_segment``'s sequences (f32): sequence b rendered with
    seed 3 + b, advancing 0.06 + 0.01 (b mod 3) a frame."""
    from dsopp_tpu_torch.testing import render_sequence

    return [render_sequence(num_frames=SEGMENT_INIT + SEGMENT_FRAMES, height=SEGMENT_HEIGHT,
                            width=SEGMENT_WIDTH, seed=3 + b, advance=0.06 + 0.01 * (b % 3),
                            dtype=torch.float32, device=device)
            for b in range(batch)]


def segment_tracker(seq, device):
    """A tracker of ``seq`` after the known-pose bootstrap on its first
    ``SEGMENT_INIT`` frames."""
    from dsopp_tpu_torch.tracker.monocular import MonocularTracker

    tracker = MonocularTracker(seq.camera, segment_config(), dtype=torch.float32, device=device)
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i].to(device),
                         seq.pose(i, torch.float32, device))
                        for i in range(SEGMENT_INIT)])
    return tracker


def track_segment(tracker, seqs, sequences) -> list:
    """Feed ``sequences`` (indices into ``seqs``) their ``SEGMENT_FRAMES``
    frames after the bootstrap through ``tracker`` (``BatchedPipelinedTracker``
    or ``SeqRankTracker``) → each tick's diagnostics."""
    diags = []
    for i in range(SEGMENT_INIT, SEGMENT_INIT + SEGMENT_FRAMES):
        diags.append(tracker.tick([i] * len(sequences),
                                  [float(seqs[b].timestamps[i]) for b in sequences],
                                  torch.stack([seqs[b].images[i] for b in sequences])))
    return diags


def _meshes(rank, payload, sequences):
    from dsopp_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh
    from dsopp_tpu_torch.parallel.shard_map_ba import pba_iteration_shard_map, place_window
    from dsopp_tpu_torch.parallel.sharded import (SeqRankTracker, batched_solve_and_marginalize,
                                                  batched_train_step, shard_windows,
                                                  stack_windows)
    from dsopp_tpu_torch.solvers.pba import PBAOptions

    data = np.load(payload)
    cam = camera_from_npz(data)
    windows = [window_from_npz(data, "window_"), window_from_npz(data, "window1_")]
    stacked = stack_windows(windows)
    opts = PBAOptions()
    out = {}
    mesh = make_mesh(2, 2)
    coords = (mesh.seq_index, mesh.lm_index)
    part = shard_windows(stacked, mesh)
    out["2x2"] = dict(coords=coords, step=batched_train_step(part, cam, REG, opts, mesh))
    out["2x2 shard_map"] = dict(coords=coords,
                                step=pba_iteration_shard_map(place_window(windows[0], mesh),
                                                             cam, REG, opts, mesh))
    out["2x2 solve"] = dict(coords=coords,
                            solve=batched_solve_and_marginalize(part, cam, opts, mesh))
    mesh = make_mesh(1, 4)
    coords = (mesh.seq_index, mesh.lm_index)
    part = shard_windows(stacked, mesh)
    out["1x4"] = dict(coords=coords,
                      step=pba_iteration_shard_map(place_window(windows[0], mesh), cam, REG,
                                                   opts, mesh))
    out["1x4 batched"] = dict(coords=coords,
                              step=batched_train_step(part, cam, REG, opts, mesh))
    out["1x4 solve"] = dict(coords=coords,
                            solve=batched_solve_and_marginalize(part, cam, opts, mesh))
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    mesh = make_hybrid_mesh()
    out["hybrid"] = dict(coords=(mesh.seq_index, mesh.lm_index), shape=mesh.shape,
                         step=batched_train_step(shard_windows(stacked, mesh), cam, REG,
                                                 opts, mesh))
    seqs = torch.load(sequences, weights_only=False)
    mesh = make_mesh(len(seqs), 1)
    t0 = time.perf_counter()
    tracker = SeqRankTracker(lambda b, device: segment_tracker(seqs[b], device), len(seqs),
                             mesh, device="cpu")
    track_segment(tracker, seqs, tracker.sequences)
    out["4x1 tracker"] = dict(coords=(mesh.seq_index, mesh.lm_index),
                              sequences=list(tracker.sequences),
                              trajectories=tracker.finalize(),
                              seconds=time.perf_counter() - t0)
    return out


def _skip(rank, payload):
    """A collective that one rank never joins: rank 0 all-reduces, rank 1
    waits far longer than the group's timeout."""
    import torch.distributed as dist

    if rank == 0:
        dist.all_reduce(torch.zeros(1))
    else:
        time.sleep(10 * COLLECTIVE_TIMEOUT)
    return {}


def _to(window, device):
    return window.__class__(**{k: (None if v is None else v.to(device))
                               for k, v in vars(window).items()})


def _synced(fn, on_card):
    """``fn()`` → (its result, ms to its end on the card)."""
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _counted_all_reduces(fn):
    """``fn()`` → (its result, the all-reduces it made, the ms this rank's
    host spent inside them)."""
    import torch.distributed as dist

    real, calls, spent = dist.all_reduce, [0], [0.0]

    def counted(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            calls[0] += 1
            spent[0] += time.perf_counter() - t0

    dist.all_reduce = counted
    try:
        out = fn()
    finally:
        dist.all_reduce = real
    return out, calls[0], 1e3 * spent[0]


def _card(rank, payload, device="cuda"):
    import torch.distributed as dist

    from dsopp_tpu_torch import kernels
    from dsopp_tpu_torch.parallel.mesh import make_mesh
    from dsopp_tpu_torch.parallel.shard_map_ba import (_point_status_gathered,
                                                       pba_iteration_shard_map, place_window,
                                                       solve_loop_shard_map)
    from dsopp_tpu_torch.parallel.sharded import marginalize_slot
    from dsopp_tpu_torch.solvers.pba import Evaluation

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        kernels.library()
    data = torch.load(payload, weights_only=False)
    model, opts = data["model"], data["opts"]
    mesh = make_mesh(1, 2)
    placed = place_window(_to(data["window"], device), mesh)
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_counts()
    step = pba_iteration_shard_map(placed, model, REG, opts, mesh)
    if on_card:
        torch.cuda.synchronize()
    counts = kernels.counts()
    # the step again, timed from both ranks' barrier to the end of its sums
    times = []
    for _ in range(3):
        dist.barrier(group=mesh.lm_group)
        times.append(_synced(lambda: pba_iteration_shard_map(placed, model, REG, opts, mesh),
                             on_card)[1])
    out = dict(coords=(mesh.seq_index, mesh.lm_index), step_ms=times,
               step=tuple(x.cpu() for x in step),
               launches={name: counts[name] for name in
                         ("ba_evaluate", "ba_linearize_schur", "ba_solve_step")},
               all_launches={k: v for k, v in counts.items() if v}, solves={})

    for ledger, start in data["starts"].items():
        start = place_window(_to(start, device), mesh)
        dist.barrier(group=mesh.lm_group)
        kernels.reset_counts()
        log = []
        solved, energy, count = solve_loop_shard_map(start, model, opts, mesh, log=log)
        folded = marginalize_slot(solved, model, opts, mesh)
        if on_card:
            torch.cuda.synchronize()
        launched = {k: v for k, v in kernels.counts().items() if v}
        # one solve's host syncs that torch's sync debug mode sees, and its
        # all-reduces with the host's time inside them (gloo stages CUDA
        # tensors through the host: a call waits for the device work before it)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                _, collectives, collective_ms = _counted_all_reduces(
                    lambda: solve_loop_shard_map(start, model, opts, mesh))
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        if on_card:
            torch.cuda.synchronize()
        syncs = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]
        solve_ms, fold_ms = [], []
        for _ in range(3):
            dist.barrier(group=mesh.lm_group)
            again, ms = _synced(lambda: solve_loop_shard_map(start, model, opts, mesh), on_card)
            solve_ms.append(ms)
            dist.barrier(group=mesh.lm_group)
            fold_ms.append(_synced(lambda: marginalize_slot(again[0], model, opts, mesh),
                                   on_card)[1])
        # the fold alone: the single-process solve's outputs folded on the
        # two ranks
        fold_only = marginalize_slot(place_window(_to(data["solved"][ledger], device), mesh),
                                     model, opts, mesh)
        out["solves"][ledger] = dict(
            log=log, energy=energy.cpu(), count=count.cpu(), launches=launched,
            fold_only={f: getattr(fold_only, f).cpu() for f in ("h_marg", "b_marg")},
            host_syncs=syncs, collectives=collectives, collective_ms=collective_ms,
            solve_ms=solve_ms, fold_ms=fold_ms,
            solved={f: getattr(solved, f).cpu() for f in ("eps", "lm_idepth", "res_status",
                                                          "lm_outlier", "lm_valid")},
            folded={f: getattr(folded, f).cpu() for f in ("eps", "lm_idepth", "lm_valid",
                                                          "h_marg", "b_marg", "energy_marg",
                                                          "frame_valid")})

    # K11 on the two shards of one evaluation: the threshold and this rank's
    # statuses
    status = data["status"]
    lo = mesh.lm_index * placed.num_landmark_slots
    hi = lo + placed.num_landmark_slots
    shard = {k: v.to(device)[..., lo:hi].contiguous() for k, v in status["ev"].items()}
    ev = Evaluation(**{**dict.fromkeys(Evaluation._fields), **shard})
    ps = _point_status_gathered(place_window(_to(status["window"], device), mesh), ev,
                                status["mask"].to(device)[:, lo:hi].contiguous(), opts, mesh)
    out["status"] = {k: v.cpu() for k, v in ps._asdict().items()}
    return out


def _card_seq(rank, payload):
    import torch.distributed as dist

    from dsopp_tpu_torch import kernels
    from dsopp_tpu_torch.parallel.mesh import make_mesh
    from dsopp_tpu_torch.parallel.sharded import SeqRankTracker
    from dsopp_tpu_torch.testing import batched as tb
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES, standart_config
    from dsopp_tpu_torch.testing.profiling import profiled

    kernels.library()
    data = torch.load(payload, weights_only=False)
    batch, ticks, profiled_ticks = data["batch"], data["ticks"], data["profiled_ticks"]
    mesh = make_mesh(2, 1)
    seq = data["seq"]
    cfg = standart_config()
    t0 = time.perf_counter()
    tracker = SeqRankTracker(lambda b, dev: tb.offset_bootstrap(seq, cfg, b, device=dev),
                             batch, mesh)
    seq = dataclasses.replace(seq, images=seq.images.to(tracker.device))
    bootstrap_s = time.perf_counter() - t0
    local = list(tracker.sequences)

    def tick(j):
        fids = [b + INIT_FRAMES + j for b in local]
        tracker.tick(fids, [float(seq.timestamps[f]) for f in fids], seq.images[fids])

    torch.cuda.synchronize()
    kernels.reset_counts()
    dist.barrier()
    # wall-clock times (one host's clock, so the ranks' compare) of the timed
    # ticks' start and end
    start = time.time()
    for j in range(ticks - profiled_ticks):
        tick(j)
    tracker.pipe.drain()
    torch.cuda.synchronize()
    end = time.time()
    seconds = end - start
    counts = {k: v for k, v in kernels.counts().items() if v}
    with profiled([torch.profiler.ProfilerActivity.CPU,
                   torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for j in range(ticks - profiled_ticks, ticks):
            tick(j)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t1
    device_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    trajectories = tracker.finalize()
    timed = ticks - profiled_ticks
    return dict(sequences=local, trajectories=trajectories, seconds=seconds, start=start,
                end=end, bootstrap_s=bootstrap_s, fps=len(local) * timed / seconds,
                ms_per_tick=1e3 * seconds / timed, counts=counts,
                busy_share=(device_us / 1e6 / profiled_s) if device_us > 0 else None,
                profiled_ticks=profiled_ticks)


TASKS = {"meshes": _meshes, "skip": _skip, "card": _card, "card_seq": _card_seq}
