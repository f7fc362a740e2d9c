"""A gloo world of processes running the landmark-sharded BA step (the
CPU tests' 4-rank meshes and chip_smoke's two ranks on one card).

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``, each
joining a gloo group at ``tcp://localhost:<a free port>`` and running one
task of this module on the inputs in ``payload`` (a ``.npz`` of JAX window
fields, ``window_*`` / ``window1_*``, and the camera ``cam_*``; or a ``.pt``
of port tensors), then writing ``rank<r>.pt`` into ``out_dir``.  Tasks:

* ``meshes`` (CPU, world 4): the 2 × 2 mesh (two sequences over ``seq``,
  two landmark shards each) through ``sharded.batched_train_step``, and each
  of its rows stepping the first window through
  ``shard_map_ba.pba_iteration_shard_map``; the 1 × 4 mesh through both; and
  ``make_hybrid_mesh`` with two "nodes" of two ranks (``LOCAL_WORLD_SIZE`` =
  2) through ``batched_train_step``;
* ``card`` (one card, world 2): the 1 × 2 mesh on CUDA tensors, with each
  rank's K7, K8 and K9 launches and the step's time three times after it
  (from a barrier of the two ranks to the step's end on the card).
"""

from __future__ import annotations

import os
import socket
import time

import numpy as np
import torch

REG = 1e-5   # the JAX tests' regularizer


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(world: int, task: str, payload: str, out_dir: str, **options):
    """Run ``task`` on ``world`` gloo ranks (joined; raises if one fails)."""
    import torch.multiprocessing as mp

    port = free_port()
    mp.spawn(_worker, args=(world, port, task, payload, out_dir, options), nprocs=world,
             join=True)


def _worker(rank, world, port, task, payload, out_dir, options):
    from dsopp_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"tcp://localhost:{port}", world, rank, "gloo")
    try:
        out = TASKS[task](rank, payload, **options)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist
        dist.barrier()
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


def _meshes(rank, payload):
    from dsopp_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh
    from dsopp_tpu_torch.parallel.shard_map_ba import pba_iteration_shard_map, place_window
    from dsopp_tpu_torch.parallel.sharded import (batched_train_step, shard_windows,
                                                  stack_windows)
    from dsopp_tpu_torch.solvers.pba import PBAOptions

    data = np.load(payload)
    cam = camera_from_npz(data)
    windows = [window_from_npz(data, "window_"), window_from_npz(data, "window1_")]
    stacked = stack_windows(windows)
    opts = PBAOptions()
    out = {}
    mesh = make_mesh(2, 2)
    out["2x2"] = dict(coords=(mesh.seq_index, mesh.lm_index),
                      step=batched_train_step(shard_windows(stacked, mesh), cam, REG, opts,
                                              mesh))
    out["2x2 shard_map"] = dict(coords=(mesh.seq_index, mesh.lm_index),
                                step=pba_iteration_shard_map(place_window(windows[0], mesh),
                                                             cam, REG, opts, mesh))
    mesh = make_mesh(1, 4)
    out["1x4"] = dict(coords=(mesh.seq_index, mesh.lm_index),
                      step=pba_iteration_shard_map(place_window(windows[0], mesh), cam, REG,
                                                   opts, mesh))
    out["1x4 batched"] = dict(coords=(mesh.seq_index, mesh.lm_index),
                              step=batched_train_step(shard_windows(stacked, mesh), cam, REG,
                                                      opts, mesh))
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    mesh = make_hybrid_mesh()
    out["hybrid"] = dict(coords=(mesh.seq_index, mesh.lm_index), shape=mesh.shape,
                         step=batched_train_step(shard_windows(stacked, mesh), cam, REG,
                                                 opts, mesh))
    return out


def _card(rank, payload, device="cuda"):
    import torch.distributed as dist

    from dsopp_tpu_torch import kernels
    from dsopp_tpu_torch.parallel.mesh import make_mesh
    from dsopp_tpu_torch.parallel.shard_map_ba import pba_iteration_shard_map, place_window

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        kernels.library()
    data = torch.load(payload, weights_only=False)
    window = data["window"].__class__(**{k: (None if v is None else v.to(device))
                                          for k, v in vars(data["window"]).items()})
    mesh = make_mesh(1, 2)
    placed = place_window(window, mesh)
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_counts()
    step = pba_iteration_shard_map(placed, data["model"], REG, data["opts"], mesh)
    if on_card:
        torch.cuda.synchronize()
    counts = kernels.counts()
    # the step again, timed from both ranks' barrier to the end of its sums
    times = []
    for _ in range(3):
        dist.barrier(group=mesh.lm_group)
        t0 = time.perf_counter()
        pba_iteration_shard_map(placed, data["model"], REG, data["opts"], mesh)
        if on_card:
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return dict(coords=(mesh.seq_index, mesh.lm_index), step_ms=times,
                step=tuple(x.cpu() for x in step),
                launches={name: counts[name] for name in
                          ("ba_evaluate", "ba_linearize_schur", "ba_solve_step")},
                all_launches={k: v for k, v in counts.items() if v})


TASKS = {"meshes": _meshes, "card": _card}
