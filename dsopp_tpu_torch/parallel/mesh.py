"""The (seq, lm) mesh of ranks for distributed bundle adjustment
(counterpart of ``dsopp_tpu/parallel/mesh.py``).

Two scaling axes, as the JAX package's:

* ``seq`` — data parallelism over independent camera sequences (each
  sequence's window is independent: no traffic along this axis in a step);
* ``lm`` — model parallelism over landmark slots: each rank of an ``lm``
  group evaluates and linearizes its shard of the landmarks, and the group
  all-reduces the (K·8)² pose systems once an iteration
  (:mod:`dsopp_tpu_torch.parallel.shard_map_ba`).

PyTorch has no device mesh of its own here: a :class:`Mesh` is this rank's
coordinates in a ``num_seq × num_lm`` grid of the default process group's
ranks (rank r at ``(r // num_lm, r % num_lm)``) and its two process groups,
its ``lm`` group (its row) and its ``seq`` group (its column), made with
``dist.new_group`` on every rank in the same order.  Without an initialized
process group the mesh is one rank and its collectives are no-ops.

The backend is the caller's explicit choice (:func:`initialize_distributed`):
``nccl`` for ranks that each have their own card, ``gloo`` for the CPU and
for ranks that share one card (NCCL refuses two ranks on one device).  No
function here picks or switches it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from dsopp_tpu_torch import default_device

SEQ_AXIS = "seq"
LM_AXIS = "lm"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (seq, lm) grid and its groups."""

    num_seq: int
    num_lm: int
    seq_index: int          # this rank's row (None: a rank outside the grid)
    lm_index: int           # this rank's column
    lm_group: object        # the ranks of this rank's row (None: one process)
    seq_group: object       # the ranks of this rank's column

    @property
    def shape(self) -> dict:
        return {SEQ_AXIS: self.num_seq, LM_AXIS: self.num_lm}

    @property
    def axis_names(self) -> tuple:
        return (SEQ_AXIS, LM_AXIS)


def _world() -> tuple:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(num_seq: int = 1, num_lm: int = 0) -> Mesh:
    """A (seq, lm) grid of the default group's ranks.  ``num_lm`` = 0: all the
    ranks left, ``world // num_seq``.  Every rank must call it, with the same
    arguments: it makes every row's and every column's group in one order."""
    rank, world = _world()
    if num_lm == 0:
        num_lm = world // num_seq
    if num_seq < 1 or num_lm < 1 or num_seq * num_lm > world:
        raise ValueError(f"a {num_seq} x {num_lm} mesh needs as many ranks; the world has {world}")
    inside = rank < num_seq * num_lm
    seq_index, lm_index = (rank // num_lm, rank % num_lm) if inside else (None, None)
    if world == 1:
        return Mesh(num_seq, num_lm, seq_index, lm_index, None, None)
    lm_group = seq_group = None
    for s in range(num_seq):
        group = dist.new_group([s * num_lm + m for m in range(num_lm)])
        if seq_index == s:
            lm_group = group
    for m in range(num_lm):
        group = dist.new_group([s * num_lm + m for s in range(num_seq)])
        if lm_index == m:
            seq_group = group
    return Mesh(num_seq, num_lm, seq_index, lm_index, lm_group, seq_group)


def initialize_distributed(coordinator: str = None, num_processes: int = None,
                           process_id: int = None, backend: str = None,
                           timeout: float = None):
    """Join the default process group: ``coordinator`` its address
    (``tcp://host:port``), ``num_processes`` the world size, ``process_id``
    this rank, ``backend`` "nccl" or "gloo" (the caller's choice, required
    with a world of more than one), ``timeout`` the seconds a collective
    waits for the other ranks before it raises (``None``: torch's default,
    30 minutes).  A no-op when the group is already initialized, or for a
    single process without a coordinator."""
    if dist.is_initialized():
        return
    if coordinator is None and (num_processes or 1) == 1:
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend: 'nccl' or 'gloo', not {backend!r}")
    extra = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=coordinator, world_size=num_processes,
                            rank=process_id, **extra)


def rank_device(device=None) -> torch.device:
    """The device this rank runs on: ``device`` where given; else, under
    nccl, the card ``LOCAL_RANK`` names (made the current one), and
    otherwise the card of :func:`dsopp_tpu_torch.default_device` (the one
    card the ranks of a gloo world share)."""
    if device is not None:
        return torch.device(device)
    if dist.is_initialized() and dist.get_backend() == "nccl":
        index = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(index)
        return torch.device("cuda", index)
    return default_device(None)


def make_hybrid_mesh(num_seq: int = 0, num_lm: int = 0) -> Mesh:
    """A (seq, lm) mesh whose ``lm`` rows lie inside one node (the ranks of a
    node being consecutive, ``LOCAL_WORLD_SIZE`` of them, as ``torchrun``
    numbers them): the per-iteration all-reduce stays on the node's links,
    and ``seq`` (no traffic in a step) spans the nodes.  ``num_lm`` = 0: a
    node's ranks; ``num_seq`` = 0: the rest.  One process: :func:`make_mesh`."""
    _, world = _world()
    if world == 1:
        return make_mesh(max(num_seq, 1), num_lm)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if num_lm == 0:
        num_lm = local
    if num_seq == 0:
        num_seq = world // num_lm
    if local % num_lm:
        raise ValueError(f"an lm row of {num_lm} ranks does not fit a node of {local}")
    return make_mesh(num_seq, num_lm)
