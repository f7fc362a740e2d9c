"""Keyframe push (counterpart of
``dsopp_tpu/tracker/fused_keyframe.py::fused_keyframe_push`` up to its
solve, under ``jax.vmap`` as ``dsopp_tpu/tracker/batched_loop.py`` runs it):
push the frame, build its immature bank from fresh candidates and activate,
for the S sequences of a stacked state that keyframe on a tick, in one call
(:func:`keyframe_front_sequences`; the solo tracker's is S = 1 on a stack of
one).  ``embed``: the keyframes' [S, C, H, W] frame-embedder channels for a
window of C > 1 channels, whose maps (kernel K1, one launch) go into the
window's channel bank.  The windowed LM solve that the JAX function ends with
runs in ``device_loop.keyframe_solver_sequences``, once for the same S
sequences."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsopp_tpu_torch.core.interpolate import sample_stack
from dsopp_tpu_torch.core.pattern import shift_pattern
from dsopp_tpu_torch.features.extractor import select_candidates_sequences
from dsopp_tpu_torch.features.pyramid import build_channel_map
from dsopp_tpu_torch.solvers.pba import (Window, _device_sequences, into_sequences,
                                         push_frame_sequences, sequence_list, slot_rows,
                                         slot_view, stack_size, with_sequences)
from dsopp_tpu_torch.tracker.activation import (activation_scatter_sequences,
                                                activation_sequences, refine_idepth_sequences)
from dsopp_tpu_torch.tracker.depth_estimation import ImmaturePoints, make_immature_points


class KeyframeFront(NamedTuple):
    """The keyframe push before the solve, of S sequences of a stack."""
    window: Window              # the stack, the S frames pushed, their points activated
    immature: ImmaturePoints    # the stacked banks
    slot: torch.Tensor          # [S] long: each pushed frame's slot
    n_active: torch.Tensor      # [S]
    n_activated: torch.Tensor   # [S]


def immature_bank_sequences(maps, seqs, num_points: int, mask=None) -> ImmaturePoints:
    """Fresh [S, N] immature banks from the candidates (K12, one call) of the
    sequences ``seqs`` (a host list; None: all) of a stack of level-0 maps
    [B, 3, H, W], each sampled from its own map (read through the list)."""
    seqs = sequence_list(seqs, maps.shape[0])
    cands = select_candidates_sequences(maps, seqs, num_points, mask=mask)
    rows = (None if seqs == tuple(range(maps.shape[0]))
            else _device_sequences(seqs, maps.device, torch.int64))
    patches, _ = sample_stack(maps, rows, shift_pattern(cands.uv))
    grads, _ = sample_stack(maps, rows, cands.uv)
    bank = make_immature_points(cands.uv, patches[..., 0], grads[..., 1:])
    return bank._replace(valid=bank.valid & cands.valid)


def immature_bank(pixel_map0, num_points: int, mask=None) -> ImmaturePoints:
    """A fresh [N] immature bank from the candidates of a level-0 map:
    :func:`immature_bank_sequences` of a stack of one."""
    return ImmaturePoints(*(x[0] for x in immature_bank_sequences(pixel_map0[None], (0,),
                                                                  num_points, mask)))


def set_bank_sequences(immature: ImmaturePoints, seqs: tuple, slots,
                       bank: ImmaturePoints) -> ImmaturePoints:
    """The stacked banks [B, K, N] with ``bank`` [S, N] at the slot ``slots[z]``
    ([S] long, on the device) of each sequence ``seqs[z]`` (a checked host
    list): where ``seqs`` is every sequence in order, new tensors (nothing
    written); else written in place, one ``index_copy_`` a field."""
    batch, k = immature.valid.shape[:2]
    if tuple(seqs) == tuple(range(batch)):
        at = torch.arange(k, device=slots.device) == slots.view(-1, 1)              # [B, K]
        return ImmaturePoints(*(
            torch.where(at.reshape(at.shape + (1,) * (x.dim() - 2)), v.unsqueeze(1), x)
            for x, v in zip(immature, bank)))
    rows = slot_rows(seqs, slots.view(-1, 1), k)
    for x, v in zip(immature, bank):
        slot_view(x).index_copy_(0, rows, v)
    return immature


def set_bank(immature: ImmaturePoints, slot, bank: ImmaturePoints) -> ImmaturePoints:
    """The banks with ``bank`` at frame slot ``slot`` (an int or a device
    tensor of one element): :func:`set_bank_sequences` on a stack of one →
    new tensors."""
    dev = immature.valid.device
    slots = (slot.reshape(1) if isinstance(slot, torch.Tensor)
             else torch.full((1,), int(slot), dtype=torch.int64, device=dev))
    out = set_bank_sequences(ImmaturePoints(*(x[None] for x in immature)), (0,), slots,
                             ImmaturePoints(*(x[None] for x in bank)))
    return ImmaturePoints(*(x[0] for x in out))


def keyframe_front_sequences(windows: Window, model, immature: ImmaturePoints, maps0, seqs,
                             pose_q, pose_t, affine, frame_ids, min_distance, exposure,
                             refine: bool, huber_sigma: float, immature_per_frame: int,
                             mask=None, embed=None) -> KeyframeFront:
    """The push, the frames' immature banks (K12), the activation (K13) and,
    with ``refine``, the refinement and pairing (K14) of the sequences
    ``seqs`` (a host list; None: all) of a stacked window and its stacked
    banks, once for all S, each kernel one launch.  ``maps0``: the tick's
    level-0 maps [B, 3, H, W], read at each sequence; ``pose_q`` [S, 4],
    ``pose_t`` [S, 3], ``affine`` [S, 2], ``exposure`` [S] and ``frame_ids`` (S
    host ints): the keyframes'; ``min_distance`` [B]: the controllers'
    states; ``mask``: the batch's one [H, W] candidate mask or None;
    ``embed``: the keyframes' [S, C, H, W] embedder channels or None (C = 1).
    Where ``seqs`` is every sequence of the stack in order, new tensors
    (nothing of the inputs written); else the S sequences' rows are written
    in place (the push and the bank at each sequence's slot, the pairing's
    outputs one ``index_copy_`` a field).  Nothing is read on the host."""
    batch = stack_size(windows)
    seqs = sequence_list(seqs, batch)
    channels = 1 if embed is None else embed.shape[1]
    window_channels = windows.channel_bank.shape[-3] // 3
    if channels != window_channels:
        raise ValueError(f"embedder produced {channels} channels for a "
                         f"{window_channels}-channel window")
    channel_maps = None if embed is None else build_channel_map(embed)
    dev = windows.frame_valid.device
    whole = seqs == tuple(range(batch))
    valid = (windows.frame_valid if whole else
             windows.frame_valid.index_select(0, _device_sequences(seqs, dev, torch.int64)))
    # each keyframe's first free slot stays on the device: nothing here reads it
    slots = valid.sum(-1)
    windows = push_frame_sequences(windows, seqs, slots, pose_q, pose_t, affine, exposure,
                                   False, frame_ids, maps0, channel_maps)
    immature = set_bank_sequences(
        immature, seqs, slots, immature_bank_sequences(maps0, seqs, immature_per_frame, mask))

    activate, delete, n_active = activation_sequences(windows, model, immature, min_distance,
                                                      seqs)
    idepth = selected = None
    if refine:
        # the pairing applies the refinement's outcome (keep → activate, the
        # refined idepth into the bounds, refined but not kept → deleted)
        idepth, activate, selected = refine_idepth_sequences(windows, model, immature, activate,
                                                             huber_sigma, seqs)
    part, bank, n_activated = activation_scatter_sequences(windows, immature, activate, delete,
                                                           idepth, selected, seqs)
    windows = with_sequences(windows, seqs, part)
    immature = immature._replace(**{name: into_sequences(getattr(immature, name), seqs, value)
                                    for name, value in bank.items()})
    return KeyframeFront(windows, immature, slots, n_active, n_activated)
