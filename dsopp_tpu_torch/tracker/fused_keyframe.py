"""Keyframe push (counterpart of
``dsopp_tpu/tracker/fused_keyframe.py::fused_keyframe_push`` up to its
solve): push the frame, build its immature bank from fresh candidates and
activate (:func:`fused_keyframe_front`).  ``embed``: the keyframe's [C, H, W]
frame-embedder channels for a window of C > 1 channels, whose map (kernel
K1) goes into the window's channel bank.  The windowed LM solve that the
JAX function ends with runs in ``device_loop.keyframe_solver_sequences``,
once for every sequence that keyframes (one for the solo tracker)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsopp_tpu_torch.core.interpolate import sample
from dsopp_tpu_torch.core.pattern import shift_pattern
from dsopp_tpu_torch.features.extractor import select_candidates
from dsopp_tpu_torch.features.pyramid import build_channel_map
from dsopp_tpu_torch.solvers.pba import Window, push_frame_slot, put_slot, slot_mask
from dsopp_tpu_torch.tracker.activation import (_activation_kernel, _activation_scatter,
                                                _refine_idepth_kernel)
from dsopp_tpu_torch.tracker.depth_estimation import ImmaturePoints, make_immature_points


class KeyframeFront(NamedTuple):
    """The keyframe push before the solve."""
    window: Window              # the frame pushed, its points activated
    immature: ImmaturePoints
    slot: torch.Tensor          # [1] long: the pushed frame's slot
    n_active: torch.Tensor
    n_activated: torch.Tensor


def immature_bank(pixel_map0, num_points: int, mask=None) -> ImmaturePoints:
    """A fresh [N] immature bank from the candidates of a level-0 map."""
    cands = select_candidates(pixel_map0, num_points, mask=mask)
    patches, _ = sample(pixel_map0, shift_pattern(cands.uv))
    grads, _ = sample(pixel_map0, cands.uv)
    bank = make_immature_points(cands.uv, patches[..., 0], grads[..., 1:])
    return bank._replace(valid=bank.valid & cands.valid)


def set_bank(immature: ImmaturePoints, slot, bank: ImmaturePoints) -> ImmaturePoints:
    """The banks with ``bank`` at frame slot ``slot`` (an int or a device
    tensor of one element)."""
    at = slot_mask(immature.valid.shape[0], slot, immature.valid.device)
    return ImmaturePoints(*(put_slot(x, at, v) for x, v in zip(immature, bank)))


def fused_keyframe_front(window: Window, model, immature: ImmaturePoints, pixel_map0, pose_q,
                         pose_t, affine, frame_id: int, min_distance, refine: bool,
                         huber_sigma: float, immature_per_frame: int, exposure, mask=None,
                         embed=None) -> KeyframeFront:
    """The push, the frame's immature bank (K12), the activation (K13) and,
    with ``refine``, the refinement and pairing (K14)."""
    channels = 1 if embed is None else embed.shape[0]
    if channels != window.num_channels:
        raise ValueError(f"embedder produced {channels} channels for a "
                         f"{window.num_channels}-channel window")
    channel_map = None if embed is None else build_channel_map(embed)
    # the first free slot stays on the device: nothing here reads it on the host
    slot = window.frame_valid.sum().view(1)
    window = push_frame_slot(window, slot, pose_q, pose_t, affine, exposure, False,
                             frame_id, pixel_map0, channel_map)
    immature = set_bank(immature, slot, immature_bank(pixel_map0, immature_per_frame, mask))

    activate, delete, n_active = _activation_kernel(window, model, immature, min_distance)
    idepth = selected = None
    if refine:
        # the pairing applies the refinement's outcome (keep → activate, the
        # refined idepth into the bounds, refined but not kept → deleted)
        idepth, activate, selected = _refine_idepth_kernel(window, model, immature,
                                                           activate, huber_sigma)
    window, immature, n_activated = _activation_scatter(window, immature, activate, delete,
                                                        idepth, selected)
    return KeyframeFront(window, immature, slot, n_active, n_activated)
