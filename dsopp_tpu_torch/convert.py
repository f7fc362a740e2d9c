"""Build the port's state objects from the JAX package's, given as numpy.

Every function takes plain numpy arrays (or dicts of them keyed by the JAX
field names), so the port never imports jax: a caller flattens the JAX
pytrees to numpy first.  Float arrays take the requested ``dtype``, bool
arrays stay bool, integer arrays become int32.

``window`` applies the four layout rules between the two packages:

* ``patch`` / ``patch_map`` (the TPU's per-pixel patch-table bank and its
  slot indirection) are dropped — the port samples maps directly;
* a window of C > 1 embedder channels carries them only in that bank: slot
  j's channels are lane ``PATCH_LO·10 + PATCH_LO`` = 44 (the pixel itself)
  of the rows ``patch_map[j]·C·H·W + c·H·W + p`` (the bank is
  slot-indirect), and the port's ``channel_maps[j]`` is their
  ``build_pixel_map``; at C = 1 the port has no channel bank but ``maps``;
* ``maps`` needs no un-permuting: the JAX marginalizer permutes the map
  bank physically (``_permute_window``), only the patch bank is indirect;
* the float64 ledger is the sum of the double-float pairs
  (``h_marg + h_marg_lo``, ``b_marg + b_marg_lo``,
  ``energy_marg + energy_marg_lo``).

``fej_cache`` and ``evaluation`` keep the channel axis, [K, K, N, C, P].
``window`` also takes the windows the JAX package builds outside a tracker
(``__graft_entry__._tiny_problem``'s, the parallel tests'), and
``stacked_device_tracker_state`` a JAX state stacked over B sequences
(``dsopp_tpu/tracker/batched_loop.py::stack_states``).
"""

from __future__ import annotations

import numpy as np
import torch

from dsopp_tpu_torch.core.camera import Pinhole
from dsopp_tpu_torch.core.interpolate import PATCH_LO, PATCH_WIN, build_pixel_map
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.solvers.pba import (LEDGER_DTYPE, Evaluation, FEJCache, LinearSystem,
                                         PointStatus, Window)
from dsopp_tpu_torch.solvers.pose_alignment import LevelPoints
from dsopp_tpu_torch.tracker.depth_estimation import ImmaturePoints
from dsopp_tpu_torch.tracker.device_loop import DeviceTrackerState


def tensor(x, dtype=torch.float64, device=None):
    a = np.array(x)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int32), device=device)
    return torch.tensor(a.astype(np.float64), dtype=dtype, device=device)


def se3(q, t, dtype=torch.float64, device=None) -> SE3:
    return SE3(tensor(q, dtype, device), tensor(t, dtype, device))


def pinhole(fx, fy, cx, cy, image_size) -> Pinhole:
    w, h = np.asarray(image_size, np.float64).reshape(-1)[:2]
    return Pinhole(float(fx), float(fy), float(cx), float(cy), float(w), float(h))


def camera_model(model_type: str, image_size, intrinsics):
    """The port's camera model from the JAX package's ``CameraCalibration``
    fields (numpy)."""
    from dsopp_tpu_torch.sensors.calibration import CameraCalibration

    size = tuple(float(v) for v in np.asarray(image_size, np.float64).reshape(-1)[:2])
    return CameraCalibration(model_type, size, np.asarray(intrinsics, np.float64)).camera_model()


def camera_mask(mask, device=None):
    """A CameraMask given as a numpy [H, W] array (true = valid) → bool tensor
    on ``device`` (the device of the state it is used with)."""
    return torch.as_tensor(np.asarray(mask, dtype=np.bool_), device=device)


def level_points(uv, idepth, intensity, valid, dtype=torch.float64, device=None) -> LevelPoints:
    return LevelPoints(*(tensor(x, dtype, device) for x in (uv, idepth, intensity, valid)))


def immature_points(fields: dict, dtype=torch.float64, device=None) -> ImmaturePoints:
    return ImmaturePoints(**{k: tensor(fields[k], dtype, device)
                             for k in ImmaturePoints._fields})


def embedded_channels(patch, patch_map, height: int, width: int) -> np.ndarray:
    """A JAX window's patch bank [K, C·H·W, 128] and ``patch_map`` [K] → each
    frame slot's [C, H, W] channels (the centre lane of each pixel's row)."""
    patch = np.asarray(patch)
    k = patch.shape[0]
    c = patch.shape[1] // (height * width)
    centre = PATCH_LO * PATCH_WIN + PATCH_LO
    bank = patch[np.asarray(patch_map).astype(np.int64), :, centre]      # [K, C·H·W]
    return bank.reshape(k, c, height, width)


def window(fields: dict, dtype=torch.float64, device=None) -> Window:
    """JAX ``Window`` fields → port ``Window`` (see the module rules)."""
    out = {}
    h, w = np.asarray(fields["maps"]).shape[-2:]
    for name in Window.__dataclass_fields__:
        if name == "channel_maps":
            chans = embedded_channels(fields["patch"], fields["patch_map"], h, w)
            out[name] = (None if chans.shape[1] == 1 else
                         torch.stack([build_pixel_map(tensor(x, dtype, device)) for x in chans]))
        elif name in ("h_marg", "b_marg", "energy_marg"):
            ledger = (np.asarray(fields[name], np.float64)
                      + np.asarray(fields[name + "_lo"], np.float64))
            out[name] = torch.as_tensor(ledger, dtype=LEDGER_DTYPE, device=device)
        else:
            out[name] = tensor(fields[name], dtype, device)
    return Window(**out)


def fej_cache(fields: dict, dtype=torch.float64, device=None) -> FEJCache:
    """JAX ``FEJCache`` fields → port ``FEJCache``."""
    return FEJCache(**{k: tensor(fields[k], dtype, device) for k in FEJCache._fields})


def evaluation(fields: dict, dtype=torch.float64, device=None) -> Evaluation:
    """JAX ``Evaluation`` fields → port ``Evaluation``."""
    return Evaluation(**{k: tensor(fields[k], dtype, device) for k in Evaluation._fields})


def linear_system(fields: dict, dtype=torch.float64, device=None) -> LinearSystem:
    """JAX ``LinearSystem`` fields → port ``LinearSystem``."""
    return LinearSystem(**{k: tensor(fields[k], dtype, device)
                           for k in LinearSystem._fields})


def solve_step(step, dtype=torch.float64, device=None):
    """JAX ``_solve_step`` result (eps', idepth', |pose step|², |idepth
    step|²) → the port's 4-tuple."""
    return tuple(tensor(x, dtype, device) for x in step)


def point_status(status, dtype=torch.float64, device=None) -> PointStatus:
    """JAX ``_point_status_kernel`` result (status, baseline, inliers,
    outlier, opt_count) → port ``PointStatus``; the JAX package does not
    return its threshold, so ``threshold`` is NaN."""
    new_status, baseline, inliers, outlier, opt_count = (tensor(x, dtype, device)
                                                         for x in status)
    return PointStatus(new_status, baseline, inliers, outlier, opt_count,
                       torch.full((), float("nan"), dtype=dtype, device=device))


def device_tracker_state(fields: dict, dtype=torch.float64, device=None) -> DeviceTrackerState:
    """JAX ``DeviceTrackerState`` → port state.  ``fields``: the state's
    fields with ``window`` a dict (as :func:`window`), ``immature`` a dict,
    ``level_points`` a list of 4-tuples, ``flow_points`` a 4-tuple and the
    depth maps lists of arrays."""
    kw = dict(dtype=dtype, device=device)
    return DeviceTrackerState(
        window=window(fields["window"], **kw),
        immature=immature_points(fields["immature"], **kw),
        depth_idepth=tuple(tensor(x, **kw) for x in fields["depth_idepth"]),
        depth_weight=tuple(tensor(x, **kw) for x in fields["depth_weight"]),
        level_points=tuple(level_points(*p, **kw) for p in fields["level_points"]),
        flow_points=level_points(*fields["flow_points"], **kw),
        **{k: tensor(fields[k], **kw) for k in (
            "last_q", "last_t", "prev_q", "prev_t", "last_affine", "rmse_last0",
            "kf_rmse", "min_distance")})


def _sequence_fields(fields, b: int):
    """Sequence ``b``'s slice of stacked state fields (dicts, lists, tuples of
    arrays)."""
    if isinstance(fields, dict):
        return {k: _sequence_fields(v, b) for k, v in fields.items()}
    if isinstance(fields, (list, tuple)):
        return type(fields)(_sequence_fields(v, b) for v in fields)
    return np.asarray(fields)[b]


def stacked_device_tracker_state(fields: dict, dtype=torch.float64,
                                 device=None) -> DeviceTrackerState:
    """A JAX ``DeviceTrackerState`` stacked over B sequences (its fields as
    :func:`device_tracker_state` takes them, each with a leading [B] axis) →
    the port's stacked state (``tracker/batched_loop.py::stack_states``)."""
    from dsopp_tpu_torch.tracker.batched_loop import stack_states

    batch = np.asarray(fields["last_q"]).shape[0]
    return stack_states([device_tracker_state(_sequence_fields(fields, b), dtype, device)
                         for b in range(batch)])
