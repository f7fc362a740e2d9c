"""The DSO 8-point residual pattern (counterpart of
``dsopp_tpu/core/pattern.py``), offsets in (x, y) order."""

import functools

import torch

PATTERN_SIZE = 8
PATTERN_CENTER = 4  # index of the (0, 0) offset

_OFFSETS = (
    (0, 2),
    (-1, 1),
    (1, 1),
    (-2, 0),
    (0, 0),
    (2, 0),
    (-1, -1),
    (0, -2),
)


@functools.lru_cache(maxsize=None)
def pattern_offsets(dtype=torch.float32, device=None):
    """[P, 2] pattern offsets in (x, y) pixel units (one constant tensor per
    dtype and device: building it from the host list on every call would
    copy host → device, and such a copy waits for the device)."""
    return torch.tensor(_OFFSETS, dtype=dtype, device=device)


def shift_pattern(uv):
    """Center the pattern at points ``uv`` [..., 2] → [..., P, 2]."""
    return uv[..., None, :] + pattern_offsets(uv.dtype, uv.device)
