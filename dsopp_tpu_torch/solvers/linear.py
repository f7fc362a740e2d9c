"""Dense normal-equation helpers (counterpart of
``dsopp_tpu/solvers/linear.py``).  Solves never check for singularity on
the host (``solve_ex``), so a CUDA caller does not synchronise; a
non-finite step is masked by the callers, as in the reference."""

from __future__ import annotations

import torch


def solve(h, b):
    """Batched LU solve of h x = b (b [..., n]) → x [..., n]."""
    return torch.linalg.solve_ex(h, b[..., None])[0][..., 0]


def pinv_hermitian(a):
    """Pseudo-inverse with the reference's cutoff (10·n·eps relative)."""
    rtol = 10.0 * a.shape[-1] * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rtol, hermitian=True)
