"""Dense normal-equation helpers (counterpart of
``dsopp_tpu/solvers/linear.py``).  Solves never check for singularity on
the host (``solve_ex``), so a CUDA caller does not synchronise; a
non-finite step is masked by the callers, as in the reference."""

from __future__ import annotations

import torch


def solve(h, b):
    """Batched LU solve of h x = b (b [..., n]) → x [..., n]."""
    return torch.linalg.solve_ex(h, b[..., None])[0][..., 0]


def pinv_rtol(n: int, dtype=torch.float64) -> float:
    """The reference's relative cutoff of an n×n pseudo-inverse, 10·n·eps
    (``jnp.linalg.pinv``'s default): an eigenvalue with |λ| ≤ rtol·max|λ| is
    dropped, the others are inverted with their sign."""
    return 10.0 * n * torch.finfo(dtype).eps


def pinv_hermitian(a):
    """Pseudo-inverse of a Hermitian matrix with the reference's cutoff.

    The plain version, through ``eigh``, which synchronises a CUDA tensor
    with the host; the card's marginalization computes the same cutoff in
    kernel K15 (``csrc/marg_fold.cu``)."""
    return torch.linalg.pinv(a, rtol=pinv_rtol(a.shape[-1], a.dtype), hermitian=True)
