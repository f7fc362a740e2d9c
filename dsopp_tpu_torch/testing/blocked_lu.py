"""A plain PyTorch mirror of the factorization order of kernel K9
(``csrc/ba_solve.cu``), for tests only: no path of the port calls it.

K9 solves the damped pose system of one LM step by LU with partial pivoting
in float64.  Its first version went column by column (:func:`unblocked_solve`);
the kernel now factors in panels of ``PANEL`` columns, one frame's block
(:func:`blocked_solve`):

1. the panel is factored (on the card by warps 0..7, a thread per row): for
   each of its columns the first largest
   pivot below the diagonal, the swap of the panel's part of the two rows,
   the multipliers stored in place of the column, and the rank-1 update of
   the panel's remaining columns;
2. the panel's swaps go to the columns right of it (the right-hand side
   is the last column), then the panel's rows there are solved against its
   unit lower triangle (U12);
3. the trailing rows take A22 -= L21 U12, one panel column after the other.

The back substitution goes block by block from the bottom: the 8x8
diagonal solve, then the rows above take the block's 8 columns, the last
column first.

Every entry takes its updates in the order the column-by-column version
gives them, each as ``a - (l * u)`` with two roundings (the kernels build
with ``--fmad=false``), so both versions pick the same pivots and return the
same bits; :func:`blocked_solve` here and K9 on the card compute the same
arithmetic on the same float64 system.  The mirrors work on dense float64
tensors with vectorised rows and columns: no ``matmul``, whose summation
order is the library's.
"""

from __future__ import annotations

import torch

PANEL = 8  # columns per panel: one frame slot's block (pba.BLOCK)


def _pivot(column: torch.Tensor, start: int) -> int:
    """First row of the largest |entry| of ``column`` (a NaN is never
    chosen; an all-NaN column keeps its diagonal), offset by ``start``."""
    mag = torch.where(torch.isnan(column), torch.full_like(column, -1.0), column.abs())
    return start + int(torch.argmax(mag))


def _swap_rows(a: torch.Tensor, r0: int, r1: int, cols: slice):
    if r0 != r1:
        a[[r0, r1], cols] = a[[r1, r0], cols]


def unblocked_solve(h: torch.Tensor, b: torch.Tensor):
    """x with h x = b, column by column → (x, pivot rows)."""
    kb = h.shape[0]
    a = torch.cat([h, b[:, None]], dim=1).clone()
    pivots = []
    for col in range(kb):
        piv = _pivot(a[col:, col], col)
        pivots.append(piv)
        _swap_rows(a, col, piv, slice(col, kb + 1))
        f = a[col + 1:, col] / a[col, col]
        a[col + 1:, col + 1:] -= f[:, None] * a[col, col + 1:][None, :]
    for col in range(kb - 1, -1, -1):
        a[col, kb] = a[col, kb] / a[col, col]
        a[:col, kb] -= a[:col, col] * a[col, kb]
    return a[:, kb].clone(), pivots


def factor_panel(a: torch.Tensor, j0: int, j1: int) -> list:
    """Step 1 on rows j0.. of columns j0..j1-1 of ``a`` (in place) → the
    panel's pivot rows."""
    pivots = []
    for col in range(j0, j1):
        piv = _pivot(a[col:, col], col)
        pivots.append(piv)
        _swap_rows(a, col, piv, slice(j0, j1))
        f = a[col + 1:, col] / a[col, col]
        a[col + 1:, col] = f
        a[col + 1:, col + 1:j1] -= f[:, None] * a[col, col + 1:j1][None, :]
    return pivots


def blocked_solve(h: torch.Tensor, b: torch.Tensor):
    """x with h x = b in K9's panel order → (x, pivot rows); the size is a
    multiple of ``PANEL``, as K9's 8k is."""
    kb = h.shape[0]
    a = torch.cat([h, b[:, None]], dim=1).clone()
    pivots = []
    for j0 in range(0, kb, PANEL):
        j1 = j0 + PANEL
        panel_pivots = factor_panel(a, j0, j1)
        pivots += panel_pivots
        for col, piv in zip(range(j0, j1), panel_pivots):
            _swap_rows(a, col, piv, slice(j1, kb + 1))
        for row in range(j0 + 1, j1):
            for q in range(j0, row):
                a[row, j1:] -= a[row, q] * a[q, j1:]
        for q in range(j0, j1):
            a[j1:, j1:] -= a[j1:, q:q + 1] * a[q:q + 1, j1:]
    for j0 in range(kb - PANEL, -1, -PANEL):
        j1 = j0 + PANEL
        for col in range(j1 - 1, j0 - 1, -1):
            a[col, kb] = a[col, kb] / a[col, col]
            a[j0:col, kb] -= a[j0:col, col] * a[col, kb]
        for col in range(j1 - 1, j0 - 1, -1):
            a[:j0, kb] -= a[:j0, col] * a[col, kb]
    return a[:, kb].clone(), pivots
