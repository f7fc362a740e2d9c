"""Port parity: the row gather of the Pallas design probe
(``scripts/gather_probe_pallas.py``) in plain PyTorch against the probe's own
reference, ``jnp.take(table, idx, axis=0)``, equal to the bit in f32 and in
bf16 on the first indices of the probe's draw.  The probe's inputs are made
again from its seed here: importing the script would set its compilation
cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.testing import gather_probe as gp

M_SMALL = 4096


def _probe_reference_inputs():
    """The probe's main(): table, its bf16 copy and the indices, in JAX."""
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.standard_normal((gp.HW, gp.ROWW)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, gp.HW - gp.W - 2, gp.M), jnp.int32)
    return table, table.astype(jnp.bfloat16), idx


@pytest.fixture(scope="module")
def inputs():
    return _probe_reference_inputs(), gp.probe_inputs("cpu", M_SMALL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_row_gather_matches_the_probe(inputs, dtype):
    (table_j, table_bf_j, idx_j), (table_t, table_bf_t, idx_t) = inputs
    tab_j, tab_t = (table_j, table_t) if dtype == "f32" else (table_bf_j, table_bf_t)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j[:M_SMALL]))
    ref = np.asarray(jnp.take(tab_j, idx_j[:M_SMALL], axis=0).astype(jnp.float32))
    out = gp.row_gather(tab_t, idx_t)
    assert out.dtype == tab_t.dtype and tuple(out.shape) == (M_SMALL, gp.ROWW)
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_row_gather_kernel_refuses_cpu_tensors(inputs):
    _, (table_t, _, idx_t) = inputs
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        gp.row_gather_cuda(table_t, idx_t)
    assert kernels.counts() == before
    # the probe's bound: the indices and each distinct row read once, the
    # output written once; a row named twice is read once
    distinct = np.unique(idx_t.numpy()).size
    assert distinct < M_SMALL
    assert gp.bound_ms(table_t, idx_t) == pytest.approx(
        1e3 * (4 * M_SMALL + distinct * 48 + M_SMALL * 48) / 3.35e12)
    assert gp.bound_ms(table_t, torch.zeros_like(idx_t)) == pytest.approx(
        1e3 * (4 * M_SMALL + 48 + M_SMALL * 48) / 3.35e12)
