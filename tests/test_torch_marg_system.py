"""The ledger fold's entry from the marginalization pass's system (what
kernel K15 takes on the card: K8's ``h_pose``, ``b_pose``, ``h_schur``,
``b_schur`` and K7's energy, the priors and the subtractions formed in the
kernel), in plain PyTorch on the CPU (f64), ~20 s on one worker (most of it
rendering the frames and JAX's first compiles):

* ``_marginalize_system_plain`` on the marginalization pass of every
  flagging case of ``tests/test_torch_marginalization.py`` (no frame, one
  free frame, two frames, the fixed frame, a frame with no live landmark),
  at 10 slots, equal to the bit to ``_marg_system_kernel`` +
  ``_marginalize_plain`` (the chain the kernel's entry replaced), and
  within ``LEDGER_RTOL`` of their largest entry to JAX's
  ``_marginalize_device``;
* ``_marginalize_device`` on a CPU window runs that entry: its ledger equal
  to the bit to the chain's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.solvers import pba as jpba
from dsopp_tpu_torch.solvers import pba as tpba

from tests._torch_port import assert_equal
from tests.test_torch_marginalization import (CASES, _assert_ledger, _cam, _case,  # noqa: F401
                                              filled_window, seq)

SLOTS = 10


@pytest.fixture(scope="module")
def filled(seq):
    """``tests/test_torch_marginalization.py``'s filled window at 10 slots."""
    return filled_window(seq, SLOTS)


def _equal(got, want, label):
    for name, a, b in zip(("H", "b", "E"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{label} {name} differs"


@pytest.mark.parametrize("name", list(CASES))
def test_system_entry_is_the_chain(seq, filled, name):
    wj, wt, perm = _case(filled, name)
    opts, cam = tpba.PBAOptions(), _cam(seq)
    perm_t = torch.as_tensor(perm, dtype=torch.int64)
    sys_m, e_land = tpba._marg_pass(wt, cam, opts)
    got = tpba._marginalize_system_plain(wt, sys_m.h_pose, sys_m.b_pose, sys_m.h_schur,
                                         sys_m.b_schur, e_land, perm_t, opts)
    h_pts, b_pts, e_chain = tpba._marg_system_kernel(wt, cam, opts)
    _equal(got, tpba._marginalize_plain(wt, h_pts, b_pts, e_chain, perm_t, opts), name)

    out_j = jpba._marginalize_device(wj, seq.camera, jnp.asarray(perm), jpba.PBAOptions(),
                                     True, True)
    want = [np.asarray(out_j.h_marg) + np.asarray(out_j.h_marg_lo),
            np.asarray(out_j.b_marg) + np.asarray(out_j.b_marg_lo),
            np.asarray(out_j.energy_marg) + np.asarray(out_j.energy_marg_lo)]
    _assert_ledger(got, want, name)

    win = tpba._marginalize_device(wt, cam, perm_t, opts)
    _equal((win.h_marg, win.b_marg, win.energy_marg), got, f"{name} (device entry)")
    assert_equal(win.frame_valid, out_j.frame_valid)
