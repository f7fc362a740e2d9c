"""The exposure-oscillation run of ``tests/tracker/test_monocular_e2e.py``
(240×320, 40 frames, 8-frame known-pose bootstrap) in f64 on the CPU, every
tick of the JAX package's device loop replayed on the port from the JAX
state before it (``tests/torch_e2e_reference.py::replay``).  The free run
forks at one keyframe's BA with the last bits of the reductions
(``tests/test_torch_e2e.py``); a tick from a common state does not.

Tolerance: the same keyframe decision on every tick; the port's pose and,
on keyframes, its BA-refined window translations within REPLAY_TOL m of
JAX's.
"""

import jax.numpy as jnp

from dsopp_tpu.testing import render_sequence
from dsopp_tpu_torch.testing import paths

from tests import torch_e2e_reference as reference

REPLAY_TOL = 1e-7


def test_exposure_run_replays_jax():
    """The same decisions on all 32 ticks (at least 4 keyframes), poses and
    windows within REPLAY_TOL."""
    seq = render_sequence(num_frames=paths.E2E_FRAMES, height=paths.E2E_SIZE[0],
                          width=paths.E2E_SIZE[1])
    records = reference.replay(seq, jnp.float64)
    assert len(records) == paths.E2E_FRAMES - paths.E2E_INIT_FRAMES
    assert [r[1] for r in records] == [r[2] for r in records]
    assert sum(r[1] for r in records) >= 4
    assert max(r[3] for r in records) < REPLAY_TOL
    assert max(r[4] for r in records if r[4] is not None) < REPLAY_TOL
