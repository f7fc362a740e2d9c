"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

The JAX side runs on the CPU in float64 (``tests/conftest.py``); the port
runs its plain PyTorch versions on the CPU in float64.  Data crosses between
the two packages as numpy only.
"""

import dataclasses

import jax
import numpy as np
import torch

# the suite runs several pytest workers on a few cores
torch.set_num_threads(1)

F64 = torch.float64


def to_np(x):
    """A torch tensor / JAX array / pytree leaf → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_torch(x, dtype=F64):
    a = np.array(x)
    if a.dtype == np.bool_:
        return torch.tensor(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int32))
    return torch.tensor(a.astype(np.float64), dtype=dtype)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def window_fields(window):
    """A JAX ``Window`` → dict of numpy arrays keyed by field name."""
    return {f.name: np.asarray(getattr(window, f.name))
            for f in dataclasses.fields(window)}


def state_fields(state):
    """A JAX ``DeviceTrackerState`` → the dict ``convert.device_tracker_state`` takes."""
    out = {k: np.asarray(getattr(state, k)) for k in (
        "last_q", "last_t", "prev_q", "prev_t", "last_affine", "rmse_last0",
        "kf_rmse", "min_distance")}
    out["window"] = window_fields(state.window)
    out["immature"] = np_tree(state.immature._asdict())
    out["depth_idepth"] = [np.asarray(x) for x in state.depth_idepth]
    out["depth_weight"] = [np.asarray(x) for x in state.depth_weight]
    out["level_points"] = [tuple(np.asarray(v) for v in p) for p in state.level_points]
    out["flow_points"] = tuple(np.asarray(v) for v in state.flow_points)
    return out


def assert_close(actual, expected, rtol=0.0, atol=0.0, err_msg=""):
    np.testing.assert_allclose(to_np(actual), to_np(expected), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def assert_equal(actual, expected, err_msg=""):
    np.testing.assert_array_equal(to_np(actual), to_np(expected), err_msg=err_msg)
