"""Port parity: the landmark-sharded BA step over ``torch.distributed``
(``dsopp_tpu_torch/parallel/``) on a gloo world of 4 CPU processes.

Ports ``tests/parallel/test_sharded.py`` (its tests that are not marked
slow), ``tests/parallel/test_shard_map_ba.py`` and the first half of
``tests/parallel/test_dcn_two_process.py`` (one BA iteration on the hybrid
mesh).  The JAX package's problems (``__graft_entry__._tiny_problem``: 4
frames, 64 landmarks, 48×48, f64; the second sequence's inverse depths
scaled by 1.01) and its ``batched_train_step`` are computed here and handed
to the workers as a ``.npz`` (``dsopp_tpu_torch/testing/parallel_check.py``,
which imports no JAX); one ``torch.multiprocessing`` spawn runs every mesh:
2 × 2 (two sequences over ``seq``, two landmark shards each), 1 × 4 and
``make_hybrid_mesh`` with two "nodes" of two ranks.

Tolerances: the sharded step against the single-process step 1e-8
relative (reduction order only, as the JAX tests hold theirs); the
single-process step against JAX's ``batched_train_step`` 1e-9 of the
largest entry (``tests/test_torch_ba.py``'s hold on K7 and K8's plain
versions), the step and the energy 1e-7 relative
(``tests/test_torch_ba_solve.py``'s on K9's).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu_torch.parallel import mesh as tmesh
from dsopp_tpu_torch.parallel.sharded import (batched_train_step, stack_windows,
                                              window_pspec)
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.testing import parallel_check as pc

from tests._torch_port import assert_close, to_np

NAMES = ("eps", "idepth", "energy", "n_valid", "step_sq")
LANDMARKS = 64
SHARD_RTOL = 1e-8
F64_TOL, SOLVE_RTOL = 1e-9, 1e-7


def _jax_problems():
    import __graft_entry__ as ge

    window, cam = ge._tiny_problem(dtype=jnp.float64, landmarks=LANDMARKS, size=48)
    return [window, dataclasses.replace(window, lm_idepth=window.lm_idepth * 1.01)], cam


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX reference, the port's single-process steps and the 4 ranks'
    results of every mesh."""
    from dsopp_tpu.parallel.sharded import batched_train_step as jax_step
    from dsopp_tpu.parallel.sharded import stack_windows as jax_stack

    windows, cam = _jax_problems()
    ref = jax_step(jax_stack(windows), cam, jnp.asarray(pc.REG, jnp.float64))
    arrays = {f"{prefix}{f.name}": np.asarray(getattr(w, f.name))
              for prefix, w in (("window_", windows[0]), ("window1_", windows[1]))
              for f in dataclasses.fields(w)}
    arrays.update({f"cam_{k}": np.asarray(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy")})
    arrays["cam_size"] = np.asarray(cam.image_size)
    out = tmp_path_factory.mktemp("gloo")
    payload = str(out / "payload.npz")
    np.savez(payload, **arrays)
    data = np.load(payload)
    tw = [pc.window_from_npz(data, "window_"), pc.window_from_npz(data, "window1_")]
    tcam = pc.camera_from_npz(data)
    single = batched_train_step(stack_windows(tw), tcam, pc.REG, tpba.PBAOptions())
    pc.spawn(4, "meshes", payload, str(out))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return dict(ref=[np.asarray(x) for x in ref], single=single, ranks=ranks, tw=tw,
                tcam=tcam, windows=windows, cam=cam)


def _rel(a, b):
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _shard(x, lm: int, num_lm: int):
    n = x.shape[-1] // num_lm
    return x[..., lm * n:(lm + 1) * n]


def _check_batched(world, key, num_lm):
    """Each rank's sequences (its seq coordinate's) against the
    single-process step, idepth on its landmark shard."""
    single = world["single"]
    for r, out in enumerate(world["ranks"]):
        s, lm = out[key]["coords"]
        step = out[key]["step"]
        per = step[0].shape[0]
        for j in range(per):
            b = s * per + j
            assert _rel(step[0][j], single[0][b]) < SHARD_RTOL, (key, r, "eps")
            assert _rel(step[1][j], _shard(single[1][b], lm, num_lm)) < SHARD_RTOL, (key, r)
            assert _rel(step[2][j], single[2][b]) < SHARD_RTOL, (key, r, "energy")
            assert int(step[3][j]) == int(single[3][b]), (key, r, "n_valid")
            assert _rel(step[4][j], single[4][b]) < SHARD_RTOL, (key, r, "step_sq")


def test_single_process_step_matches_jax(world):
    """The port's ``batched_train_step`` without a mesh (K7, K8, K9's plain
    versions) against JAX's on the same two windows."""
    for i, name in enumerate(NAMES):
        want, got = world["ref"][i], to_np(world["single"][i])
        if name == "n_valid":
            np.testing.assert_array_equal(got, want)
        elif name in ("energy", "step_sq"):
            assert_close(got, want, rtol=SOLVE_RTOL, err_msg=name)
        else:
            assert_close(got, want, rtol=F64_TOL, atol=F64_TOL * float(np.abs(want).max()),
                         err_msg=name)
    assert not torch.equal(world["single"][0][0], world["single"][0][1])


def test_sharded_matches_single_device(world):
    """dp × mp: the 2 × 2 mesh's step equals the single-process step."""
    _check_batched(world, "2x2", 2)


def test_lm_only_mesh(world):
    """The 1 × 4 mesh: every rank steps both sequences on its quarter of the
    landmarks; finite energies equal to the single-process ones."""
    for out in world["ranks"]:
        assert bool(torch.isfinite(out["1x4 batched"]["step"][2]).all())
    _check_batched(world, "1x4 batched", 4)


def test_entry_point(world):
    """One Gauss-Newton iteration of the tiny problem
    (``__graft_entry__.entry``'s step, ``pba._pba_iteration``) against JAX's,
    its outputs finite."""
    from dsopp_tpu.solvers.pba import _fej_cache, _pba_iteration, active_lm_mask

    window, cam = world["windows"][0], world["cam"]
    want = _pba_iteration(window, cam, _fej_cache(window, cam), window.eps, window.lm_idepth,
                          active_lm_mask(window), jnp.asarray(pc.REG, jnp.float64),
                          tpba.PBAOptions())
    tw = world["tw"][0]
    got = tpba._pba_iteration(tw, world["tcam"], tw.eps, tw.lm_idepth,
                              tpba.active_lm_mask(tw), pc.REG, tpba.PBAOptions())
    assert all(bool(torch.isfinite(x).all()) for x in got)
    for name, a, b in zip(("eps", "idepth"), got, want):
        b = np.asarray(b)
        assert_close(a, b, rtol=F64_TOL, atol=F64_TOL * float(np.abs(b).max()), err_msg=name)
    assert_close(got[2], np.asarray(want[2]), rtol=SOLVE_RTOL)


@pytest.mark.parametrize("key,num_lm", [("1x4", 4), ("2x2 shard_map", 2)])
def test_shard_map_matches_single_device(world, key, num_lm):
    """The explicit all-reduced step on an lm axis of 4 (1 × 4) and of 2 with
    a seq axis present (2 × 2) against the single-process step."""
    single = world["single"]
    for out in world["ranks"]:
        _, lm = out[key]["coords"]
        eps, idepth, step_sq, energy, n_valid = out[key]["step"]
        assert _rel(eps, single[0][0]) < SHARD_RTOL
        assert _rel(idepth, _shard(single[1][0], lm, num_lm)) < SHARD_RTOL
        assert _rel(step_sq, single[4][0]) < SHARD_RTOL
        assert _rel(energy, single[2][0]) < SHARD_RTOL
        assert int(n_valid) == int(single[3][0])


def test_hybrid_mesh_over_two_nodes(world):
    """``make_hybrid_mesh`` with two nodes of two ranks: lm rows inside a
    node, seq across; its step equals the single-process one (the DCN test's
    first half, whose gate is 1e-3)."""
    for r, out in enumerate(world["ranks"]):
        assert out["hybrid"]["shape"] == {"seq": 2, "lm": 2}
        assert out["hybrid"]["coords"] == (r // 2, r % 2)
    _check_batched(world, "hybrid", 2)


def test_hybrid_mesh_single_process_fallback():
    """One process without a group: the hybrid mesh is a plain 1 × 1 mesh."""
    mesh = tmesh.make_hybrid_mesh()
    assert mesh.axis_names == ("seq", "lm")
    assert mesh.shape == {"seq": 1, "lm": 1}
    assert (mesh.seq_index, mesh.lm_index, mesh.lm_group) == (0, 0, None)
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, 4)


def test_backend_is_the_callers_choice():
    """No backend is picked for a world of several processes; one process
    without a coordinator needs none."""
    tmesh.initialize_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        tmesh.initialize_distributed("tcp://localhost:1", 2, 0)


def test_window_pspec_names_the_sharded_fields():
    spec = window_pspec(batched=True)
    assert spec["lm_idepth"] == ("seq", None, "lm")
    assert spec["res_status"] == ("seq", None, None, "lm")
    assert spec["h_marg"] == ("seq",)
    assert window_pspec(batched=False)["lm_uv"] == (None, "lm")
