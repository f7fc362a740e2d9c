"""Port parity: the landmark-sharded BA over ``torch.distributed``
(``dsopp_tpu_torch/parallel/``) and the tracker over ``seq`` ranks, on a gloo
world of 4 CPU processes.

Ports ``tests/parallel/test_sharded.py`` (its tests that are not marked
slow), ``tests/parallel/test_shard_map_ba.py``,
``tests/parallel/test_sharded_solver.py``, both halves of
``tests/parallel/test_dcn_two_process.py`` (one BA iteration on the hybrid
mesh; the full solve and the fold) and ``__graft_entry__.py``'s
``_dryrun_tracked_segment``.  The JAX package's problems
(``__graft_entry__._tiny_problem``: 4 frames, 64 landmarks, 48×48, f64; the
second sequence's inverse depths scaled by 1.01), its ``batched_train_step``
and its ``jax.vmap`` of ``solve_and_marginalize`` (the LM solve, then slot 1
and its live landmarks folded into the ledger) are computed here and handed
to the workers as a ``.npz`` (``dsopp_tpu_torch/testing/parallel_check.py``,
which imports no JAX); one ``torch.multiprocessing`` spawn runs every mesh:
2 × 2 (two sequences over ``seq``, two landmark shards each), 1 × 4,
``make_hybrid_mesh`` with two "nodes" of two ranks, and 4 × 1 for the
tracker (the segment's four sequences, 64×80, 20 frames after a 4-frame
known-pose bootstrap, one a rank).

Tolerances: the sharded step against the single-process step 1e-8
relative (reduction order only, as the JAX tests hold theirs); the
single-process step against JAX's ``batched_train_step`` 1e-9 of the
largest entry (``tests/test_torch_ba.py``'s hold on K7 and K8's plain
versions), the step and the energy 1e-7 relative
(``tests/test_torch_ba_solve.py``'s on K9's).  The solve and the fold:
the single-process run against JAX's with ``test_solve_loop_matches``'s
1e-7 relative and statuses equal, the sharded runs against the
single-process one with ``tests/parallel/test_sharded_solver.py``'s
(energy 1e-8 relative, counts equal, every window field 1e-6 relative /
1e-9 absolute), the ranks of an ``lm`` row equal to the bit.  The tracker's
sequences equal to the bit to the single-process batched run.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu_torch import convert
from dsopp_tpu_torch.parallel import mesh as tmesh
from dsopp_tpu_torch.parallel.shard_map_ba import (LM_FIELDS, RES_FIELDS, pack_shards,
                                                   unpack_shards)
from dsopp_tpu_torch.parallel.sharded import (SeqRankTracker,
                                              batched_solve_and_marginalize,
                                              batched_train_step, stack_windows,
                                              window_pspec)
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.testing import parallel_check as pc
from dsopp_tpu_torch.tracker.batched_loop import BatchedPipelinedTracker

from tests._torch_port import assert_close, assert_equal, to_np, window_fields

NAMES = ("eps", "idepth", "energy", "n_valid", "step_sq")
LANDMARKS = 64
SHARD_RTOL = 1e-8
F64_TOL, SOLVE_RTOL = 1e-9, 1e-7
# tests/parallel/test_sharded_solver.py's hold on every window field
FIELD_RTOL, FIELD_ATOL = 1e-6, 1e-9
STATUS_FIELDS = ("res_status", "lm_outlier", "lm_inliers", "lm_opt_count")
# a collective one rank skips: the group's timeout, and the most the spawn may take
SKIP_TIMEOUT, SKIP_LIMIT = 3.0, 20.0


def _jax_problems():
    import __graft_entry__ as ge

    window, cam = ge._tiny_problem(dtype=jnp.float64, landmarks=LANDMARKS, size=48)
    return [window, dataclasses.replace(window, lm_idepth=window.lm_idepth * 1.01)], cam


def _jax_solve_and_marginalize(cam):
    """``tests/parallel/test_sharded_solver.py``'s ``solve_and_marginalize``."""
    from dsopp_tpu.solvers.pba import PBAOptions, _marginalize_device, _solve_loop_device
    from dsopp_tpu.tracker.marginalization import kept_first_perm

    opts = PBAOptions()

    def fn(w):
        w, e, n = _solve_loop_device(w, cam, opts)
        frame_flags = jnp.zeros(w.frame_valid.shape, bool).at[1].set(True)
        w = dataclasses.replace(w, frame_marg=frame_flags,
                                lm_marg_flag=w.lm_valid & frame_flags[:, None])
        perm = kept_first_perm(w.frame_valid, frame_flags)
        return _marginalize_device(w, cam, perm, opts, True, True), e, n
    return fn


def _segment_reference(seqs):
    """The four segment sequences in one single-process batched tracker (one
    thread, as each rank runs) → each tick's [B, 7] poses and keyframe flags."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe = BatchedPipelinedTracker([pc.segment_tracker(seq, "cpu") for seq in seqs])
        diags = pc.track_segment(pipe, seqs, range(len(seqs)))
        pipe.finalize()
    finally:
        torch.set_num_threads(threads)
    return dict(poses=torch.stack([torch.cat([d.pose_q, d.pose_t], -1) for d in diags], 1),
                keyframes=np.asarray([d.is_keyframe for d in diags]).T)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX reference, the port's single-process steps, solves and tracker
    run, and the 4 ranks' results of every mesh."""
    from dsopp_tpu.parallel.sharded import batched_train_step as jax_step
    from dsopp_tpu.parallel.sharded import stack_windows as jax_stack

    windows, cam = _jax_problems()
    ref = jax_step(jax_stack(windows), cam, jnp.asarray(pc.REG, jnp.float64))
    t0 = time.perf_counter()
    ref_solve = jax.jit(jax.vmap(_jax_solve_and_marginalize(cam)))(jax_stack(windows))
    ref_solve_s = time.perf_counter() - t0
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
    single_solve = batched_solve_and_marginalize(stack_windows(tw), tcam, tpba.PBAOptions())
    seqs = pc.segment_sequences()
    sequences = str(out / "sequences.pt")
    torch.save(seqs, sequences)
    t0 = time.perf_counter()
    segment = _segment_reference(seqs)
    segment_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pc.spawn(4, "meshes", payload, str(out), sequences=sequences)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    print(f"JAX solve + fold {ref_solve_s:.1f} s, the single-process segment {segment_s:.1f} s,"
          f" the spawn {spawn_s:.1f} s")
    return dict(ref=[np.asarray(x) for x in ref], single=single, ranks=ranks, tw=tw,
                tcam=tcam, windows=windows, cam=cam, ref_solve=ref_solve,
                single_solve=single_solve, segment=segment)


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


def _jax_window(stacked, b):
    """Sequence ``b`` of a stacked JAX window as a port Window (the ledger's
    double-float pairs summed)."""
    return convert.window({k: v[b] for k, v in window_fields(stacked).items()})


def test_single_process_solve_and_fold_matches_jax(world):
    """The port's solve + fold of each window (plain versions, f64) against
    JAX's ``vmap(solve_and_marginalize)``: ``test_solve_loop_matches``'s
    tolerances, statuses equal, and a non-empty ledger."""
    (w_j, e_j, n_j), (w_t, e_t, n_t) = world["ref_solve"], world["single_solve"]
    assert_equal(n_t, np.asarray(n_j))
    assert int(n_t.min()) > 0
    assert_close(e_t, np.asarray(e_j), rtol=SOLVE_RTOL)
    for b in range(2):
        want = _jax_window(w_j, b)
        got = tpba.window_at(w_t, b)
        for name in ("eps", "affine0", "t_lin_q", "t_lin_t", "lm_idepth", "lm_baseline",
                     "h_marg", "b_marg", "energy_marg"):
            assert_close(getattr(got, name), getattr(want, name), rtol=SOLVE_RTOL,
                         atol=1e-12 * max(1.0, float(getattr(want, name).abs().max())),
                         err_msg=f"{b} {name}")
        for name in STATUS_FIELDS + ("lm_valid", "frame_valid", "frame_id"):
            assert_equal(getattr(got, name), getattr(want, name), err_msg=f"{b} {name}")
        assert float(got.h_marg.abs().max()) > 0


@pytest.mark.parametrize("key,num_lm", [("2x2 solve", 2), ("1x4 solve", 4)])
def test_sharded_solve_and_fold_matches_single_process(world, key, num_lm):
    """The landmark-sharded solve + fold on each rank (its sequences, its
    landmark shard) against the single-process run: energy 1e-8 relative,
    counts equal, every window field 1e-6 / 1e-9, statuses equal; the ranks
    of an lm row equal to each other to the bit, the landmark fields of the
    row's shards together the whole window's."""
    w_s, e_s, n_s = world["single_solve"]
    rows = {}
    for out in world["ranks"]:
        (s, lm), (w, e, n) = out[key]["coords"], out[key]["solve"]
        rows.setdefault(s, {})[lm] = (w, e, n)
        per = e.shape[0]
        for j in range(per):
            b = s * per + j
            assert_close(e[j], e_s[b], rtol=SHARD_RTOL, err_msg=f"{key} {s, lm} energy")
            assert int(n[j]) == int(n_s[b])
    for s, row in rows.items():
        first = row[0][0]
        for lm in range(1, num_lm):
            for f in dataclasses.fields(tpba.Window):
                if f.name in LM_FIELDS + RES_FIELDS:
                    continue
                a, b = getattr(row[lm][0], f.name), getattr(first, f.name)
                assert (a is None and b is None) or torch.equal(a, b), (key, s, lm, f.name)
            assert torch.equal(row[lm][1], row[0][1]) and torch.equal(row[lm][2], row[0][2])
        per = first.eps.shape[0]
        for j in range(per):
            want = tpba.window_at(w_s, s * per + j)
            for f in dataclasses.fields(tpba.Window):
                got = getattr(first, f.name)
                if got is None:
                    continue
                if f.name in LM_FIELDS + RES_FIELDS:
                    got = torch.cat([getattr(row[lm][0], f.name) for lm in range(num_lm)],
                                    dim=-1 if f.name == "res_status" else 2)
                got, ref = got[j], getattr(want, f.name)
                if ref.dtype.is_floating_point:
                    assert_close(got, ref, rtol=FIELD_RTOL, atol=FIELD_ATOL,
                                 err_msg=f"{key} {s} {f.name}")
                else:
                    assert_equal(got, ref, err_msg=f"{key} {s} {f.name}")
        assert float(first.h_marg.abs().max()) > 0


def test_seq_rank_tracker_matches_single_process(world):
    """``_dryrun_tracked_segment`` on the 4 × 1 mesh: each rank tracks its
    sequence, every rank holds the four gathered trajectories, and each
    sequence's poses and keyframes equal the single-process batched run's
    to the bit, with keyframes taken."""
    ref = world["segment"]
    for r, out in enumerate(world["ranks"]):
        got = out["4x1 tracker"]
        assert got["coords"] == (r, 0) and got["sequences"] == [r]
        trajectories = got["trajectories"]
        assert [t["sequence"] for t in trajectories] == [0, 1, 2, 3]
        for b, t in enumerate(trajectories):
            assert np.array_equal(t["poses"], ref["poses"][b].numpy()), (r, b)
            assert np.array_equal(t["keyframes"], ref["keyframes"][b]), (r, b)
            assert t["keyframes"].sum() > 0
            assert np.array_equal(t["frame_ids"],
                                  np.arange(pc.SEGMENT_INIT, pc.SEGMENT_INIT + pc.SEGMENT_FRAMES))
            times, mats = t["trajectory"]
            assert len(times) == len(mats) > 0 and np.isfinite(mats).all()
        if r:
            for a, b in zip(trajectories, world["ranks"][0]["4x1 tracker"]["trajectories"]):
                assert all(np.array_equal(x, y) for x, y in zip(a["trajectory"], b["trajectory"]))


def test_seq_rank_tracker_refuses_lm_ranks():
    """The tracker shards sequences only."""
    mesh = tmesh.Mesh(1, 2, 0, 0, None, None)
    with pytest.raises(ValueError):
        SeqRankTracker(lambda b, device: None, 2, mesh, device="cpu")


def test_exact_gather_is_the_whole_tensor():
    """K11's gather: the sum of the shards' packed buffers unpacks to the
    whole tensors to the bit, for every dtype the gather carries (negative
    zeros and NaNs of a float included)."""
    gen = torch.Generator().manual_seed(0)
    whole = [torch.randn((3, 4, 12), generator=gen), torch.randn((4, 12), generator=gen).double(),
             torch.randint(-5, 5, (4, 12), generator=gen, dtype=torch.int32),
             torch.rand((4, 12), generator=gen) > 0.5]
    whole[0][0, 0, :3] = torch.tensor([-0.0, float("nan"), float("-inf")])
    for num_lm in (2, 4):
        n = 12 // num_lm
        shards = [[x[..., i * n:(i + 1) * n] for x in whole] for i in range(num_lm)]
        total = sum(pack_shards(shard, i, num_lm) for i, shard in enumerate(shards))
        for got, want in zip(unpack_shards(total, shards[0], num_lm), whole):
            assert got.dtype == want.dtype
            if want.dtype.is_floating_point:
                assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            else:
                assert torch.equal(got, want)


def test_rank_device_is_the_callers_or_the_card():
    """A device given is kept; without one and without a group the rank runs
    on the card, and raises where there is none."""
    assert tmesh.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.rank_device()


def test_skipped_collective_times_out(tmp_path):
    """A collective that one rank skips fails within the group's timeout
    (given to ``initialize_distributed``) instead of hanging the run."""
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="(?i)timed? ?out"):
        pc.spawn(2, "skip", "", str(tmp_path), timeout=SKIP_TIMEOUT)
    assert time.perf_counter() - t0 < SKIP_LIMIT
