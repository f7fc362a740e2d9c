"""Port parity: B sequences in one batched tick
(``dsopp_tpu_torch/tracker/batched_loop.py``) against the port's own solo
runs, and one batched tick against the JAX package's ``batched_device_tick``.

The five tests of ``tests/tracker/test_batched_loop.py`` at that file's
sizes (3 sequences, 120×160, f64, 24 tracked ticks), on the plain versions
(the CPU).  The JAX file can only hold its batched program to its solo
program loosely (two compilations tile their reductions differently); the
port's batched tick runs each sequence through the same plain versions as
its solo tick, so here the batched run must equal the solo runs to the bit:
keyframes, poses and trajectories.  Beside them:

* one batched tick from the converted JAX states of three initialized JAX
  trackers against JAX's ``batched_device_tick``: the same keyframe and
  escalation flags, poses within ``tests/test_torch_e2e_replay.py``'s 1e-7
  m, the frontend's values within ``tests/test_torch_tracker.py``'s 1e-9
  relative (its ``RTOL``, a tick without a BA solve between);
* the batched re-track: one sequence's gate closed, the others' open, the
  perturbed chunks run for that sequence only, every sequence's state equal
  to the bit to its solo tick;
* K1, K3, K4 and K5's plain versions with the leading axis against B solo
  calls (K3 on hypotheses of interleaved sequences);
* one tick with every sequence forced to take a keyframe (the keyframe
  backend's three phases once for the three sequences): against JAX's
  ``batched_device_tick`` from the same converted states (the JAX tick's
  compiled program reused: its forced flags are an argument), and each
  sequence equal to the bit to its solo ``device_tick``;
* one tick with the forced flags (True, False, True): the keyframe backend
  once for sequences 0 and 2, written into their rows of the stack in
  place; every sequence equal to the bit to its solo tick, sequence 1's
  window and frontend state untouched, and the stacked ``maps`` keeping its
  storage.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu_torch import convert
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features.pyramid import build_pyramid_maps
from dsopp_tpu_torch.solvers.pose_alignment import (LevelPoints, align_level,
                                                    align_level_plain)
from dsopp_tpu_torch.testing import render_sequence
from dsopp_tpu_torch.tracker import batched_loop as bl
from dsopp_tpu_torch.tracker.depth_estimation import estimate_depths
from dsopp_tpu_torch.tracker.depth_map import frame_statistics
from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker, TickDiag, device_tick
from dsopp_tpu_torch.tracker.fused_tick import CHUNK, _initialization_hypotheses
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests._torch_port import assert_close, state_fields, to_np

NUM_FRAMES = 30
INIT_FRAMES = 6
H, W = 120, 160
B = 3
SEQUENCES = ((7, 0.08), (11, 0.06), (13, 0.10))    # (seed, advance) of each sequence
F64 = torch.float64
POSE_TOL = 1e-7      # m, tests/test_torch_e2e_replay.py's REPLAY_TOL
RTOL = 1e-9          # tests/test_torch_tracker.py's RTOL (no BA solve between)
RTOL_SOLVE = 1e-7    # tests/test_torch_tracker.py's RTOL_SOLVE (across a windowed BA solve)

CFG = TrackerConfig(
    num_frame_slots=7,
    landmarks_per_frame=96,
    immature_per_frame=192,
    desired_points=400,
    frontend_points=600,
    keyframe_factor=3.0,
    window_min=3,
    window_max=4,   # small window → frame marginalization happens in-run
    use_rotation_perturbations=False,
)


@functools.lru_cache(maxsize=None)
def _sequences():
    return [render_sequence(num_frames=NUM_FRAMES, height=H, width=W, seed=seed,
                            advance=adv, dtype=F64, device="cpu")
            for seed, adv in SEQUENCES]


@functools.lru_cache(maxsize=None)
def _initialized(b: int):
    seq = _sequences()[b]
    tracker = MonocularTracker(seq.camera, CFG, dtype=F64, device="cpu")
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i], seq.pose(i, F64, "cpu"))
                        for i in range(INIT_FRAMES)])
    return tracker


def _make_tracker(b: int):
    """A fresh copy of sequence b's tracker after the known-pose bootstrap."""
    return copy.deepcopy(_initialized(b))


def _leaves(tree):
    out = []
    bl._tree_map(lambda x: out.append(x) or x, tree)
    return out


@pytest.fixture(scope="module")
def seqs():
    return _sequences()


@pytest.fixture(scope="module")
def runs(seqs):
    solo, solo_poses = [], []
    for b, seq in enumerate(seqs):
        t = _make_tracker(b)
        pipe = PipelinedTracker(t, flush_every=7)
        solo_poses.append(torch.stack([pipe.tick(i, float(seq.timestamps[i]),
                                                 seq.images[i]).pose_t
                                       for i in range(INIT_FRAMES, NUM_FRAMES)]))
        pipe.finalize()
        solo.append(t)
    batched = [_make_tracker(b) for b in range(B)]
    bpipe = bl.BatchedPipelinedTracker(batched, flush_every=7)
    poses = []
    for i in range(INIT_FRAMES, NUM_FRAMES):
        diag = bpipe.tick([i] * B, [float(s.timestamps[i]) for s in seqs],
                          [s.images[i] for s in seqs])
        poses.append(diag.pose_t)
    bpipe.finalize()
    return dict(solo=solo, solo_poses=solo_poses, batched=batched,
                poses=torch.stack(poses, dim=1))


def test_keyframe_decisions_match(runs):
    """Every keyframe of the batched run is the solo run's (the JAX file
    excuses the final tick; the port's plain versions give the same bits),
    the poses equal to the bit, and the sequences differ from each other."""
    for b, (s, t) in enumerate(zip(runs["solo"], runs["batched"])):
        assert sorted(s.track.keyframe_timestamps) == sorted(t.track.keyframe_timestamps)
        assert torch.equal(runs["poses"][b], runs["solo_poses"][b])
    kfs = [tuple(sorted(t.track.keyframe_timestamps)) for t in runs["batched"]]
    assert len(set(kfs)) > 1


def test_replicated_batch_bitwise(seqs):
    """B replicas of one sequence stay bitwise identical over a full run."""
    seq = seqs[0]
    trackers = [_make_tracker(0) for _ in range(B)]
    bpipe = bl.BatchedPipelinedTracker(trackers, flush_every=9)
    for i in range(INIT_FRAMES, NUM_FRAMES):
        bpipe.tick([i] * B, [float(seq.timestamps[i])] * B, [seq.images[i]] * B)
    bpipe.finalize()
    for leaf in _leaves(bpipe.states):
        for b in range(1, B):
            assert torch.equal(leaf[b], leaf[0])
    t0 = trackers[0].track.trajectory(trackers[0].window)
    for t in trackers[1:]:
        tb = t.track.trajectory(t.window)
        assert len(tb) == len(t0)
        for (ta, ma), (tb_, mb) in zip(t0, tb):
            assert ta == tb_
            np.testing.assert_array_equal(ma, mb)


def _tick_both(seqs, cfg_change=None, state_change=None, force=False, stacked=None):
    """One batched tick from the initialized trackers' states (each changed
    by ``state_change(b, state)``) and each sequence's solo ``device_tick``
    from the same state; ``force``: every sequence forced to take a keyframe
    (a bool) or each sequence's flag (B bools) → (batched state, diag,
    [(solo state, diag)]).  ``stacked`` (a list) receives the stacked state
    the batched tick was given."""
    pipes = [PipelinedTracker(_make_tracker(b)) for b in range(len(seqs))]
    cfg = pipes[0].cfg if cfg_change is None else cfg_change(pipes[0].cfg)
    states = [p.state if state_change is None else state_change(b, p.state)
              for b, p in enumerate(pipes)]
    forces = [force] * B if isinstance(force, bool) else list(force)
    images = torch.stack([s.images[INIT_FRAMES] for s in seqs])
    solo = [device_tick(states[b], images[b], INIT_FRAMES, forces[b], pipes[0].models, cfg)
            for b in range(len(seqs))]
    given = bl.stack_states(states)
    if stacked is not None:
        stacked.append(given)
    new, diag = bl.batched_device_tick(given, images, [INIT_FRAMES] * B, forces,
                                       pipes[0].models, pipes[0].mask, cfg)
    return new, diag, solo


def _assert_state_equal(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_single_tick_parity(seqs):
    """One batched tick from identical states equals each solo tick to the
    bit: the whole state and the diagnostics."""
    new, diag, solo = _tick_both(seqs)
    for b, (state, sdiag) in enumerate(solo):
        _assert_state_equal(bl.unstack_state(new, b), state)
        got = diag.sequence(b)
        assert got.is_keyframe == sdiag.is_keyframe
        for name in ("pose_q", "pose_t", "affine", "rmse", "flow", "flow_no_rot",
                     "num_valid_align", "t_kf_frame_mat", "min_distance"):
            assert torch.equal(getattr(got, name), getattr(sdiag, name)), name


def test_forced_keyframe_tick_parity(seqs):
    """Every sequence forced to take a keyframe: the batched backend's
    solver half runs once for the three sequences, and each sequence's
    state and keyframe diagnostics equal its solo tick's to the bit."""
    new, diag, solo = _tick_both(seqs, force=True)
    assert diag.is_keyframe == (True,) * B
    for b, (state, sdiag) in enumerate(solo):
        _assert_state_equal(bl.unstack_state(new, b), state)
        got = diag.sequence(b)
        assert got.is_keyframe and sdiag.is_keyframe
        for name in TickDiag._fields[TickDiag._fields.index("energy"):-1]:
            a, w = getattr(got, name), getattr(sdiag, name)
            assert a.shape == w.shape and torch.equal(a, w), name
    assert bool((new.window.h_marg != 0).any())


def test_mixed_keyframe_tick_writes_the_keyframing_rows_in_place(seqs):
    """Forced flags (True, False, True), and the keyframe strategy's factor 0
    and sequence 1's rmse memory far above its rmse, so that it does not
    decide one itself: the keyframe backend runs
    once for sequences 0 and 2 and writes their rows of the stack in place.
    Every sequence's state and diagnostics equal its solo tick's to the bit;
    sequence 1's window, depth maps, point sets and min distance are the
    stack's as given; the stacked ``maps`` keeps its storage."""
    def no_decision(b, state):
        return state._replace(kf_rmse=torch.full_like(state.kf_rmse, 1e9)) if b == 1 else state

    given = []
    new, diag, solo = _tick_both(seqs, lambda cfg: cfg._replace(keyframe_factor=0.0),
                                 no_decision, force=(True, False, True), stacked=given)
    assert diag.is_keyframe == (True, False, True)
    for b, (state, sdiag) in enumerate(solo):
        assert sdiag.is_keyframe == diag.is_keyframe[b]
        _assert_state_equal(bl.unstack_state(new, b), state)
        if b != 1:
            got = diag.sequence(b)
            for name in TickDiag._fields[TickDiag._fields.index("energy"):-1]:
                a, w = getattr(got, name), getattr(sdiag, name)
                assert a.shape == w.shape and torch.equal(a, w), name
    assert new.window.maps.data_ptr() == given[0].window.maps.data_ptr()
    untouched = no_decision(1, PipelinedTracker(_make_tracker(1)).state)
    for name in ("window", "depth_idepth", "depth_weight", "level_points", "flow_points",
                 "min_distance"):
        _assert_state_equal(getattr(bl.unstack_state(new, 1), name), getattr(untouched, name))


def test_retrack_runs_for_the_escalated_sequence_only(seqs):
    """With the re-track armed and sequence 1's gate closed, sequence 1
    escalates and the others do not; every sequence's state equals its solo
    tick's to the bit."""
    def close_gate(b, state):
        return state._replace(rmse_last0=torch.full_like(state.rmse_last0, 1e-3)) \
            if b == 1 else state
    new, diag, solo = _tick_both(seqs, lambda cfg: cfg._replace(with_perturbations=True),
                                 close_gate)
    assert diag.escalated == (False, True, False)
    for b, (state, sdiag) in enumerate(solo):
        assert sdiag.escalated == diag.escalated[b]
        _assert_state_equal(bl.unstack_state(new, b), state)
        assert torch.equal(diag.sequence(b).pose_t, sdiag.pose_t)


def _rmse_vs_gt(seq, tracker):
    by_ts = {float(seq.timestamps[i]): seq.poses_t[i] for i in range(NUM_FRAMES)}
    errs = [np.linalg.norm(mat[:3, 3] - by_ts[ts])
            for ts, mat in tracker.track.trajectory(tracker.window) if ts in by_ts]
    return float(np.sqrt(np.mean(np.square(errs))))


def test_tracking_quality_matches(seqs, runs):
    """Both runs track alike against ground truth: the same trajectory
    timestamps and the same RMSE (the JAX file's gates: below 0.2 m, within
    5e-2 m of each other)."""
    for seq, s, b in zip(seqs, runs["solo"], runs["batched"]):
        ts, tb = s.track.trajectory(s.window), b.track.trajectory(b.window)
        assert [t for t, _ in ts] == [t for t, _ in tb]
        rmse_s, rmse_b = _rmse_vs_gt(seq, s), _rmse_vs_gt(seq, b)
        assert rmse_b < 0.2, f"batched run tracks poorly: {rmse_b:.4f} m"
        assert abs(rmse_b - rmse_s) < 5e-2
        assert rmse_b == rmse_s


def test_marginalization_bookkeeping_matches(runs):
    """Every keyframe is marginalized or in the live window, in both runs,
    and the marginalized keyframes are the same."""
    assert any(len(s.track.marginalized) > 0 for s in runs["solo"])

    def coverage(t):
        ids = {m.frame_id for m in t.track.marginalized}
        return ids | {int(i) for i in to_np(t.window.frame_id) if i >= 0}

    for s, b in zip(runs["solo"], runs["batched"]):
        assert coverage(s) == coverage(b)
        assert [m.frame_id for m in s.track.marginalized] == \
            [m.frame_id for m in b.track.marginalized]


@pytest.fixture(scope="module")
def jax_tick():
    """Three JAX trackers initialized on JAX's renders, one JAX batched tick
    from their stacked states, and the port's from the same states."""
    from dsopp_tpu.core.lie import SE3 as JSE3
    from dsopp_tpu.testing import render_sequence as jax_render
    from dsopp_tpu.tracker import batched_loop as jbl
    from dsopp_tpu.tracker import device_loop as jdl
    from dsopp_tpu.tracker.device_loop import PipelinedTracker as JPipe
    from dsopp_tpu.tracker.monocular import MonocularTracker as JTracker
    from dsopp_tpu.tracker.monocular import TrackerConfig as JConfig

    cfg = JConfig(**dataclasses.asdict(CFG))
    seqs = [jax_render(num_frames=INIT_FRAMES + 1, height=H, width=W, seed=seed, advance=adv)
            for seed, adv in SEQUENCES]
    pipes = []
    for seq in seqs:
        t = JTracker(seq.camera, cfg, dtype=jnp.float64)
        t.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                       JSE3(jnp.asarray(seq.pose_t_wc(i).q, jnp.float64),
                            jnp.asarray(seq.pose_t_wc(i).t, jnp.float64)))
                      for i in range(INIT_FRAMES)])
        pipes.append(JPipe(t))
    states = jbl.stack_states([p.state for p in pipes])
    # converted (copied) before the JAX tick, which donates the states; the
    # forced tick starts from a copy of the same states
    fields = state_fields(states)
    port_states = convert.stacked_device_tracker_state(fields)
    forced_states = jax.tree_util.tree_map(jnp.copy, states)
    images = np.stack([np.asarray(s.images[INIT_FRAMES], np.float64) for s in seqs])
    args = (jnp.asarray(images), jnp.full(B, INIT_FRAMES, jnp.int32))
    # JAX's frontend of the forced tick: its immature banks are what the
    # port's keyframe backend starts from, as tests/test_torch_tracker.py's
    # keyframe test runs the backend from the JAX frontend's state (the
    # zero-parallax points' sign noise of the epipolar update would change
    # which points the activation takes)
    front = jax.jit(jax.vmap(jdl._frontend_core, in_axes=(0, 0, 0, None, None, 0)),
                    static_argnums=(4,))
    j_front = front(forced_states, args[0], jnp.ones(B, bool), pipes[0].models, pipes[0].cfg,
                    jnp.ones(B, jnp.float64))[0]
    front_banks = convert.stacked_device_tracker_state(state_fields(j_front)).immature
    j_states, j_diag = jbl.batched_device_tick(states, *args, jnp.zeros(B, bool),
                                               pipes[0].models, pipes[0].mask, pipes[0].cfg)
    j_forced, j_forced_diag = jbl.batched_device_tick(forced_states, *args, jnp.ones(B, bool),
                                                      pipes[0].models, pipes[0].mask,
                                                      pipes[0].cfg)
    cam = seqs[0].camera
    port = MonocularTracker(convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size),
                            CFG, dtype=F64, device="cpu")
    models, cfg = tuple(port.models), port.loop_config()
    new, diag = bl.batched_device_tick(port_states, torch.as_tensor(images), [INIT_FRAMES] * B,
                                       [False] * B, models, None, cfg)
    regular_tick = bl.fused_regular_tick
    bl.fused_regular_tick = lambda *a: regular_tick(*a)._replace(immature=front_banks)
    try:
        forced, forced_diag = bl.batched_device_tick(
            convert.stacked_device_tracker_state(fields), torch.as_tensor(images),
            [INIT_FRAMES] * B, [True] * B, models, None, cfg)
    finally:
        bl.fused_regular_tick = regular_tick
    return dict(j_states=state_fields(j_states), j_diag=j_diag, new=new, diag=diag,
                j_forced=state_fields(j_forced), j_forced_diag=j_forced_diag, forced=forced,
                forced_diag=forced_diag)


def test_batched_tick_matches_jax(jax_tick):
    """The port's batched tick from the converted JAX states against JAX's
    ``batched_device_tick``: flags equal, poses within 1e-7 m, the
    frontend's values and the state's frontend fields within 1e-9 (the
    affine of a sequence that took a keyframe is its BA's, left to the
    keyframe tests of ``tests/test_torch_tracker.py``)."""
    j_diag, diag = jax_tick["j_diag"], jax_tick["diag"]
    assert list(diag.is_keyframe) == [bool(x) for x in np.asarray(j_diag.is_keyframe)]
    assert list(diag.escalated) == [bool(x) for x in np.asarray(j_diag.escalated)]
    assert float(np.abs(to_np(diag.pose_t) - np.asarray(j_diag.pose_t)).max()) < POSE_TOL
    for name in ("pose_q", "affine", "rmse", "flow", "flow_no_rot"):
        want = np.asarray(getattr(j_diag, name))
        assert_close(getattr(diag, name), want, rtol=RTOL,
                     atol=RTOL * max(float(np.abs(want).max()), 1e-12), err_msg=name)
    np.testing.assert_array_equal(to_np(diag.num_valid_align),
                                  np.asarray(j_diag.num_valid_align))
    want = jax_tick["j_states"]
    regular = [b for b in range(B) if not diag.is_keyframe[b]]
    for name in ("last_q", "last_t", "prev_q", "prev_t", "last_affine", "rmse_last0",
                 "kf_rmse"):
        rows = regular if name == "last_affine" else list(range(B))
        if not rows:
            continue
        w = np.asarray(want[name])[rows]
        assert_close(to_np(getattr(jax_tick["new"], name))[rows], w, rtol=RTOL,
                     atol=RTOL * max(float(np.abs(w).max()), 1e-12), err_msg=name)


def test_forced_keyframe_tick_matches_jax(jax_tick):
    """Every sequence forced to take a keyframe, the port's batched tick
    against JAX's from the same converted states (the port's backend from
    the JAX frontend's immature banks, as ``tests/test_torch_tracker.py``'s
    keyframe test runs it), within that file's keyframe tolerances:
    RTOL_SOLVE (1e-7 relative, of the largest entry absolute) on the solve's
    energy, the min distance, the window's eps and idepths and the ledger;
    n_active, n_activated, the count and frame_id equal."""
    j_diag, diag = jax_tick["j_forced_diag"], jax_tick["forced_diag"]
    assert diag.is_keyframe == (True,) * B
    assert [bool(x) for x in np.asarray(j_diag.is_keyframe)] == [True] * B
    for b in range(B):
        got = diag.sequence(b)
        for name in ("energy", "min_distance"):
            want = np.asarray(getattr(j_diag, name))[b]
            assert_close(getattr(got, name), want, rtol=RTOL_SOLVE,
                         atol=RTOL_SOLVE * max(abs(float(want)), 1e-12), err_msg=f"{b} {name}")
        for name in ("n_active", "n_activated", "num_valid_solve"):
            assert int(getattr(got, name)) == int(np.asarray(getattr(j_diag, name))[b]), name
    want = convert.stacked_device_tracker_state(jax_tick["j_forced"]).window
    got = jax_tick["forced"].window
    for name in ("eps", "lm_idepth", "h_marg", "b_marg", "energy_marg"):
        w = to_np(getattr(want, name))
        assert_close(getattr(got, name), w, rtol=RTOL_SOLVE,
                     atol=RTOL_SOLVE * max(float(np.abs(w).max()), 1e-12), err_msg=name)
    np.testing.assert_array_equal(to_np(got.frame_id), to_np(want.frame_id))
    assert float(np.abs(to_np(got.h_marg)).max()) > 0


@pytest.fixture(scope="module")
def stacked(seqs):
    """The B initialized trackers' states, solo and stacked, and the models."""
    pipes = [PipelinedTracker(_make_tracker(b)) for b in range(len(seqs))]
    states = [p.state for p in pipes]
    return dict(states=states, stacked=bl.stack_states(states), models=pipes[0].models,
                cfg=pipes[0].cfg, images=torch.stack([s.images[INIT_FRAMES] for s in seqs]))


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_huber_sigma_of_sequences_maps(batch):
    """K3's whole-point Huber sigma reads the channel axis of B sequences'
    [B, 3C, H, W] maps, not the sequence axis."""
    from dsopp_tpu_torch.solvers.pose_alignment import AlignmentOptions, huber_sigma

    opts = AlignmentOptions()
    for c in (1, 3):
        solo = torch.zeros((3 * c, 8, 8), dtype=F64)
        assert huber_sigma(solo.expand(batch, 3 * c, 8, 8), opts) == huber_sigma(solo, opts)


def test_pyramid_with_the_leading_axis(stacked):
    """K1's plain version on [B, H, W] against B solo calls, to the bit."""
    maps = build_pyramid_maps(stacked["images"], 4)
    for b in range(B):
        solo = build_pyramid_maps(stacked["images"][b], 4)
        for level, (m, s) in enumerate(zip(maps, solo)):
            assert m.shape[0] == B and torch.equal(m[b], s), level


def test_align_level_with_the_leading_axis(stacked):
    """K3's plain version on interleaved sequences' hypotheses against each
    sequence's own call, to the bit."""
    st, models, cfg = stacked["stacked"], stacked["models"], stacked["cfg"]
    maps = build_pyramid_maps(stacked["images"], 2)
    level = 1
    kf = SE3(st.window.poses().q[:, 1], st.window.poses().t[:, 1])
    hyps = _initialization_hypotheses(SE3(st.last_q, st.last_t), SE3(st.prev_q, st.prev_t),
                                      kf, False)
    t_init = hyps.inverse().compose(SE3(kf.q[:, None].expand(B, CHUNK, 4),
                                        kf.t[:, None].expand(B, CHUNK, 3)))
    order = [1, 0, 2, 1, 0, 2, 2, 1, 0, 0, 1, 2, 0, 1, 2]     # (sequence, hypothesis) pairs
    picks = [(s, order[:i].count(s)) for i, s in enumerate(order)]
    q = torch.stack([t_init.q[s, h] for s, h in picks])
    t = torch.stack([t_init.t[s, h] for s, h in picks])
    affine = torch.stack([st.last_affine[s] for s, _ in picks])
    ratio = torch.tensor([1.0, 1.1, 0.9], dtype=F64)
    res = align_level(st.level_points[level], maps[level], models[level], SE3(q, t), affine,
                      st.last_affine, ratio, cfg.align_opts,
                      seq=torch.tensor(order, dtype=torch.int32), per_seq=CHUNK)
    for b in range(B):
        idx = [i for i, s in enumerate(order) if s == b]
        solo = align_level_plain(LevelPoints(*(x[b] for x in st.level_points[level])),
                                 maps[level][b], models[level], SE3(q[idx], t[idx]),
                                 affine[idx], st.last_affine[b], ratio[b], cfg.align_opts)
        for name in ("affine", "energy", "num_valid", "rmse", "iterations"):
            assert torch.equal(getattr(res, name)[idx], getattr(solo, name)), name
        assert torch.equal(res.t_t_r.q[idx], solo.t_t_r.q)
        assert torch.equal(res.t_t_r.t[idx], solo.t_t_r.t)


def test_epipolar_and_flows_with_the_leading_axis(stacked):
    """K4's and K5's plain versions with the leading axis against B solo
    calls, to the bit; K5 with a forced keyframe among the sequences."""
    st, states, models = stacked["stacked"], stacked["states"], stacked["models"]
    maps = build_pyramid_maps(stacked["images"], 1)
    poses = st.window.poses()
    pose = SE3(st.last_q, st.last_t)
    exposure = torch.tensor([1.0, 0.9, 1.2], dtype=F64)
    out = estimate_depths(st.immature, maps[0], models[0], pose.q, pose.t, poses.q, poses.t,
                          st.window.affine(), st.last_affine, exposure, st.window.exposure)
    t_t_kf = SE3(poses.q[:, 1], poses.t[:, 1]).inverse() @ pose
    mat = t_t_kf.inverse().matrix()
    rmse = torch.tensor([3.0, 50.0, 4.0], dtype=F64)
    num_valid = torch.tensor([200, 0, 300], dtype=torch.int32)
    force = (False, False, True)
    stats = frame_statistics(st.flow_points, models[0], t_t_kf, mat, rmse, num_valid,
                             st.rmse_last0, torch.tensor([2.0, -1.0, 0.5], dtype=F64), 3.0,
                             force)
    assert stats.shape == (B, 23)
    for b, state in enumerate(states):
        sp = state.window.poses()
        solo = estimate_depths(state.immature, maps[0][b], models[0], pose.q[b], pose.t[b],
                               sp.q, sp.t, state.window.affine(), state.last_affine,
                               exposure[b], state.window.exposure)
        for name in solo._fields:
            assert torch.equal(getattr(out, name)[b], getattr(solo, name)), name
        solo_stats = frame_statistics(state.flow_points, models[0],
                                      SE3(t_t_kf.q[b], t_t_kf.t[b]), mat[b], rmse[b],
                                      num_valid[b], state.rmse_last0,
                                      torch.tensor([2.0, -1.0, 0.5], dtype=F64)[b], 3.0,
                                      force[b])
        assert torch.equal(stats[b], solo_stats), b
