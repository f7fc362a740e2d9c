"""Port parity of the whole slice: the known-pose bootstrap, one
``device_tick`` from the same state, and a full tracked run, against the
JAX package (both f64 on the CPU) at the size of
``tests/tracker/test_device_loop.py`` with the perturbation re-track armed.

(a) the bootstrap, frame by frame from the same converted JAX state, and
    the state after ``initialize``: ints/bools exact, floats 1e-9 relative
    (1e-7 after a BA solve);
(b) one ``device_tick`` (a keyframe and a regular frame) from the same
    converted JAX state: the same TickDiag and state, same tolerances;
(c) the free-running run: the same keyframe ids, and per-frame translation
    error against GT within 25 % of the JAX run's.

(d) the fast-motion corridor (advance 0.13, texture seed 11): the port's
    frontend from the JAX state before every tick — rmse, the re-track
    ledger ``rmse_last0``, the escalation flag, the keyframe decision and both
    flow statistics, 1e-9 relative and flags exact.

(e) one frontend tick at ``pyramid_levels=1`` (no coarse ranking) from the
    same converted JAX state, with the re-track gate open and closed, 1e-9.

(f) marked ``slow``: the fast corridor at VGA in f32, the JAX package free
    on the CPU and the port's frontend from its state before every tick: the
    same escalation decisions (the re-track gate's record).

Zero-parallax immature points are exempt from the bank comparisons: their
triangulated inverse depth is rounding noise around 0 (±1e-16; the two
packages round differently), and its sign decides OOB vs SKIPPED and
activation readiness.  Free-running, one such flip changes the BA by
~1e-5 and the runs drift apart by up to ~1e-2 m at this size, so (c) holds
the port to the ground truth rather than to the JAX poses.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.tracker import device_loop as jdl
from dsopp_tpu.tracker.monocular import MonocularTracker as JTracker
from dsopp_tpu.tracker.monocular import TrackerConfig as JConfig
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.tracker import device_loop as tdl
from dsopp_tpu_torch.tracker.fused_tick import ENERGY_RATIO_THRESHOLD
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests._torch_port import assert_close, assert_equal, state_fields, to_np, window_fields

NUM_FRAMES = 18
INIT_FRAMES = 6
H, W = 120, 160
CFG = dict(num_frame_slots=7, landmarks_per_frame=128, immature_per_frame=256,
           desired_points=600, frontend_points=800, keyframe_factor=3.0,
           window_min=3, window_max=5, use_rotation_perturbations=True)
SNAPSHOT_TICKS = (INIT_FRAMES, INIT_FRAMES + 1)
RTOL = 1e-9          # no BA solve in between
RTOL_SOLVE = 1e-7    # across a windowed BA solve
DEGENERATE_IDEPTH = 1e-10


def _copy(fields):
    """Deep numpy copy: the JAX loop donates its state buffers."""
    if isinstance(fields, dict):
        return {k: _copy(v) for k, v in fields.items()}
    if isinstance(fields, (list, tuple)):
        return type(fields)(_copy(v) for v in fields)
    return np.array(fields)


def _jax_tracker_fields(jt):
    """The host JAX tracker's state in ``state_fields`` form."""
    return _copy(dict(
        window=window_fields(jt.window), immature=jt.immature._asdict(),
        depth_idepth=list(jt.depth_maps[0]), depth_weight=list(jt.depth_maps[1]),
        level_points=[tuple(p) for p in jt.level_points], flow_points=tuple(jt.flow_points),
        last_q=jt.t_w_last.q, last_t=jt.t_w_last.t, prev_q=jt.t_prev_rel.q,
        prev_t=jt.t_prev_rel.t, last_affine=jt.last_affine, rmse_last0=jt.rmse_last[0],
        kf_rmse=jt.keyframe_strategy._rmse,
        min_distance=jt.activator.min_distance_to_neighbor))


def _jax_state(fields):
    """``state_fields`` numpy dict → a JAX ``DeviceTrackerState``."""
    from dsopp_tpu.solvers.pba import Window as JWindow
    from dsopp_tpu.solvers.pose_alignment import LevelPoints as JLevelPoints
    from dsopp_tpu.tracker.depth_estimation import ImmaturePoints as JImmature

    arr = jnp.asarray
    return jdl.DeviceTrackerState(
        window=JWindow(**{k: arr(v) for k, v in fields["window"].items()}),
        immature=JImmature(**{k: arr(v) for k, v in fields["immature"].items()}),
        depth_idepth=tuple(arr(x) for x in fields["depth_idepth"]),
        depth_weight=tuple(arr(x) for x in fields["depth_weight"]),
        level_points=tuple(JLevelPoints(*map(arr, p)) for p in fields["level_points"]),
        flow_points=JLevelPoints(*map(arr, fields["flow_points"])),
        **{k: arr(fields[k]) for k in ("last_q", "last_t", "prev_q", "prev_t", "last_affine",
                                       "rmse_last0", "kf_rmse", "min_distance")})


def _port_tracker_state(tt):
    d = dict(dtype=tt.dtype)
    return tdl.DeviceTrackerState(
        window=tt.window, immature=tt.immature, depth_idepth=tuple(tt.depth_maps[0]),
        depth_weight=tuple(tt.depth_maps[1]), level_points=tuple(tt.level_points),
        flow_points=tt.flow_points, last_q=tt.t_w_last.q, last_t=tt.t_w_last.t,
        prev_q=tt.t_prev_rel.q, prev_t=tt.t_prev_rel.t, last_affine=tt.last_affine,
        rmse_last0=torch.tensor(tt.rmse_last[0], **d), kf_rmse=torch.tensor(tt.kf_rmse, **d),
        min_distance=torch.tensor(tt.min_distance, **d))


def _force(tt, fields, jt):
    """Set the port tracker's state to the converted JAX tracker's."""
    st = convert.device_tracker_state(fields)
    tt.window, tt.immature = st.window, st.immature
    tt.depth_maps = (st.depth_idepth, st.depth_weight)
    tt.level_points, tt.flow_points = list(st.level_points), st.flow_points
    tt.t_w_last, tt.t_prev_rel = SE3(st.last_q, st.last_t), SE3(st.prev_q, st.prev_t)
    tt.last_affine = st.last_affine
    tt.kf_rmse, tt.min_distance = float(st.kf_rmse), float(st.min_distance)
    tt.num_keyframes, tt.kf_id = jt.num_keyframes, jt._kf_id()


@pytest.fixture(scope="module")
def runs():
    seq = render_sequence(num_frames=NUM_FRAMES, height=H, width=W)
    cam = convert.pinhole(seq.camera.fx, seq.camera.fy, seq.camera.cx, seq.camera.cy,
                          seq.camera.image_size)
    jposes = [JSE3(jnp.asarray(seq.pose_t_wc(i).q), jnp.asarray(seq.pose_t_wc(i).t))
              for i in range(INIT_FRAMES)]
    # (a) bootstrap: JAX frame by frame, the port from the JAX state before each
    jt = JTracker(seq.camera, JConfig(**CFG), dtype=jnp.float64)
    forced = MonocularTracker(cam, TrackerConfig(**CFG), dtype=torch.float64, device="cpu")
    boot = []
    for i in range(INIT_FRAMES):
        last = i == INIT_FRAMES - 1
        if i > 0:
            _force(forced, _jax_tracker_fields(jt), jt)
        out = jt.tick(i, 0.0, seq.images[i], known_pose=jposes[i], force_keyframe=last)
        forced.tick(i, 0.0, seq.images[i], known_pose=convert.se3(jposes[i].q, jposes[i].t),
                    force_keyframe=last)
        boot.append((bool(out["keyframe"]), _port_tracker_state(forced),
                     _jax_tracker_fields(jt), forced.num_keyframes == jt.num_keyframes))

    jpipe = jdl.PipelinedTracker(jt, flush_every=1000)
    j_init = _copy(state_fields(jpipe.state))
    snaps, j_diags = {}, []
    for i in range(INIT_FRAMES, NUM_FRAMES):
        if i in SNAPSHOT_TICKS:
            before = _copy(state_fields(jpipe.state))
            j_base, j_need, _ = jdl._frontend_core(
                _jax_state(before), jnp.asarray(seq.images[i]), jnp.asarray(False),
                jpipe.models, jpipe.cfg, jnp.asarray(1.0))
            j_base = _copy(state_fields(j_base))
        jpipe.tick(i, float(seq.timestamps[i]), seq.images[i])
        j_diags.append(_copy(jpipe.pending[-1][2]._asdict()))
        if i in SNAPSHOT_TICKS:
            snaps[i] = (before, j_base, bool(j_need), j_diags[-1],
                        _copy(state_fields(jpipe.state)))
    jpipe.finalize()

    # (c) the port free-running from its own bootstrap
    tt = MonocularTracker(cam, TrackerConfig(**CFG), dtype=torch.float64, device="cpu")
    tt.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                    convert.se3(jposes[i].q, jposes[i].t)) for i in range(INIT_FRAMES)])
    tpipe = tdl.PipelinedTracker(tt, flush_every=4)
    t_init = tpipe.state
    t_diags = [tpipe.tick(i, float(seq.timestamps[i]), seq.images[i])
               for i in range(INIT_FRAMES, NUM_FRAMES)]
    tpipe.finalize()
    return dict(seq=seq, jt=jt, jpipe=jpipe, boot=boot, j_init=j_init, snaps=snaps,
                j_diags=j_diags, tt=tt, t_init=t_init, t_diags=t_diags)


def _close(a, b, name, rtol, mask=None):
    a, b = to_np(a), np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    if b.dtype == np.bool_ or np.issubdtype(b.dtype, np.integer):
        assert_equal(a, b, err_msg=name)
    else:
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        assert_close(a, b, rtol=rtol, atol=rtol * max(scale, 1e-12), err_msg=name)


def _compare_state(port, ref, rtol):
    """port: DeviceTrackerState; ref: ``state_fields`` dict of the JAX state."""
    exp = convert.device_tracker_state(ref)
    for name in ("t_lin_q", "t_lin_t", "affine0", "eps", "exposure", "frame_valid",
                 "frame_fixed", "frame_id", "lm_uv", "lm_patch", "lm_idepth", "lm_valid",
                 "lm_outlier", "lm_inliers", "lm_opt_count", "lm_baseline", "res_status",
                 "h_marg", "b_marg", "energy_marg", "maps"):
        _close(getattr(port.window, name), getattr(exp.window, name), f"window.{name}", rtol)
    # zero-parallax points: idepth within 1e-10 of 0 in either package and
    # some field differing
    pi, ei = port.immature, exp.immature
    near_zero = np.zeros(to_np(ei.valid).shape, bool)
    differs = np.zeros_like(near_zero)
    for name in ("idepth_min", "idepth_max"):
        a, b = to_np(getattr(pi, name)), to_np(getattr(ei, name))
        near_zero |= (np.abs(a) < DEGENERATE_IDEPTH) | (np.abs(b) < DEGENERATE_IDEPTH)
        differs |= ~np.isclose(a, b, rtol=rtol, atol=rtol)
    for name in ("status", "valid", "traced"):
        differs |= to_np(getattr(pi, name)) != to_np(getattr(ei, name))
    degenerate = near_zero & differs
    assert degenerate.sum() <= 0.02 * max(1, int(to_np(ei.valid).sum()))
    for name in port.immature._fields:
        _close(getattr(port.immature, name), getattr(exp.immature, name),
               f"immature.{name}", rtol, mask=~degenerate)
    for lvl, (a, b) in enumerate(zip(port.level_points, exp.level_points)):
        for name in a._fields:
            _close(getattr(a, name), getattr(b, name), f"level_points[{lvl}].{name}", rtol)
    for name in port.flow_points._fields:
        _close(getattr(port.flow_points, name), getattr(exp.flow_points, name),
               f"flow_points.{name}", rtol)
    for lvl in range(len(port.depth_idepth)):
        _close(port.depth_idepth[lvl], exp.depth_idepth[lvl], f"depth_idepth[{lvl}]", rtol)
        _close(port.depth_weight[lvl], exp.depth_weight[lvl], f"depth_weight[{lvl}]", rtol)
    for name in ("last_q", "last_t", "prev_q", "prev_t", "last_affine", "rmse_last0",
                 "kf_rmse", "min_distance"):
        _close(getattr(port, name), getattr(exp, name), name, rtol)


@pytest.mark.parametrize("frame", range(INIT_FRAMES))
def test_bootstrap_frame_matches(runs, frame):
    is_kf, port_state, ref, same_count = runs["boot"][frame]
    assert same_count
    _compare_state(port_state, ref, RTOL_SOLVE if is_kf and frame > 0 else RTOL)


def test_bootstrap_state_matches(runs):
    """The free-running port bootstrap reaches the JAX state (2 keyframes,
    the same slots, landmarks and frontend points)."""
    port, exp = runs["t_init"], convert.device_tracker_state(runs["j_init"])
    assert runs["tt"].num_keyframes >= 2
    for name in ("frame_valid", "frame_id", "frame_fixed"):
        _close(getattr(port.window, name), getattr(exp.window, name), name, 0.0)
    _compare_state(runs["boot"][-1][1], runs["j_init"], RTOL_SOLVE)
    n_port = int(port.window.lm_valid.sum())
    n_ref = int(exp.window.lm_valid.sum())
    assert abs(n_port - n_ref) <= 0.02 * n_ref


@pytest.mark.parametrize("tick", SNAPSHOT_TICKS)
def test_one_device_tick_matches(runs, tick):
    """Frontend from the JAX state, then the backend from the JAX frontend's
    state (so the zero-parallax sign noise of this tick's epipolar update
    cannot change which points the backend activates)."""
    before, j_base, j_need, j_diag, after = runs["snaps"][tick]
    seq, tt = runs["seq"], runs["tt"]
    models, cfg = tuple(tt.models), tt.loop_config()
    exposure = torch.tensor(1.0, dtype=torch.float64)
    base, need, front = tdl._frontend_core(convert.device_tracker_state(before),
                                           torch.as_tensor(seq.images[tick]), False,
                                           models, cfg, exposure)
    assert need == j_need == bool(j_diag["is_keyframe"])
    assert front.escalated == bool(j_diag["escalated"])
    _compare_state(base, j_base, RTOL)
    state, diag = tdl._backend_core(convert.device_tracker_state(j_base), front, need, tick,
                                    models, cfg, exposure)
    rtol = RTOL_SOLVE if need else RTOL
    for name in ("pose_q", "pose_t", "affine", "rmse", "flow", "flow_no_rot",
                 "num_valid_align", "t_kf_frame_mat", "energy", "num_valid_solve",
                 "n_active", "n_activated", "min_distance", "frame_flags", "kf_frame_id",
                 "kf_affine", "lm_valid", "lm_outlier"):
        _close(getattr(diag, name), j_diag[name], f"diag.{name}", rtol)
    _compare_state(state, after, rtol)


def test_run_keyframes_and_accuracy_match(runs):
    j_kf = [bool(d["is_keyframe"]) for d in runs["j_diags"]]
    t_kf = [d.is_keyframe for d in runs["t_diags"]]
    assert t_kf == j_kf
    assert sum(t_kf) >= 2
    assert (sorted(runs["tt"].track.keyframe_timestamps)
            == sorted(runs["jt"].track.keyframe_timestamps))
    gt = runs["seq"]
    gt_t = np.stack([np.asarray(gt.pose_t_wc(i).t) for i in range(INIT_FRAMES, NUM_FRAMES)])
    e_j = np.linalg.norm(np.stack([d["pose_t"] for d in runs["j_diags"]]) - gt_t, axis=1)
    e_t = np.linalg.norm(np.stack([to_np(d.pose_t) for d in runs["t_diags"]]) - gt_t, axis=1)
    rmse_j, rmse_t = np.sqrt(np.mean(e_j ** 2)), np.sqrt(np.mean(e_t ** 2))
    assert rmse_t <= 1.25 * rmse_j, (rmse_t, rmse_j)
    assert e_t.max() <= 1.25 * e_j.max(), (e_t.max(), e_j.max())


def test_escalation_matches(runs):
    """A frame whose first hypothesis chunk fails the 2.5× gate runs all 22
    chunks (JAX: one by one; the port: chunks 1..21 batched) and keeps the
    best per-point energy, the earliest chunk on ties."""
    before = dict(runs["snaps"][SNAPSHOT_TICKS[1]][0])
    before["rmse_last0"] = np.asarray(1e-3)           # gate 2.5e-3: chunk 0 fails
    seq, tt = runs["seq"], runs["tt"]
    tick = SNAPSHOT_TICKS[1]
    j_base, _, j_front = jdl._frontend_core(
        _jax_state(before), jnp.asarray(seq.images[tick]), jnp.asarray(False),
        runs["jpipe"].models, runs["jpipe"].cfg, jnp.asarray(1.0))
    _, _, front = tdl._frontend_core(convert.device_tracker_state(before),
                                     torch.as_tensor(seq.images[tick]), False,
                                     tuple(tt.models), tt.loop_config(),
                                     torch.tensor(1.0, dtype=torch.float64))
    assert bool(j_front.escalated) and front.escalated
    for name in ("pose_q", "pose_t", "affine", "rmse", "num_valid"):
        _close(getattr(front, name), np.asarray(getattr(j_front, name)), name, RTOL)
    # the gate tested chunk 0's rmse: the JAX frontend's without the re-track
    _, _, j_chunk0 = jdl._frontend_core(
        _jax_state(before), jnp.asarray(seq.images[tick]), jnp.asarray(False),
        runs["jpipe"].models, runs["jpipe"].cfg._replace(with_perturbations=False),
        jnp.asarray(1.0))
    _close(front.rmse_chunk0, np.asarray(j_chunk0.rmse), "rmse_chunk0", RTOL)
    assert float(front.rmse_chunk0) >= 2.5e-3
    _, diag = tdl._backend_core(convert.device_tracker_state(before), front, False, tick,
                                tuple(tt.models), tt.loop_config(),
                                torch.tensor(1.0, dtype=torch.float64))
    assert diag.rmse_chunk0 is front.rmse_chunk0


FAST_FRAMES = 18
# ticks of the fast corridor that are also run with the re-track gate closed
FAST_CLOSED_TICKS = (INIT_FRAMES + 1, FAST_FRAMES - 1)


@pytest.fixture(scope="module")
def fast_runs():
    """The JAX tracker over the fast corridor, and the port's frontend from
    the JAX state before each tick → (per tick: the JAX diagnostics and the
    port's frontend; per tick of ``FAST_CLOSED_TICKS``: both frontends from
    that state with the re-track gate closed, so that both escalate)."""
    seq = render_sequence(num_frames=FAST_FRAMES, height=H, width=W, advance=0.13, seed=11)
    cam = convert.pinhole(seq.camera.fx, seq.camera.fy, seq.camera.cx, seq.camera.cy,
                          seq.camera.image_size)
    jt = JTracker(seq.camera, JConfig(**CFG), dtype=jnp.float64)
    jt.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                    JSE3(jnp.asarray(seq.pose_t_wc(i).q), jnp.asarray(seq.pose_t_wc(i).t)))
                   for i in range(INIT_FRAMES)])
    jpipe = jdl.PipelinedTracker(jt, flush_every=1000)
    port = MonocularTracker(cam, TrackerConfig(**CFG), dtype=torch.float64, device="cpu")
    models, cfg = tuple(port.models), port.loop_config()
    exposure = torch.tensor(1.0, dtype=torch.float64)
    ticks, closed = {}, {}
    for i in range(INIT_FRAMES, FAST_FRAMES):
        before = _copy(state_fields(jpipe.state))
        if i in FAST_CLOSED_TICKS:
            shut = dict(before, rmse_last0=np.asarray(1e-3))    # gate 2.5e-3: chunk 0 fails
            _, _, j_front = jdl._frontend_core(
                _jax_state(shut), jnp.asarray(seq.images[i]), jnp.asarray(False),
                jpipe.models, jpipe.cfg, jnp.asarray(1.0))
            _, _, front = tdl._frontend_core(convert.device_tracker_state(shut),
                                             torch.as_tensor(seq.images[i]), False,
                                             models, cfg, exposure)
            closed[i] = ({name: np.array(getattr(j_front, name)) for name in
                          ("escalated", "pose_q", "pose_t", "affine", "rmse", "num_valid")},
                         front)
        jpipe.tick(i, float(seq.timestamps[i]), seq.images[i])
        j_diag = _copy(jpipe.pending[-1][2]._asdict())
        j_diag["rmse_last0"] = np.array(jpipe.state.rmse_last0)
        base, need, front = tdl._frontend_core(convert.device_tracker_state(before),
                                               torch.as_tensor(seq.images[i]), False,
                                               models, cfg, exposure)
        ticks[i] = (j_diag, dict(rmse=front.rmse, rmse_last0=base.rmse_last0,
                                 escalated=front.escalated, is_keyframe=need,
                                 flow=front.flow, flow_no_rot=front.flow_no_rot))
    jpipe.finalize()
    return ticks, closed


@pytest.mark.parametrize("tick", range(INIT_FRAMES, FAST_FRAMES))
def test_fast_corridor_frontend_matches(fast_runs, tick):
    """On these ticks, in f64, the port takes the JAX package's escalation and
    keyframe decisions from the JAX state, with its rmse, gate and flows."""
    j_diag, port = fast_runs[0][tick]
    assert port["escalated"] == bool(j_diag["escalated"])
    assert port["is_keyframe"] == bool(j_diag["is_keyframe"])
    for name in ("rmse", "rmse_last0", "flow", "flow_no_rot"):
        _close(port[name], j_diag[name], name, RTOL)


def test_fast_corridor_takes_keyframes(fast_runs):
    keyframes = sum(bool(j["is_keyframe"]) for j, _ in fast_runs[0].values())
    assert keyframes >= 2
    assert all(np.isfinite(float(j["rmse"])) for j, _ in fast_runs[0].values())


@pytest.mark.parametrize("tick", FAST_CLOSED_TICKS)
def test_fast_corridor_escalation_matches(fast_runs, tick):
    """Where the JAX frontend escalates on the fast corridor (the gate
    closed), the port escalates too and keeps the same hypothesis."""
    j_front, front = fast_runs[1][tick]
    assert bool(j_front["escalated"]) and front.escalated
    for name in ("pose_q", "pose_t", "affine", "rmse", "num_valid"):
        _close(getattr(front, name), j_front[name], name, RTOL)


def test_card_paths_match_the_bench():
    """``testing/paths.py`` (what chip_smoke.py and profile_track drive on the
    card) holds the two operating points and the two sequences of
    ``bench.py``, read from its source: importing it would configure JAX."""
    import ast
    import pathlib

    from dsopp_tpu_torch.testing import paths

    tree = ast.parse((pathlib.Path(__file__).parents[1] / "bench.py").read_text())
    consts = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and isinstance(node.value, ast.Constant):
            consts[target.id] = node.value.value
        elif isinstance(target, ast.Tuple):
            consts.update(zip((t.id for t in target.elts), ast.literal_eval(node.value)))
    for name in ("standart_config", "dense_config"):
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
        call = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Return))
        bench_cfg = {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}
        cfg = getattr(paths, name)()
        assert {field: getattr(cfg, field) for field in bench_cfg} == bench_cfg
        assert cfg == dataclasses.replace(TrackerConfig(), **bench_cfg)
        jax_cfg, port_cfg = dataclasses.asdict(JConfig(**bench_cfg)), dataclasses.asdict(cfg)
        assert {field: jax_cfg[field] for field in port_cfg} == port_cfg
    dense = paths.dense_config()
    assert (dense.num_frame_slots, dense.landmarks_per_frame, dense.window_max) == (17, 340, 15)
    assert {name: (seq, cfg.__name__) for name, (seq, cfg) in paths.PATHS.items()} == {
        "standart": ("standart", "standart_config"), "fast": ("fast", "standart_config"),
        "dense": ("standart", "dense_config"),       # bench.py runs dense on the 0.08 corridor
        # the masked path: the standart point on the first frames of the same corridor
        "masked": ("standart", "standart_config"),
        # the long-horizon ledger case of tests/tracker/test_ledger_drift_tracker.py
        "ledger": ("ledger", "ledger_config"),
        # the camera sensor path: the corridor read back from a camera's files
        "sensor": ("standart", "standart_config")}
    assert paths.path_frames("standart") == consts["NUM_FRAMES"]
    assert paths.INIT_FRAMES < paths.path_frames("masked") <= consts["NUM_FRAMES"]
    assert 0 < paths.MASK_FIRST_INVALID_ROW < paths.HEIGHT

    renders = [{kw.arg: kw.value for kw in n.keywords} for n in ast.walk(tree)
               if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "render_sequence"]
    specs = [{name: ast.literal_eval(kw[name]) for name in ("advance", "seed") if name in kw}
             for kw in renders]
    assert {"advance": 0.08} in specs and {"advance": 0.13, "seed": 11} in specs
    assert {k: v for k, v in paths.SEQUENCES["standart"].items() if k != "num_frames"} == \
        {"advance": 0.08, "seed": 7}        # 7: render_sequence's default seed
    assert {k: v for k, v in paths.SEQUENCES["fast"].items() if k != "num_frames"} == \
        {"advance": 0.13, "seed": 11}
    assert paths.SEQUENCES["standart"]["num_frames"] == consts["NUM_FRAMES"]
    assert (paths.HEIGHT, paths.WIDTH, paths.FOCAL) == (
        consts["HEIGHT"], consts["WIDTH"], consts["FOCAL"])
    assert paths.INIT_FRAMES == consts["INIT_FRAMES"]

    # the ledger path: the drift test's configuration, sequence and size
    from tests.tracker import test_ledger_drift_tracker as drift

    jax_cfg, port_cfg = dataclasses.asdict(drift.CFG), dataclasses.asdict(paths.ledger_config())
    assert {field: jax_cfg[field] for field in port_cfg} == port_cfg
    assert paths.SEQUENCES["ledger"] == dict(num_frames=drift.NUM_FRAMES, advance=0.07, seed=5)
    assert paths.SIZES["ledger"] == (drift.H, drift.W, 260.0)   # render_sequence's focal
    assert paths.INIT_FRAMES == drift.INIT_FRAMES


@pytest.fixture(scope="module")
def one_level():
    """The JAX tracker bootstrapped at ``pyramid_levels=1`` and its state
    before the first tracked frame."""
    cfg = dict(CFG, pyramid_levels=1)
    seq = render_sequence(num_frames=INIT_FRAMES + 1, height=H, width=W)
    jt = JTracker(seq.camera, JConfig(**cfg), dtype=jnp.float64)
    jt.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                    JSE3(jnp.asarray(seq.pose_t_wc(i).q), jnp.asarray(seq.pose_t_wc(i).t)))
                   for i in range(INIT_FRAMES)])
    jpipe = jdl.PipelinedTracker(jt, flush_every=1000)
    cam = convert.pinhole(seq.camera.fx, seq.camera.fy, seq.camera.cx, seq.camera.cy,
                          seq.camera.image_size)
    port = MonocularTracker(cam, TrackerConfig(**cfg), dtype=torch.float64, device="cpu")
    return seq, jpipe, _copy(state_fields(jpipe.state)), port


@pytest.mark.parametrize("gate", ["open", "closed"])
def test_one_level_tick_matches(one_level, gate):
    """With one pyramid level there is no coarse ranking: level 0 refines
    every hypothesis of a chunk and keeps the least energy per point among
    those with at least half the chunk's most valid points, as the JAX tick
    does.  The frontend from the same converted JAX state, with the re-track
    gate as the state has it and closed (all 22 chunks run); 1e-9 relative."""
    seq, jpipe, before, port = one_level
    if gate == "closed":
        before = dict(before, rmse_last0=np.asarray(1e-3))
    tick = INIT_FRAMES
    j_base, j_need, j_front = jdl._frontend_core(
        _jax_state(before), jnp.asarray(seq.images[tick]), jnp.asarray(False),
        jpipe.models, jpipe.cfg, jnp.asarray(1.0))
    base, need, front = tdl._frontend_core(convert.device_tracker_state(before),
                                           torch.as_tensor(seq.images[tick]), False,
                                           tuple(port.models), port.loop_config(),
                                           torch.tensor(1.0, dtype=torch.float64))
    assert len(front.maps) == 1
    assert need == bool(j_need)
    assert front.escalated == bool(j_front.escalated) == (gate == "closed")
    for name in ("pose_q", "pose_t", "affine", "rmse", "num_valid", "flow", "flow_no_rot"):
        _close(getattr(front, name), np.asarray(getattr(j_front, name)), name, RTOL)
    _compare_state(base, _copy(state_fields(j_base)), RTOL)


# the fast corridor at VGA, as bench.py and chip_smoke's fast path run it
FAST_VGA = dict(num_frames=96, height=480, width=640, focal=520.0, advance=0.13, seed=11)
GATE_TIE = 1e-3      # a chunk-0 rmse ratio within 0.1 % of the gate's 2.5 is a tie


@pytest.mark.slow
def test_fast_corridor_escalations_match_in_f32():
    """Which frames of the fast corridor escalate (frames 6..95 at VGA, the
    standart point, f32): the JAX package runs free on the CPU, and before
    every tick the port's plain f32 frontend starts from the JAX state.  Both
    take the same escalation decision on every tick, unless chunk 0's rmse
    ratio lies within ``GATE_TIE`` of the gate; the JAX run's own escalations
    are printed (the TPU's record is 13, BENCH_r05.json)."""
    from dsopp_tpu_torch.testing import paths

    f32 = jnp.float32
    fields = dataclasses.asdict(paths.standart_config())
    seq = render_sequence(**FAST_VGA)
    jt = JTracker(seq.camera, JConfig(**fields), dtype=f32)
    jt.initialize([(i, float(seq.timestamps[i]), jnp.asarray(seq.images[i], f32),
                    JSE3(jnp.asarray(seq.pose_t_wc(i).q, f32), jnp.asarray(seq.pose_t_wc(i).t, f32)))
                   for i in range(paths.INIT_FRAMES)])
    jpipe = jdl.PipelinedTracker(jt, flush_every=1000)
    cam = convert.pinhole(seq.camera.fx, seq.camera.fy, seq.camera.cx, seq.camera.cy,
                          seq.camera.image_size)
    port = MonocularTracker(cam, TrackerConfig(**fields), dtype=torch.float32, device="cpu")
    models, cfg = tuple(port.models), port.loop_config()
    exposure = torch.tensor(1.0, dtype=torch.float32)
    rows = []
    for i in range(paths.INIT_FRAMES, FAST_VGA["num_frames"]):
        before = _copy(state_fields(jpipe.state))
        image = jnp.asarray(seq.images[i], f32)
        jpipe.tick(i, float(seq.timestamps[i]), image)
        j_diag = jpipe.pending[-1][2]
        _, need, front = tdl._frontend_core(
            convert.device_tracker_state(before, dtype=torch.float32),
            torch.from_numpy(np.array(image)), False, models, cfg, exposure)
        ratio = float(front.rmse_chunk0) / float(before["rmse_last0"])
        rows.append((i, bool(j_diag.escalated), front.escalated, bool(j_diag.is_keyframe), need,
                     ratio))
    jpipe.finalize()
    j_esc = [i for i, je, *_ in rows if je]
    t_esc = [i for i, _, te, *_ in rows if te]
    kf_agree = sum(jk == tk for *_, jk, tk, _ in rows)
    print(f"fast corridor, f32: JAX escalates on {j_esc}, the port from JAX's state on {t_esc};"
          f" keyframe decisions agree on {kf_agree} of {len(rows)}; largest chunk-0 ratio"
          f" {max(r[-1] for r in rows[1:]):.4f}")
    for i, je, te, _, _, ratio in rows:
        assert je == te or abs(ratio / ENERGY_RATIO_THRESHOLD - 1.0) <= GATE_TIE, (i, je, te, ratio)
