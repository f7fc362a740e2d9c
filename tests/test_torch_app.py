"""The port's application against the JAX package's (f64 on the CPU):
config → camera → feature-based bootstrap → ``PipelinedTracker`` → the
saved track and the TUM trajectory.

* The app with FBS on a 240×320 corridor (14 ``.npy`` frames, a JSON config,
  no poses file), the port's and JAX's on the same files: the same frame
  count, FBS finishing within ±1 frame of JAX's, the bootstrap's
  similarity-aligned ATE < 0.02 m (the JAX gate of
  ``tests/fbs/test_initializer.py``), the trajectories' positions within
  ``APP_TRAJ_TOL`` of each other (at the monocular scale FBS fixes, the
  median depth of the first frame 2: twice the largest gap measured, which
  comes from the port's LK positions, within 0.01 px of cv2's) and both
  under the GT gate of ``tests/config/test_app_device_loop.py:126``
  (RMSE < 5e-2 m, here after the similarity alignment, the scale being
  FBS's); the observers told of every frame, of keyframes and of
  marginalizations, and finished once.
* The precalculated-poses route (a TUM poses file) equal to
  ``testing/paths.py::bootstrap``'s known-pose run on the same frames at the
  file's poses (window poses within 1e-12, idepths within 1e-9).
* ``main`` with a JSON config and ``--config.*`` overrides; the track and
  TUM files, ``track2trajectory`` giving the same rows; ``main`` with
  ``--track_bin_path`` (a track.bin both packages read with track.npz's
  keyframes, poses within 1e-12) and with ``--visualization`` (the live
  viewer's ``/state.json`` during the run); the flags not ported refused;
  ``load_config`` / ``apply_overrides`` without ``yaml``.
* The JAX package's checkpoint of its app's tracker loaded by the port's
  ``load_checkpoint``: the state within 1e-12 of ``convert``'s.
* The save / load / TUM round trip and the ATE, the sanity checker on
  ``tests/test_sanity_checker.py``'s cases, the observers, the agent and the
  synchronizers, each against the JAX package's (exact).

The file runs in ~2 min on one worker, most of it the module fixture's two
app runs, and of those the JAX app's compiles (~57 s).
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsopp_tpu.config import loader as jloader
from dsopp_tpu.output import ate as jate
from dsopp_tpu.output import storage as jstorage
from dsopp_tpu.output import tum as jtum
from dsopp_tpu import sanity_checker as jsanity
from dsopp_tpu.sensors import synchronizer as jsync
from dsopp_tpu_torch.config import loader as ploader
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.output import ate as pate
from dsopp_tpu_torch.output import observers as pobs
from dsopp_tpu_torch.output import storage as pstorage
from dsopp_tpu_torch.output import tum as ptum
from dsopp_tpu_torch import sanity_checker as psanity
from dsopp_tpu_torch.sensors import agent as pagent
from dsopp_tpu_torch.sensors import synchronizer as psync
from dsopp_tpu_torch.testing import paths
from dsopp_tpu_torch.testing.synthetic import render_sequence

from tests import _torch_port  # noqa: F401  (one torch thread a worker)
from tests.test_sanity_checker import _forward_drive, _pose

H, W, FBS_FRAMES, POSE_FRAMES = 240, 320, 14, 10
# m: the port's trajectory against JAX's on the same files; the largest gap
# of one position measured on this fixture is 1.487e-3 m (on its last frame)
APP_TRAJ_TOL = 3e-3
APP_GT_GATE = 5e-2       # m: tests/config/test_app_device_loop.py:126
FBS_GATE = 0.02          # m: tests/fbs/test_initializer.py:130
APP_POINT = dict(desired_points=600, window=(3, 3), factor=4.0)   # 5 keyframes, 2 folded


def _gt(seq, n):
    return [(float(seq.timestamps[i]), seq.pose(i).matrix().numpy()) for i in range(n)]


def _sim3_rmse(est, gt):
    return pate.absolute_trajectory_error(est, gt, align=True, with_scale=True)["rmse"]


class Recorder(pobs.TrackObserver):
    def __init__(self):
        self.frames, self.kfs, self.margs, self.finished, self.bootstrap_done = 0, 0, 0, 0, []

    def on_frame(self, frame, result):
        self.frames += 1
        if result.get("bootstrap") and result.get("keyframe"):
            self.bootstrap_done.append(frame.frame_id)

    def on_keyframe(self, frame_id, timestamp):
        self.kfs += 1

    def on_marginalize(self, kf):
        self.margs += 1

    def finish(self, tracker):
        self.finished += 1


@pytest.fixture(scope="module")
def fbs_runs(tmp_path_factory):
    """Both apps with FBS on the same files, f64 on the CPU."""
    folder = tmp_path_factory.mktemp("app_fbs")
    seq = render_sequence(num_frames=FBS_FRAMES, height=H, width=W, dtype=torch.float64,
                          device="cpu")
    path = paths.write_app_folder(seq, str(folder), paths.app_config(**APP_POINT))
    config = ploader.load_config(path)

    port = ploader.build_application(config, str(folder), torch.float64, "cpu")
    rec, fps = Recorder(), pobs.FpsMeter()
    n_port = port.run(observers=[rec, fps])
    port.finish()

    ref = jloader.build_application(jloader.load_config(path), str(folder), jnp.float64)
    ref_done = []
    n_ref = ref.run(on_frame=lambda f, r: ref_done.append(f.frame_id)
                    if r.get("bootstrap") and r.get("keyframe") else None)
    ref.finish()
    return dict(seq=seq, port=port, ref=ref, n_port=n_port, n_ref=n_ref, rec=rec, fps=fps,
                ref_done=ref_done)


def test_fbs_app_matches_jax(fbs_runs):
    r = fbs_runs
    seq, port, ref = r["seq"], r["port"], r["ref"]
    assert r["n_port"] == r["n_ref"] == FBS_FRAMES
    assert len(r["rec"].bootstrap_done) == 1 and len(r["ref_done"]) == 1
    assert abs(r["rec"].bootstrap_done[0] - r["ref_done"][0]) <= 1
    fbs_est = [(ts, mat) for _, ts, mat in port.fbs_initializer.poses]
    assert _sim3_rmse(fbs_est, _gt(seq, FBS_FRAMES)) < FBS_GATE
    traj = port.tracker.track.trajectory(port.tracker.window)
    traj_ref = ref.tracker.track.trajectory(ref.tracker.window)
    assert len(traj) == len(traj_ref) == FBS_FRAMES
    assert [ts for ts, _ in traj] == [ts for ts, _ in traj_ref]
    gaps = [float(np.abs(mat[:3, 3] - np.asarray(mat_ref)[:3, 3]).max())
            for (_, mat), (_, mat_ref) in zip(traj, traj_ref)]
    assert max(gaps) < APP_TRAJ_TOL, gaps
    for t in (traj, [(ts, np.asarray(m)) for ts, m in traj_ref]):
        assert _sim3_rmse(t, _gt(seq, FBS_FRAMES)) < APP_GT_GATE
    assert port.tracker.num_keyframes == ref.tracker.num_keyframes


def test_run_notifies_observers(fbs_runs):
    """tests/config/test_app_device_loop.py::test_run_notifies_observers on
    the port's FBS run: a notice a frame, keyframe events from the bootstrap
    and the loop's bookkeeping, one finish, the set detached afterwards."""
    rec, fps, app = fbs_runs["rec"], fbs_runs["fps"], fbs_runs["port"]
    assert rec.frames == fbs_runs["n_port"] and fps.frames == rec.frames and fps.fps > 0
    assert rec.kfs == app.tracker.num_keyframes >= 3
    assert rec.margs == len(app.tracker.track.marginalized) >= 1
    assert rec.finished == 1
    before = rec.kfs
    app.tracker.track.on_keyframe(1000, 10.0)
    assert rec.kfs == before


def test_saved_track_round_trip(fbs_runs, tmp_path):
    """The port's track.npz, read by the port's and the JAX package's
    ``load_track``: the keyframes of the track and the window and the
    attached frames give ``trajectory()``'s poses; the point clouds equal."""
    app = fbs_runs["port"]
    path = tmp_path / "track.npz"
    pstorage.save_track(str(path), app.tracker.track, app.tracker.window, {"fx": 260.0,
                                                                           "fy": 260.0,
                                                                           "cx": 159.5,
                                                                           "cy": 119.5})
    data, data_ref = pstorage.load_track(str(path)), jstorage.load_track(str(path))
    assert data["meta"] == data_ref["meta"]
    by_id = {kf["frame_id"]: kf["t_wc"] for kf in data["keyframes"]}
    rows = [(kf["timestamp"], kf["t_wc"]) for kf in data["keyframes"]] + [
        (a["timestamp"], by_id[a["keyframe_id"]] @ a["t_keyframe_frame"])
        for a in data["attached"]]
    rows.sort(key=lambda e: e[0])
    traj = app.tracker.track.trajectory(app.tracker.window)
    assert [t for t, _ in rows] == [t for t, _ in traj]
    for (_, a), (_, b) in zip(rows, traj):
        np.testing.assert_allclose(a, b, atol=1e-12)
    np.testing.assert_array_equal(pstorage.point_cloud(data), jstorage.point_cloud(data_ref))
    tum = tmp_path / "est.tum"
    ptum.export_tum(str(tum), traj)
    for (ta, ma), (tb, mb) in zip(ptum.load_tum(str(tum)), jtum.load_tum(str(tum))):
        assert ta == tb
        np.testing.assert_array_equal(ma, mb)


def test_jax_checkpoint_loads_into_the_port(fbs_runs, tmp_path):
    """The JAX package's ``save_checkpoint`` of its app's tracker, read by the
    port's ``load_checkpoint``: the window (the ledger's double-float pairs
    summed), the banks, the depth maps, the frontend's points, the scalars
    and the track history within 1e-12 of ``convert``'s of that tracker.  The
    flow points are held to the JAX package's rebuild from its depth maps
    (the loader's), since its ``PipelinedTracker.finalize`` writes no flow
    points back into the tracker."""
    from dsopp_tpu.features.pyramid import build_pyramid_maps as jpyramid
    from dsopp_tpu.output.checkpoint import save_checkpoint as jsave
    from dsopp_tpu.tracker import depth_map as jdm
    from dsopp_tpu_torch import convert
    from dsopp_tpu_torch.output.checkpoint import load_checkpoint

    ref, port = fbs_runs["ref"].tracker, fbs_runs["port"]
    path = str(tmp_path / "jax.npz")
    jsave(path, ref)
    got = load_checkpoint(path, port.camera.camera_model(), port.tracker.config,
                          dtype=torch.float64, device="cpu")
    fields = {f.name: np.asarray(getattr(ref.window, f.name))
              for f in dataclasses.fields(ref.window)}
    want = convert.window(fields)
    for name in want.__dataclass_fields__:
        a, b = getattr(got.window, name), getattr(want, name)
        if b is None:
            assert a is None, name
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12, msg=name)
    torch.testing.assert_close(tuple(got.immature),
                               tuple(convert.immature_points(
                                   {k: np.asarray(v) for k, v in ref.immature._asdict().items()})),
                               rtol=0, atol=1e-12, equal_nan=True)
    for mine, theirs in zip(got.depth_maps, ref.depth_maps):
        torch.testing.assert_close(mine, tuple(convert.tensor(x) for x in theirs), rtol=0,
                                   atol=1e-12)
    for mine, theirs in zip(got.level_points, ref.level_points):
        torch.testing.assert_close(tuple(mine), tuple(convert.level_points(*theirs)), rtol=0,
                                   atol=1e-12)
    newest = int(np.asarray(ref.window.frame_valid).sum()) - 1
    maps0 = jpyramid(ref.window.maps[newest][0], len(ref.depth_maps[0]))[0]
    flow = jdm.depth_map_level_points(ref.depth_maps[0][0], ref.depth_maps[1][0], maps0,
                                      jdm.FLOW_CAP)
    torch.testing.assert_close(tuple(got.flow_points), tuple(convert.level_points(*flow)),
                               rtol=0, atol=1e-12)
    for mine, theirs in ((got.t_w_last, ref.t_w_last), (got.t_prev_rel, ref.t_prev_rel)):
        torch.testing.assert_close(tuple(mine), tuple(convert.se3(theirs.q, theirs.t)), rtol=0,
                                   atol=1e-12)
    torch.testing.assert_close(got.last_affine, convert.tensor(ref.last_affine), rtol=0,
                               atol=1e-12)
    assert got.rmse_last == [float(v) for v in ref.rmse_last]
    assert got.kf_rmse == ref.keyframe_strategy._rmse
    assert got.min_distance == ref.activator.min_distance_to_neighbor
    assert (got.num_keyframes, got.kf_id) == (ref.num_keyframes, ref._kf_id())
    traj, traj_ref = got.track.trajectory(got.window), ref.track.trajectory(ref.window)
    assert len(got.track.marginalized) == len(ref.track.marginalized) >= 1
    assert [t for t, _ in traj] == [t for t, _ in traj_ref] and len(traj) == FBS_FRAMES
    for (_, a), (_, b) in zip(traj, traj_ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def poses_folder(tmp_path_factory):
    """A 128×160 corridor as ``.npy`` frames with its ground truth as a TUM
    poses file and a JSON config of the precalculated route."""
    folder = tmp_path_factory.mktemp("app_poses")
    seq = render_sequence(num_frames=POSE_FRAMES, height=128, width=160, focal=130.0,
                          advance=0.06, dtype=torch.float64, device="cpu")
    config = paths.app_config(desired_points=600, window=(3, 5), factor=3.0)
    config["initializer"] = {"type": "precalculated", "poses_file": "gt.tum",
                             "num_frames": paths.INIT_FRAMES}
    path = paths.write_app_folder(seq, str(folder), config)
    ptum.export_tum(str(folder / "gt.tum"), _gt(seq, POSE_FRAMES))
    return folder, path, seq, config


def test_precalculated_route_equals_known_pose_bootstrap(poses_folder):
    """The app's first INIT_FRAMES frames at the poses file's poses give the
    tracker ``paths.bootstrap`` gives on the same (u8) frames at the same
    poses (the file's, to its 9 decimals)."""
    import dataclasses

    folder, path, seq, config = poses_folder
    app = ploader.build_application(ploader.load_config(path), str(folder), torch.float64,
                                    "cpu")
    assert app.run(max_frames=paths.INIT_FRAMES) == paths.INIT_FRAMES
    # the same frames at the poses as the file holds them (9 decimals)
    poses = [SE3.from_matrix(torch.as_tensor(m)) for _, m in ptum.load_tum(str(folder / "gt.tum"))]
    same = dataclasses.replace(seq, images=torch.round(torch.clamp(seq.images, 0, 255)),
                               poses_q=np.stack([p.q.numpy() for p in poses]),
                               poses_t=np.stack([p.t.numpy() for p in poses]))
    ref = paths.bootstrap(same, ploader.build_tracker_config(config["tracker"]),
                          dtype=torch.float64, device="cpu")
    assert app.tracker.num_keyframes == ref.num_keyframes >= 2
    a, b = app.tracker.window, ref.window
    torch.testing.assert_close(a.poses().matrix(), b.poses().matrix(), rtol=0, atol=1e-12)
    assert torch.equal(a.frame_valid, b.frame_valid) and torch.equal(a.lm_valid, b.lm_valid)
    torch.testing.assert_close(a.lm_idepth, b.lm_idepth, rtol=0, atol=1e-9)
    torch.testing.assert_close(app.tracker.immature.idepth_min, ref.immature.idepth_min,
                               rtol=0, atol=1e-9, equal_nan=True)


def test_main_with_json_config_and_overrides(poses_folder, tmp_path, monkeypatch):
    from dsopp_tpu_torch.app import main as app_main
    from dsopp_tpu_torch.app import track2trajectory

    folder, path, _, _ = poses_folder
    built = []
    build = ploader.build_application
    monkeypatch.setattr(ploader, "build_application",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    out, tum, tum2 = tmp_path / "track.npz", tmp_path / "est.tum", tmp_path / "t2t.tum"
    assert app_main.main(["--config_file_path", path, "--output_file_path", str(out),
                          "--trajectory_file_path", str(tum), "--device", "cpu", "--float64",
                          "--config.tracker.keyframe_strategy.factor=2.5",
                          "--config.tracker.number_of_desired_points=500"]) == 0
    cfg = built[0].tracker.config
    assert cfg.keyframe_factor == 2.5 and cfg.desired_points == 500
    assert built[0].tracker.dtype == torch.float64
    assert track2trajectory.main([str(out), str(tum2)]) == 0
    rows, rows2 = tum.read_text().splitlines(), tum2.read_text().splitlines()
    assert len(rows) == POSE_FRAMES and rows == rows2
    assert len(jstorage.load_track(str(out))["keyframes"]) == built[0].tracker.num_keyframes


@pytest.mark.parametrize("flag", [["--host-loop"], ["--platform", "cpu"]])
def test_main_refuses_flags_not_ported(flag, capsys):
    from dsopp_tpu_torch.app import main as app_main

    with pytest.raises(SystemExit) as exc:
        app_main.main(["--config_file_path", "mono.json"] + flag)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("not supported by the port" in err) == (flag[0] != "--platform")


@pytest.mark.parametrize("flag", ["--track_bin_path", "--visualization"])
def test_main_with_output_flag(poses_folder, tmp_path, monkeypatch, capsys, flag):
    """``main`` with ``--track_bin_path``: a track.bin that both packages'
    ``load_track_bin`` read with track.npz's keyframes, their poses within
    1e-12; with ``--visualization --visualization_port 0``: the live viewer
    serves ``/state.json`` while the run finishes (fetched from its
    ``finish``), with every frame and keyframe, and is closed after the run."""
    import urllib.request

    from dsopp_tpu.output import protobuf_track as jpb
    from dsopp_tpu_torch.app import main as app_main
    from dsopp_tpu_torch.output import live_viewer
    from dsopp_tpu_torch.output import protobuf_track as ppb

    folder, path, _, _ = poses_folder
    out, tbin = tmp_path / "track.npz", tmp_path / "track.bin"
    extra = (["--track_bin_path", str(tbin)] if flag == "--track_bin_path"
             else ["--visualization", "--visualization_port", "0"])
    states, viewers = [], []
    finish = live_viewer.LiveViewer.finish

    def finish_and_fetch(self, tracker):
        finish(self, tracker)
        viewers.append(self)
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/state.json",
                                    timeout=10) as r:
            states.append(json.loads(r.read()))

    monkeypatch.setattr(live_viewer.LiveViewer, "finish", finish_and_fetch)
    assert app_main.main(["--config_file_path", path, "--output_file_path", str(out),
                          "--device", "cpu", "--float64"] + extra) == 0
    saved = jstorage.load_track(str(out))["keyframes"]
    assert len(saved) >= 3
    if flag == "--track_bin_path":
        assert not states
        for data in (ppb.load_track_bin(str(tbin)), jpb.load_track_bin(str(tbin))):
            kfs = data["keyframes"]
            assert [kf["frame_id"] for kf in kfs] == [kf["frame_id"] for kf in saved]
            assert [kf["keyframe_id"] for kf in kfs] == list(range(len(saved)))
            for kf, ref in zip(kfs, saved):
                np.testing.assert_allclose(kf["t_world_agent"], ref["t_wc"], rtol=0, atol=1e-12)
                assert len(kf["landmarks"][0]["points"]) == int(ref["lm_valid"].sum())
    else:
        assert not tbin.exists() and len(states) == 1
        assert f"live viewer: http://localhost:{viewers[0].port}/" in capsys.readouterr().out
        assert states[0]["frame_id"] == POSE_FRAMES - 1
        assert states[0]["num_keyframes"] == len(saved)
        assert len(states[0]["frusta"]) == len(saved)
        with pytest.raises(OSError):     # closed after the run
            urllib.request.urlopen(f"http://127.0.0.1:{viewers[0].port}/state.json",
                                   timeout=2)


def test_config_without_yaml(tmp_path, monkeypatch):
    """A JSON config and its overrides with ``yaml`` absent: the tree the
    JAX loader reads from the same file (yaml), the overrides as JSON
    scalars or strings."""
    config = paths.app_config()
    path = tmp_path / "mono.json"
    path.write_text(json.dumps(config))
    monkeypatch.setattr(ploader, "_yaml", lambda: None)
    tree = ploader.load_config(str(path))
    assert tree == jloader.load_config(str(path)) == config
    tree = ploader.apply_overrides(tree, ["--config.tracker.keyframe_strategy.factor=2.5",
                                          "--config.device_loop=true",
                                          "--config.tracker.type=monocular",
                                          "--config.sensors.0.provider.start_frame=1"])
    assert tree["tracker"]["keyframe_strategy"]["factor"] == 2.5
    assert tree["device_loop"] is True and tree["tracker"]["type"] == "monocular"
    assert tree["sensors"][0]["provider"]["start_frame"] == 1


def _trajectory(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        m = np.eye(4)
        m[:3, :3] = jtum._quat_to_matrix(*q)
        m[:3, 3] = rng.normal(0, 2, 3)
        out.append((0.1 * i, m))
    return out


@pytest.mark.parametrize("align,scale", [(False, False), (True, False), (True, True)])
def test_tum_and_ate_match_jax(tmp_path, align, scale):
    gt, est = _trajectory(30, 1), _trajectory(30, 2)
    path = tmp_path / "t.tum"
    ptum.export_tum(str(path), est)
    text = path.read_text()
    jtum.export_tum(str(path), est)
    assert path.read_text() == text
    loaded = ptum.load_tum(str(path))
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(loaded, jtum.load_tum(str(path))))
    assert (pate.absolute_trajectory_error(loaded, gt, align=align, with_scale=scale)
            == jate.absolute_trajectory_error(loaded, gt, align=align, with_scale=scale))


SANITY_CASES = {
    "sane": (dict(), _forward_drive(10, yaw_rate=math.radians(10)), None),
    "gravity_angle": (dict(), _forward_drive(3) + [(3, 3.0, _pose(roll=math.radians(60),
                                                                t=(0, 0, 3)))],
                      "EXCEEDED_GRAVITY_ANGLE"),
    "gravity_rate": (dict(max_gravity_angle=math.radians(45),
                          max_gravity_angular_velocity=math.radians(20)),
                     _forward_drive(3) + [(3, 3.0, _pose(roll=math.radians(40), t=(0, 0, 3)))],
                     "EXCEEDED_GRAVITY_ANGULAR_VELOCITY"),
    "rotation_angle": (dict(), _forward_drive(3) + [(3, 3.0, _pose(yaw=math.radians(90),
                                                                 t=(0, 0, 3)))],
                       "EXCEEDED_ROTATION_ANGLE"),
    "rotation_rate": (dict(max_rotation_angle=math.radians(40),
                           max_rotation_angular_velocity=math.radians(30)),
                      _forward_drive(3) + [(3, 2.5, _pose(yaw=math.radians(35), t=(0, 0, 3)))],
                      "EXCEEDED_ROTATION_ANGULAR_VELOCITY"),
    "translation": (dict(), _forward_drive(3) + [(3, 3.0, _pose(t=(5.0, 0, 2.0)))],
                    "EXCEEDED_TRANSLATION_ERROR"),
    "reverse": (dict(), [(i, float(i), _pose(t=(0, 0, -i))) for i in range(5)], None),
    "tilted_mount": (dict(), [(i, float(i), _pose(pitch=math.radians(20), t=(0, 0, i)))
                              for i in range(5)], None),
    "incremental": (dict(), _forward_drive(10), None),
}


@pytest.mark.parametrize("case", list(SANITY_CASES))
def test_sanity_checker_matches_jax(case):
    """tests/test_sanity_checker.py's cases: the same verdict and statuses as
    the JAX package's checker (the incremental case checks 4, then all 10)."""
    options, kfs, status = SANITY_CASES[case]
    port = psanity.AckermannSanityChecker(psanity.AckermannOptions(**options))
    ref = jsanity.AckermannSanityChecker(jsanity.AckermannOptions(**options))
    if case == "incremental":
        assert port.check(kfs[:4]) and ref.check(kfs[:4])
    ok = port.check(kfs)
    assert ok == ref.check(kfs) == (status is None)
    assert {k: int(v) for k, v in port.results.items()} == {
        k: int(v) for k, v in ref.results.items()}
    if status is not None:
        assert port.results[3] == psanity.SanityCheckStatus[status]
    assert port._last_checked == ref._last_checked == len(kfs)


@pytest.mark.parametrize("params", [None, {"mode": "off"}, {"mode": "on", "type": "gnss"},
                                    {"mode": "on", "type": "ackermann",
                                     "max_rotation_angle_deg": 10.0}, "extrinsic"])
def test_sanity_fabric_matches_jax(params, tmp_path):
    if params == "extrinsic":
        t = np.eye(4)
        t[:3, :3] = np.asarray([[0, -1, 0], [0, 0, -1], [1, 0, 0]])
        np.savetxt(tmp_path / "extr.txt", t)
        params = {"mode": "on", "type": "ackermann", "t_camera_rear_roll_center": "extr.txt"}
    port = psanity.create_sanity_checker(params, str(tmp_path))
    ref = jsanity.create_sanity_checker(params, str(tmp_path))
    assert (port is None) == (ref is None)
    if port is not None:
        for name in ("max_rotation_angle", "forward_axis", "up_axis"):
            np.testing.assert_array_equal(getattr(port.options, name),
                                          getattr(ref.options, name))


class _FakeCam:
    def __init__(self, sensor_id, n, offset=0.0):
        self.sensor_id, self.frames, self.pos = sensor_id, [offset + 0.1 * i for i in range(n)], 0

    def next_frame(self):
        if self.pos >= len(self.frames):
            return None
        frame = type("F", (), {})()
        frame.frame_id, frame.timestamp = self.pos, self.frames[self.pos]
        self.pos += 1
        return frame


@pytest.mark.parametrize("params", [None, {"type": "no_synchronization"},
                                    {"type": "master_sensor", "sensor_id": "b"},
                                    {"type": "master", "sensor_id": "x"}, {"type": "bogus"}])
def test_synchronizer_and_agent_match_jax(params):
    """The agent's registry and the synchronizer fabric: the same master, the
    same bundles frame by frame (or the same refusal) as the JAX package's."""
    def rig():
        reg = pagent.Sensors()
        reg.add_camera(_FakeCam("a", 3))
        reg.add_camera(_FakeCam("b", 2, offset=0.01))
        return reg

    reg = rig()
    assert reg.master.sensor_id == "a" and reg.camera_ids() == ["a", "b"] and len(reg) == 2
    with pytest.raises(ValueError):
        reg.add_camera(_FakeCam("a", 1))
    if params is not None and params["type"] in ("master", "bogus"):
        with pytest.raises(ValueError):
            psync.create_synchronizer(params, reg)
        with pytest.raises(ValueError):
            jsync.create_synchronizer(params, rig().cameras)
        return
    port, ref = psync.create_synchronizer(params, reg), jsync.create_synchronizer(params,
                                                                                 rig().cameras)
    assert type(port).__name__ == type(ref).__name__ and port.master == ref.master
    for _ in range(4):
        a, b = port.sync(), ref.sync()
        assert (a is None) == (b is None)
        if a is not None:
            assert a.timestamp == b.timestamp
            assert {k: f.timestamp for k, f in a.frames.items()} == {
                k: f.timestamp for k, f in b.frames.items()}


def test_observer_set_and_writer(tmp_path):
    """tests/output/test_observers.py's fan-out, callback, meter and writer."""
    seen, rec = [], Recorder()
    s = pobs.ObserverSet().add(pobs.CallbackObserver(lambda f, r: seen.append((f, r))))
    s.add(rec)
    frame = type("F", (), {"frame_id": 0})()
    s.on_frame(frame, {"ok": True})
    s.on_keyframe(3, 0.1)
    s.finish("tracker")
    assert seen == [(frame, {"ok": True})] and (rec.frames, rec.kfs, rec.finished) == (1, 1, 1)
    meter = pobs.FpsMeter()
    for i in range(5):
        meter.on_frame(i, None)
    meter.on_keyframe(2, 0.2)
    assert meter.frames == 5 and meter.keyframes == 1 and meter.fps > 0

    class Tracker:
        window = None

        class track:  # noqa: N801
            @staticmethod
            def trajectory(window):
                return [(0.0, np.eye(4)), (0.5, np.eye(4))]

    path = tmp_path / "traj.tum"
    pobs.TrajectoryWriter(str(path)).finish(Tracker())
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("0.000000 ")
