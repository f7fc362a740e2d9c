"""The port's outputs against the JAX package's (numpy; no JAX program is
compiled but the few eager ops of a JAX window's ``poses()``):

* ``track.bin``: the bytes of the port's file equal to the JAX package's on
  the same track of marginalized keyframes with connections, sanity results,
  class ids and the camera's settings; with a live window (a JAX window and
  its port copy by ``convert.window``) the decoded fields within 1e-12, the
  poses being composed in each package's own arithmetic; each package's
  ``load_track_bin`` reads the other's file; the framing and the round trip
  of ``tests/output/test_protobuf_track.py``;
* every exporter's file byte-equal to the JAX package's on the same
  ``track_data``;
* ``debug_images`` and the offline viewer's renders equal to the JAX
  package's arrays, and the viewer's CLI on a saved track;
* the live viewer's ``/`` and ``/state.json`` during a short tracked run on
  the CPU at ``tests/output/test_live_viewer.py``'s size, and its point cap.

The file runs in ~20 s on one worker, most of it the tracked run.
"""

import dataclasses
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsopp_tpu.app import viewer as jviewer
from dsopp_tpu.output import debug_images as jdebug
from dsopp_tpu.output import exporters as jexp
from dsopp_tpu.output import protobuf_track as jpb
from dsopp_tpu.sensors.calibration import CameraCalibration as JCalibration
from dsopp_tpu.solvers.pba import Window as JWindow
from dsopp_tpu.track import state as jstate
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.app import viewer as pviewer
from dsopp_tpu_torch.output import debug_images as pdebug
from dsopp_tpu_torch.output import exporters as pexp
from dsopp_tpu_torch.output import protobuf_track as ppb
from dsopp_tpu_torch.output.live_viewer import LiveViewer
from dsopp_tpu_torch.sensors.calibration import CameraCalibration as PCalibration
from dsopp_tpu_torch.testing.synthetic import render_sequence
from dsopp_tpu_torch.track import state as pstate
from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

from tests import _torch_port  # noqa: F401  (one torch thread a worker)


class _Cam:
    fx, fy, cx, cy = 260.0, 255.0, 160.0, 120.0


def _rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    from dsopp_tpu_torch.output.tum import _quat_to_matrix

    return _quat_to_matrix(*q)


def _track(state, seed=0, n_kf=3, n_lm=40, semantics=True):
    """A track of ``n_kf`` marginalized keyframes (with attached frames,
    class ids on all but the first, connections between them) built from
    the classes of ``state`` (either package's ``track.state``)."""
    rng = np.random.default_rng(seed)
    track = state.OdometryTrack()
    for i in range(n_kf):
        mat = np.eye(4)
        mat[:3, :3] = _rot(rng)
        mat[:3, 3] = rng.normal(0, 1, 3)
        track.on_keyframe(i * 10, 0.5 * i)
        kf = state.MarginalizedKeyframe(
            frame_id=i * 10, timestamp=0.5 * i, t_wc=mat,
            affine=rng.normal(0, 0.1, 2), exposure=1.0 + 0.1 * i,
            lm_uv=rng.uniform(10, 300, (n_lm, 2)).astype(np.float32),
            lm_idepth=rng.uniform(0.1, 1.0, n_lm).astype(np.float32),
            lm_valid=rng.uniform(size=n_lm) > 0.2,
            lm_outlier=rng.uniform(size=n_lm) > 0.9,
            lm_baseline=rng.uniform(0, 1, n_lm).astype(np.float32),
            lm_semantic=(rng.integers(0, 9, n_lm) if semantics and i else None))
        amat = np.eye(4)
        amat[:3, :3] = _rot(rng)
        amat[:3, 3] = rng.normal(0, 0.05, 3)
        track.attached[i * 10] = [state.AttachedFrame(
            i * 10 + 1, 0.5 * i + 0.1, i * 10, amat, exposure=1.1,
            affine=rng.normal(0, 0.1, 2))]
        track.on_marginalize(kf)
    for a in range(n_kf):
        for b in range(n_kf):
            if a != b:
                cov = rng.normal(size=(6, 6))
                track.connections[(a * 10, b * 10)] = cov @ cov.T
    return track


SANITY = {1: 3, 0: 0, 2: 5}


def _calibration(cls):
    return cls("pinhole", (320.0, 240.0), np.asarray([260.0, 255.0, 160.0, 120.0]),
               shutter_time=0.02)


def test_track_bin_bytes_equal_jax(tmp_path):
    jpath, ppath = tmp_path / "jax.bin", tmp_path / "port.bin"
    jpb.save_track_bin(str(jpath), _track(jstate), camera=_Cam(),
                       model=_calibration(JCalibration), sensor_id=2, sanity_results=SANITY)
    ppb.save_track_bin(str(ppath), _track(pstate), camera=_Cam(),
                       model=_calibration(PCalibration), sensor_id=2, sanity_results=SANITY)
    blob = ppath.read_bytes()
    assert len(blob) > 1000 and blob == jpath.read_bytes()


def _window_fields(seed=3, k=5, n=12, h=8, w=10, count=4):
    """Numpy fields of a JAX window of ``count`` live slots (one dead), with
    a C = 1 patch bank for the JAX side."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(k, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = np.arange(k) < count
    f = dict(
        t_lin_q=q, t_lin_t=rng.normal(size=(k, 3)), affine0=rng.normal(0, 0.1, (k, 2)),
        eps=rng.normal(0, 1e-3, (k, 8)), exposure=rng.uniform(0.5, 2, k),
        frame_valid=valid, frame_fixed=np.arange(k) == 0, frame_marg=np.zeros(k, bool),
        frame_id=np.where(valid, 3 * np.arange(k) + 1, -1).astype(np.int32),
        lm_uv=rng.uniform(0, w, (k, n, 2)), lm_patch=rng.uniform(0, 255, (k, n, 8)),
        lm_idepth=rng.uniform(0.1, 2, (k, n)), lm_valid=rng.uniform(size=(k, n)) > 0.3,
        lm_marg_flag=np.zeros((k, n), bool), lm_outlier=rng.uniform(size=(k, n)) > 0.8,
        lm_inliers=np.zeros((k, n), np.int32), lm_opt_count=np.zeros((k, n), np.int32),
        lm_baseline=rng.uniform(0, 1, (k, n)), res_status=np.zeros((k, k, n), np.int32),
        h_marg=np.zeros((8 * k, 8 * k)), b_marg=np.zeros(8 * k), energy_marg=np.zeros(()),
        maps=rng.uniform(0, 255, (k, 3, h, w)), patch=np.zeros((k, h * w, 128)),
        patch_map=np.arange(k, dtype=np.int32))
    for name in ("h_marg", "b_marg", "energy_marg"):
        f[name + "_lo"] = np.zeros_like(f[name])
    return f


def _live_track(state, ids):
    track = state.OdometryTrack()
    rng = np.random.default_rng(5)
    for fid in ids:
        track.on_keyframe(fid, 0.1 * fid)
        amat = np.eye(4)
        amat[:3, 3] = rng.normal(0, 0.05, 3)
        track.attach_frame(state.AttachedFrame(fid + 1, 0.1 * fid + 0.05, fid, amat))
    return track


def _assert_decoded_close(a, b, tol=1e-12):
    assert len(a["keyframes"]) == len(b["keyframes"]) > 0
    assert a["sanity_check_results"] == b["sanity_check_results"]
    for ka, kb in zip(a["keyframes"], b["keyframes"]):
        for key in ("frame_id", "keyframe_id", "timestamp", "exposure"):
            assert ka[key] == pytest.approx(kb[key], abs=tol), key
        np.testing.assert_allclose(ka["t_world_agent"], kb["t_world_agent"], rtol=0, atol=tol)
        np.testing.assert_allclose(ka["affine"], kb["affine"], rtol=0, atol=tol)
        pa, pb = ka["landmarks"][0]["points"], kb["landmarks"][0]["points"]
        assert len(pa) == len(pb)
        for key in ("uv", "direction", "idepth", "baseline", "semantic", "variance"):
            np.testing.assert_allclose([p[key] for p in pa], [p[key] for p in pb], rtol=0,
                                       atol=tol, err_msg=key)
        assert len(ka["attached"]) == len(kb["attached"])
        for ta, tb in zip(ka["attached"], kb["attached"]):
            np.testing.assert_allclose(ta["t_keyframe_agent"], tb["t_keyframe_agent"],
                                       rtol=0, atol=tol)


def test_track_bin_with_a_live_window_matches_jax(tmp_path):
    fields = _window_fields()
    jwin = JWindow(**{k: jnp.asarray(v) for k, v in fields.items()})
    pwin = convert.window(fields)
    ids = [int(i) for i in fields["frame_id"] if i >= 0]
    jpath, ppath = tmp_path / "jax.bin", tmp_path / "port.bin"
    jpb.save_track_bin(str(jpath), _live_track(jstate, ids), jwin, camera=_Cam(),
                       sanity_results=SANITY)
    ppb.save_track_bin(str(ppath), _live_track(pstate, ids), pwin, camera=_Cam(),
                       sanity_results=SANITY)
    _assert_decoded_close(ppb.load_track_bin(str(ppath)), jpb.load_track_bin(str(jpath)))
    poses = pwin.poses().matrix().numpy()
    got = ppb.load_track_bin(str(ppath))["keyframes"]
    for pos, kf in enumerate(got):
        np.testing.assert_allclose(kf["t_world_agent"], poses[pos], rtol=0, atol=1e-12)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_track_bin(tmp_path, writer):
    path = tmp_path / "track.bin"
    if writer == "jax":
        jpb.save_track_bin(str(path), _track(jstate), camera=_Cam(), sanity_results=SANITY)
    else:
        ppb.save_track_bin(str(path), _track(pstate), camera=_Cam(), sanity_results=SANITY)
    a, b = ppb.load_track_bin(str(path)), jpb.load_track_bin(str(path))
    _assert_decoded_close(a, b, tol=0.0)
    assert a["sanity_check_results"] == SANITY


def test_track_bin_round_trip(tmp_path):
    """``tests/output/test_protobuf_track.py::test_track_bin_roundtrip`` on the
    port's writer and reader."""
    track = _track(pstate, semantics=False)
    path = tmp_path / "track.bin"
    ppb.save_track_bin(str(path), track, camera=_Cam())
    data = ppb.load_track_bin(str(path))
    assert len(data["keyframes"]) == 3
    for i, kf in enumerate(data["keyframes"]):
        src = track.marginalized[i]
        assert kf["frame_id"] == src.frame_id and kf["keyframe_id"] == i
        assert abs(kf["timestamp"] - src.timestamp) < 1e-9
        np.testing.assert_allclose(kf["t_world_agent"], src.t_wc, atol=1e-12)
        np.testing.assert_allclose(kf["affine"], src.affine, atol=1e-12)
        assert abs(kf["exposure"] - src.exposure) < 1e-12
        pts = kf["landmarks"][0]["points"]
        valid = src.lm_valid & ~src.lm_outlier
        assert len(pts) == int(valid.sum())
        np.testing.assert_allclose([p["uv"][0] for p in pts], src.lm_uv[valid][:, 0], atol=1e-6)
        np.testing.assert_allclose([p["idepth"] for p in pts], src.lm_idepth[valid], atol=1e-7)
        np.testing.assert_allclose(kf["attached"][0]["t_keyframe_agent"],
                                   src.attached[0].t_keyframe_frame, atol=1e-12)


def test_track_bin_framing(tmp_path):
    """The reference's framing: a u64 count, u32-prefixed keyframe messages and
    five trailing sections (connections, gnss, ecef, sanity, agent settings)."""
    import struct

    path = tmp_path / "track.bin"
    ppb.save_track_bin(str(path), _track(pstate, n_kf=2), camera=_Cam(),
                       model=_calibration(PCalibration), sanity_results=SANITY)
    blob = path.read_bytes()
    assert struct.unpack_from("<Q", blob, 0)[0] == 2
    off, sections = 8, []
    for _ in range(2):
        off += 4 + struct.unpack_from("<I", blob, off)[0]
    while off < len(blob):
        size = struct.unpack_from("<I", blob, off)[0]
        sections.append(size)
        off += 4 + size
    assert off == len(blob) and len(sections) == 5
    # connections, no gnss, no ecef poses, sanity results, agent settings
    assert sections[0] > 0 and sections[1] == sections[2] == 0
    assert sections[3] > 0 and sections[4] > 0


def _track_data(n_kf=3, n_lm=20, seed=0):
    rng = np.random.default_rng(seed)
    keyframes = []
    for i in range(n_kf):
        t = np.eye(4)
        t[:3, :3] = _rot(rng)
        t[:3, 3] = rng.normal(0, 1, 3)
        keyframes.append({
            "frame_id": i, "timestamp": 0.1 * i, "t_wc": t, "affine": rng.normal(0, 0.1, 2),
            "exposure": 1.0, "lm_uv": rng.uniform(0, 100, (n_lm, 2)),
            "lm_idepth": rng.uniform(-0.1, 1.0, n_lm), "lm_valid": rng.uniform(size=n_lm) > 0.2})
    return {"meta": {"camera": {"fx": 100.0, "fy": 101.0, "cx": 50.0, "cy": 49.5,
                                "width": 100, "height": 100}},
            "keyframes": keyframes,
            "attached": [{"keyframe_id": 0, "frame_id": 7, "timestamp": 0.05,
                          "t_keyframe_frame": np.eye(4)}]}


@pytest.mark.parametrize("name", ["export_json", "export_xyz", "export_ply", "export_colmap",
                                  "export_nerf_transforms"])
def test_exporters_byte_equal_jax(tmp_path, name):
    data = _track_data()
    outs = []
    for label, module in (("jax", jexp), ("port", pexp)):
        target = tmp_path / label / ("sparse" if name == "export_colmap" else "out.txt")
        target.parent.mkdir()
        result = getattr(module, name)(data, str(target))
        files = sorted(os.listdir(target)) if target.is_dir() else [target.name]
        base = target if target.is_dir() else target.parent
        outs.append((result, {f: (base / f).read_bytes() for f in files}))
    assert outs[0] == outs[1]
    assert all(len(blob) > 0 for blob in outs[1][1].values())


def test_debug_images_equal_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-10, 270, (32, 40))
    mask = rng.uniform(size=(32, 40)) > 0.3
    np.testing.assert_array_equal(pdebug._jet(np.linspace(-0.2, 1.2, 50)),
                                  jdebug._jet(np.linspace(-0.2, 1.2, 50)))
    out = pdebug.debug_current_frame(img, mask)
    np.testing.assert_array_equal(out, jdebug.debug_current_frame(img, mask))
    np.testing.assert_array_equal(pdebug.debug_current_frame(img), jdebug.debug_current_frame(img))
    assert (out[~mask][:, 2] >= out[~mask][:, 0]).all()
    idep, wei = np.zeros((32, 40)), np.zeros((32, 40))
    pts = rng.integers(0, 32, (30, 2))
    wei[pts[:, 0], pts[:, 1]] = rng.uniform(0.5, 2, 30)
    idep[pts[:, 0], pts[:, 1]] = rng.uniform(0.1, 1, 30) * wei[pts[:, 0], pts[:, 1]]
    port, ref = pdebug.KeyframeDepthDebug(radius=1), jdebug.KeyframeDepthDebug(radius=1)
    for _ in range(3):
        np.testing.assert_array_equal(port.render(img, idep, wei), ref.render(img, idep, wei))
        assert port.visualization_maximum_idepth == ref.visualization_maximum_idepth > 0


def _bin_track(tmp_path):
    """A saved track.bin of three keyframes (the port's writer)."""
    track = pstate.OdometryTrack()
    rng = np.random.default_rng(1)
    for i in range(3):
        t_wc = np.eye(4)
        t_wc[:3, :3] = _rot(rng) if i else np.eye(3)
        t_wc[:3, 3] = [0.1 * i, 0, 0.3 * i]
        track.on_marginalize(pstate.MarginalizedKeyframe(
            frame_id=i, timestamp=float(i), t_wc=t_wc, affine=np.zeros(2), exposure=1.0,
            lm_uv=rng.uniform(4, 60, (20, 2)), lm_idepth=rng.uniform(0.2, 2.0, 20),
            lm_valid=np.ones(20, bool), lm_outlier=np.zeros(20, bool),
            lm_baseline=np.zeros(20)))
    path = tmp_path / "track.bin"
    ppb.save_track_bin(str(path), track, camera=type("C", (), dict(fx=50.0, fy=50.0, cx=32.0,
                                                                 cy=32.0))())
    return path


def test_viewer_renders_equal_jax(tmp_path):
    data = ppb.load_track_bin(str(_bin_track(tmp_path)))
    pts, traj = pviewer._landmark_points(data), pviewer._trajectory(data)
    np.testing.assert_array_equal(pts, jviewer._landmark_points(data))
    np.testing.assert_array_equal(traj, jviewer._trajectory(data))
    assert pts.shape == (60, 3) and traj.shape == (3, 3)
    for azimuth in (0.6, 2.0):
        img = pviewer.render_cloud(pts, traj, 160, 120, azimuth=azimuth)
        np.testing.assert_array_equal(img, jviewer.render_cloud(pts, traj, 160, 120,
                                                                azimuth=azimuth))
        assert (img != 0).any(axis=-1).sum() > 30
    empty = pviewer.render_cloud(np.zeros((0, 3)), np.zeros((0, 3)), 64, 48)
    assert empty.shape == (48, 64, 3) and not empty.any()


def test_viewer_cli_on_saved_track(tmp_path):
    path = _bin_track(tmp_path)
    assert pviewer.main(["--track", str(path), "--output_dir", str(tmp_path / "view"),
                         "--frames", "2", "--image_size", "160", "120"]) == 0
    files = sorted(os.listdir(tmp_path / "view"))
    assert [f.split(".")[0] for f in files] == ["view_0000", "view_0001"]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def test_live_viewer_serves_a_tracked_run():
    """``tests/output/test_live_viewer.py``'s run on the port (f64 on the CPU):
    the known-pose bootstrap, then ``PipelinedTracker``; the page and the
    snapshot while the viewer observes the track."""
    seq = render_sequence(num_frames=22, height=96, width=128, dtype=torch.float64,
                          device="cpu")
    cfg = TrackerConfig(num_frame_slots=6, landmarks_per_frame=64, immature_per_frame=128,
                        desired_points=300, frontend_points=400, pyramid_levels=3,
                        window_min=2, window_max=3, keyframe_factor=3.0,
                        use_rotation_perturbations=False)
    tracker = MonocularTracker(seq.camera, cfg, dtype=torch.float64, device="cpu")
    viewer = LiveViewer(seq.camera, port=0)
    tracker.track.observers.append(viewer)
    try:
        tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i], seq.pose(i))
                            for i in range(5)])
        pipe = PipelinedTracker(tracker, flush_every=4)
        for i in range(5, 22):
            pipe.tick(i, float(seq.timestamps[i]), seq.images[i])
            viewer.on_frame(type("F", (), {"frame_id": i})(), {})
        pipe.finalize()
        viewer.finish(tracker)
        page = _get(viewer.port, "/").decode()
        assert "<canvas" in page and "state.json" in page and "marginalized cloud" in page
        state = json.loads(_get(viewer.port, "/state.json"))
        assert state["frame_id"] == 21 and state["fps"] > 0
        assert state["num_keyframes"] == tracker.num_keyframes >= 3
        assert len(tracker.track.marginalized) >= 1
        pts = np.asarray(state["points"]).reshape(-1, 4)
        assert len(pts) > 30 and np.isfinite(pts).all()
        assert len(state["traj"]) == 3 * len(tracker.track.marginalized)
        assert len(state["frusta"]) == (len(tracker.track.marginalized)
                                        + int(tracker.window.frame_valid.sum()))
        with pytest.raises(urllib.error.HTTPError):
            _get(viewer.port, "/other")
    finally:
        viewer.close()


def test_live_viewer_point_cap_rolls():
    viewer = LiveViewer(None, port=0)
    try:
        viewer.MAX_POINTS = 10
        viewer._points = list(range(4 * 10))
        kf = dataclasses.make_dataclass("KF", ["t_wc", "lm_uv", "lm_idepth", "lm_valid",
                                               "lm_outlier"])(
            np.eye(4), np.zeros((0, 2)), np.zeros(0), np.zeros(0, bool), np.zeros(0, bool))
        viewer.on_marginalize(kf)
        assert len(viewer._points) <= 4 * viewer.MAX_POINTS
    finally:
        viewer.close()
