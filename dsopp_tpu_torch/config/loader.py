"""A config file with dot-path overrides → the application (counterpart of
``dsopp_tpu/config/loader.py``): ``load_config``, ``apply_overrides``,
``build_tracker_config``, and :class:`Application` with
``build_application``, which build the cameras, the synchronizer, the
tracker, the bootstrap (feature-based, or from a poses file) and the sanity
checker from the tree.

The file is YAML, read with ``yaml`` where it is installed; without it a
JSON file (JSON is YAML) is read with ``json``, and an override's value is
parsed as a JSON scalar (a string where it is none), so the app runs on a
machine without ``yaml``.
"""

from __future__ import annotations

import copy
import json
import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dsopp_tpu_torch.tracker.monocular import TrackerConfig

log = logging.getLogger("dsopp_tpu_torch.config")


def _yaml():
    try:
        import yaml
    except ImportError:
        return None
    return yaml


def load_config(path: str) -> dict:
    """The config tree of a YAML file (``yaml``), or of a JSON file when
    ``yaml`` is not installed."""
    yaml = _yaml()
    with open(path) as f:
        return yaml.safe_load(f) if yaml is not None else json.load(f)


def _scalar(raw: str):
    """An override's value: YAML with ``yaml``, else a JSON scalar or the
    string itself."""
    yaml = _yaml()
    if yaml is not None:
        return yaml.safe_load(raw)
    try:
        return json.loads(raw)
    except ValueError:
        return raw


def apply_overrides(config: dict, overrides) -> dict:
    """Merge ``--config.a.b.0.c=value`` overrides into a copy of the tree:
    integer path components index lists, the value is parsed as a scalar
    (``_scalar``)."""
    config = copy.deepcopy(config)
    for item in overrides:
        if item.startswith("--config."):
            item = item[len("--config."):]
        path, _, raw = item.partition("=")
        keys = path.split(".")
        node = config
        for key in keys[:-1]:
            node = node[int(key)] if isinstance(node, list) else node.setdefault(key, {})
        leaf, value = keys[-1], _scalar(raw)
        if isinstance(node, list):
            node[int(leaf)] = value
        else:
            node[leaf] = value
    return config


def _affine_reg(section: dict, default: tuple) -> tuple:
    """``affine_brightness_regularizers: "a b"`` of a solver section."""
    raw = section.get("affine_brightness_regularizers")
    if raw is None:
        return default
    parts = [float(x) for x in str(raw).split()]
    return (parts[0], parts[1])


def build_tracker_config(tracker_params: dict) -> TrackerConfig:
    """The ``tracker:`` section → :class:`TrackerConfig`."""
    cfg = TrackerConfig()
    cfg.desired_points = int(tracker_params.get("number_of_desired_points",
                                                cfg.desired_points))
    kf = tracker_params.get("keyframe_strategy", {})
    cfg.keyframe_factor = float(kf.get("factor", cfg.keyframe_factor))
    marg = tracker_params.get("marginalization_strategy", {})
    cfg.window_min = int(marg.get("minimum_size", cfg.window_min))
    cfg.window_max = int(marg.get("maximum_size", cfg.window_max))
    cfg.max_marginalized_fraction = float(
        marg.get("maximum_percentage_of_marginalized_points_in_frame",
                 cfg.max_marginalized_fraction))
    pba = tracker_params.get("photometric_bundle_adjustment", {}) or {}
    cfg.pba_max_iterations = int(pba.get("max_iterations", cfg.pba_max_iterations))
    cfg.pba_affine_reg = _affine_reg(pba, cfg.pba_affine_reg)
    pa = tracker_params.get("pose_alignment", {}) or {}
    cfg.align_affine_reg = _affine_reg(pa, cfg.align_affine_reg)
    # window_max + 2: the loop pushes the new keyframe before the fold
    cfg.num_frame_slots = cfg.window_max + 2
    cfg.landmarks_per_frame = max(64, cfg.desired_points // max(cfg.window_max - 1, 1))
    return cfg


@dataclass
class Application:
    """The built pipeline: a master camera, the tracker and its bootstrap."""

    camera: object                       # master sensors.camera.Camera
    tracker: object                      # tracker.monocular.MonocularTracker
    config: dict
    init_poses: Optional[dict] = None    # timestamp → T_wc 4x4 (bootstrap poses)
    init_frames: int = 8
    fbs_initializer: Optional[object] = None  # the feature-based bootstrap
    agent: Optional[object] = None       # sensors.agent.Agent (the sensor rig)
    synchronizer: Optional[object] = None
    sanity_checker: Optional[object] = None
    _pipe: Optional[object] = None       # PipelinedTracker once initialized

    def _next_frame(self):
        """The master camera's next frame through the synchronizer."""
        if self.synchronizer is not None:
            sync = self.synchronizer.sync()
            if sync is None:
                return None
            return sync.camera_frame(self.camera.sensor_id)
        return self.camera.next_frame()

    def run(self, max_frames: Optional[int] = None, on_frame=None, observers=None):
        """The main loop: frames from the synchronizer feed the bootstrap
        (feature-based, or the poses file when the config names one) until
        it gives poses, are replayed at those poses into the tracker, and
        the frames after them go through ``PipelinedTracker``.

        ``observers``: ``output.observers.TrackObserver``s, told of each frame
        here, of keyframes and marginalizations by the track, and finished
        once after the loop; ``on_frame(frame, result)`` is one more observer.
        → the frames processed."""
        from dsopp_tpu_torch.output.observers import CallbackObserver, ObserverSet

        obs = ObserverSet(list(observers or []))
        if on_frame is not None:
            obs.add(CallbackObserver(on_frame))
        self.tracker.track.observers.append(obs)
        try:
            n = self._run_loop(obs, max_frames)
        finally:
            # a run that raised must not leave its set on the track: a
            # second run would fire every event twice
            obs.finish(self.tracker)
            self.tracker.track.observers.remove(obs)
        return n

    def _run_loop(self, obs, max_frames):
        from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker

        n = 0
        buffered = []   # the frames held while the feature-based bootstrap runs
        while True:
            frame = self._next_frame()
            if frame is None or (max_frames is not None and n >= max_frames):
                break
            if not self.tracker.is_initialized():
                if self.init_poses is not None:
                    result = self.tracker.tick(
                        frame.frame_id, frame.timestamp, frame.image,
                        known_pose=self._lookup_pose(frame.timestamp),
                        force_keyframe=n == self.init_frames - 1, exposure=frame.exposure)
                else:
                    # the frame stays on the device: the bootstrap tracks it there
                    fbs = self._fbs()
                    buffered.append((frame.frame_id, frame.timestamp, frame.image))
                    done = fbs.process(frame.frame_id, frame.timestamp, frame.image)
                    if done:
                        by_id = {fid: mat for fid, _, mat in fbs.poses}
                        self.tracker.initialize([
                            (fid, ts, img, self._pose_from_matrix(by_id[fid]))
                            for fid, ts, img in buffered if fid in by_id])
                        buffered = []
                    result = {"keyframe": done, "bootstrap": True}
            else:
                if self._pipe is None:
                    self._pipe = PipelinedTracker(self.tracker, flush_every=16)
                self._pipe.tick(frame.frame_id, frame.timestamp, frame.image,
                                semantics=frame.semantics, exposure=frame.exposure)
                result = {"pipelined": True}
            obs.on_frame(frame, result)
            if result.get("keyframe"):
                self._run_sanity_check()
            n += 1
        if self._pipe is not None:
            self._pipe.finalize()
            self._pipe = None
            self._run_sanity_check()
        return n

    def _run_sanity_check(self):
        """The sanity checker on the marginalized keyframes (host copies; the
        window's keyframes are checked once, by ``finish``)."""
        if self.sanity_checker is None:
            return
        kfs = [(i, kf.timestamp, kf.t_wc)
               for i, kf in enumerate(self.tracker.track.marginalized)]
        if kfs:
            self.sanity_checker.check(kfs)

    def finish(self):
        """After the run: the sanity checker on the window's keyframes too."""
        if self.sanity_checker is None:
            return
        track, window = self.tracker.track, self.tracker.window
        kfs = [(i, kf.timestamp, kf.t_wc) for i, kf in enumerate(track.marginalized)]
        base = len(kfs)
        mats = window.poses().matrix().cpu().numpy().astype(np.float64)
        ids = window.frame_id.cpu().numpy()
        for pos in range(int(window.frame_valid.sum())):
            fid = int(ids[pos])
            kfs.append((base + pos, track.keyframe_timestamps.get(fid, 0.0), mats[pos]))
        if kfs:
            self.sanity_checker.check(kfs)

    def _fbs(self):
        if self.fbs_initializer is None:
            from dsopp_tpu_torch.fbs import InitializerOptions, MonocularInitializer

            opts = InitializerOptions()
            init_cfg = self.config.get("initializer", {})
            fe = init_cfg.get("features_extractor", {}) or {}
            opts.num_features = int(fe.get("number_of_features", opts.num_features))
            # features_extractor.type: ORB asks for the distinct-features matcher
            if str(fe.get("type", "")).upper().startswith("ORB"):
                opts.matcher = "orb"
            opts.se3_inlier_ratio = float(init_cfg.get("se3_inlier_ratio",
                                                       opts.se3_inlier_ratio))
            opts.essential_ransac_threshold_px = float(init_cfg.get(
                "essential_matrix_ransac_threshold", opts.essential_ransac_threshold_px))
            opts.pnp_ransac_threshold_px = float(init_cfg.get(
                "pnp_ransac_threshold", opts.pnp_ransac_threshold_px))
            # initializer_type: calibrated | autocalibrated
            opts.autocalibrate = (init_cfg.get("initializer_type", "calibrated")
                                  == "autocalibrated")
            opts.reprojection_threshold_px = float(init_cfg.get(
                "reprojection_threshold", opts.reprojection_threshold_px))
            self.fbs_initializer = MonocularInitializer(self.camera.camera_model(0), opts)
        return self.fbs_initializer

    def _pose_from_matrix(self, mat):
        from dsopp_tpu_torch.core.lie import SE3

        return SE3.from_matrix(torch.as_tensor(np.asarray(mat), dtype=self.tracker.dtype,
                                               device=self.tracker.device))

    def _lookup_pose(self, timestamp):
        times = np.asarray(sorted(self.init_poses))
        idx = int(np.argmin(np.abs(times - timestamp)))
        return self._pose_from_matrix(self.init_poses[float(times[idx])])


def build_application(config: dict, base_dir: str = ".", dtype=torch.float32,
                      device=None) -> Application:
    """The application of a config tree (files relative to ``base_dir``), the
    tracker in ``dtype`` on ``device`` (``None``: the CUDA card, raising
    without one)."""
    from dsopp_tpu_torch import default_device
    from dsopp_tpu_torch.sanity_checker import create_sanity_checker
    from dsopp_tpu_torch.sensors.agent import Agent, Sensors
    from dsopp_tpu_torch.sensors.camera import Camera
    from dsopp_tpu_torch.sensors.synchronizer import create_synchronizer
    from dsopp_tpu_torch.output.tum import load_tum
    from dsopp_tpu_torch.tracker.monocular import MonocularTracker

    device = default_device(device)
    registry = Sensors()
    for i, s in enumerate(config.get("sensors", [])):
        if s.get("type") == "camera":
            registry.add_camera(Camera.from_config(s.get("id", f"camera_{i + 1}"), s,
                                                   base_dir, device=device))
    if len(registry) == 0:
        raise ValueError("config has no camera sensor")
    agent = Agent(sensors=registry)
    synchronizer = create_synchronizer(config.get("time"), registry)
    camera = registry.get(synchronizer.master) or registry.master

    tracker_params = config.get("tracker", {})
    if tracker_params.get("type", "monocular") != "monocular":
        log.warning("unknown tracker type %r; using monocular", tracker_params.get("type"))
    cfg = build_tracker_config(tracker_params)
    # the master sensor's frame embedder (gn_net's weights are not open;
    # filter_bank is its C = 3 stand-in)
    for s in config.get("sensors", []):
        fe = s.get("frame_embedder")
        if fe and s.get("id", "camera_1") == camera.sensor_id:
            kind = str(fe.get("type", "identity"))
            if kind == "gn_net":
                raise ValueError(
                    "frame_embedder type 'gn_net' is proprietary in the "
                    "reference; use 'filter_bank' (C=3) or 'identity'")
            cfg.embedder = kind
    tracker = MonocularTracker(camera.camera_model(0), cfg, dtype=dtype, device=device,
                               mask=camera.processed_mask())
    tracker.semantic_filter = tuple(camera.semantic_filter)

    # the bootstrap: precalculated poses when the config names a poses file,
    # else the feature-based initializer
    init_poses, init_frames = None, 8
    init_params = config.get("initializer", {})
    poses_file = init_params.get("poses_file") or (
        tracker_params.get("pose_alignment", {}) or {}).get("poses_file")
    if init_params.get("type") == "precalculated" or poses_file:
        entries = load_tum(os.path.join(base_dir, poses_file))
        init_poses = {float(t): m for t, m in entries}
        init_frames = int(init_params.get("num_frames", init_frames))

    return Application(camera=camera, tracker=tracker, config=config, init_poses=init_poses,
                       init_frames=init_frames, agent=agent, synchronizer=synchronizer,
                       sanity_checker=create_sanity_checker(config.get("sanity_checker"),
                                                            base_dir))
