"""Monocular tracker: configuration, state and the known-pose bootstrap
(counterpart of ``dsopp_tpu/tracker/monocular.py``).

``MonocularTracker(camera, TrackerConfig(...), dtype=..., device=...,
mask=...)`` (``mask``: the sensor's static CameraMask, [H, W] bool, true where
a candidate point may be placed; ``None``: everywhere; ``semantic_filter``:
class ids whose pixels a frame's class-id image takes out of that mask) is
bootstrapped with
``initialize(frames)`` from frames of known pose: the first is pushed as the fixed keyframe, the next run the epipolar update and
the flow statistic (and become keyframes when the strategy asks), the last
is forced to be a keyframe.  Tracking then goes through
:class:`~dsopp_tpu_torch.tracker.device_loop.PipelinedTracker`.

``TrackerConfig.embedder`` picks the frame embedder (``"identity"``, C = 1,
or ``"filter_bank"``, C = 3): its channels feed the windowed BA, whose
affine priors are scaled by C as the JAX package scales them; the frontend
alignment and the epipolar tracer stay C = 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dsopp_tpu_torch import default_device
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features.embedder import make_embedder
from dsopp_tpu_torch.features.pyramid import build_channel_map, build_pyramid_maps
from dsopp_tpu_torch.sensors.masks import filter_semantic_objects
from dsopp_tpu_torch.sensors.pinned import PinnedRing
from dsopp_tpu_torch.solvers.pba import PBAOptions, empty_window, frame_count, push_frame_slot
from dsopp_tpu_torch.solvers.pose_alignment import AlignmentOptions
from dsopp_tpu_torch.track.state import AttachedFrame, OdometryTrack
from dsopp_tpu_torch.tracker.depth_estimation import ImmaturePoints, estimate_depths
from dsopp_tpu_torch.tracker.depth_map import (KEYFRAME_THRESHOLD, MAX_EXCESS_ENERGY,
                                               MAX_SHIFT_NO_ROT_WEIGHT, MAX_SHIFT_WEIGHT,
                                               build_frontend_state, mean_square_flows)
from dsopp_tpu_torch.tracker.device_loop import (DeviceLoopConfig, keyframe_update,
                                                 record_marginalized)
from dsopp_tpu_torch.tracker.fused_keyframe import immature_bank, set_bank


@dataclass
class TrackerConfig:
    num_frame_slots: int = 8
    landmarks_per_frame: int = 300
    immature_per_frame: int = 500
    desired_points: int = 2000
    pyramid_levels: int = 5
    frontend_points: int = 2000
    keyframe_factor: float = 1.0
    window_min: int = 5
    window_max: int = 7
    max_marginalized_fraction: float = 0.95
    huber_sigma: float = 20.0
    use_rotation_perturbations: bool = True
    # relative pose covariances of the window after each keyframe's solve
    # (track.connections); the known-pose ticks only, as in the JAX package
    estimate_uncertainty: bool = False
    refine_activation: bool = True
    embedder: str = "identity"       # frame embedder: "identity" (C = 1) or "filter_bank"
    pba_max_iterations: int = 7
    pba_affine_reg: tuple = (1e12, 1e8)
    align_affine_reg: tuple = (1e12, 1e8)


class MonocularTracker:
    """Direct sparse odometry over one camera stream."""

    def __init__(self, camera, config: TrackerConfig = TrackerConfig(),
                 dtype=torch.float32, device=None, mask=None):
        self.camera = camera
        self.config = config
        self.dtype = dtype
        self.device = default_device(device)
        self.image_shape = (int(camera.height), int(camera.width))
        # candidate-selection validity mask (the reference's CameraMask); None
        # is all-valid and hands no mask image to the candidate selection
        self.base_mask = None
        if mask is not None:
            self.base_mask = torch.as_tensor(mask, dtype=torch.bool,
                                             device=self.device).contiguous()
            if tuple(self.base_mask.shape) != self.image_shape:
                raise ValueError(f"mask {tuple(self.base_mask.shape)} for a"
                                 f" {self.image_shape} image")
        self.mask = self.base_mask
        self.semantic_filter: tuple = ()   # class ids masked out per frame
        self._last_semantics = None        # newest frame's class-id image
        self._kf_semantics = {}            # keyframe id → class-id image
        self._semantic_ring = PinnedRing()  # class-id images to the card, no host wait
        self.models = [camera.scaled(float(2 ** l)) for l in range(config.pyramid_levels)]
        self.embedder = make_embedder(config.embedder)
        c = self.embedder.channels
        self.window = empty_window(config.num_frame_slots, config.landmarks_per_frame,
                                   (3,) + self.image_shape, dtype=dtype, device=self.device,
                                   channels=c)
        self.immature: Optional[ImmaturePoints] = None
        self.track = OdometryTrack()
        self.pba_opts = PBAOptions(huber_sigma=config.huber_sigma,
                                   max_iterations=config.pba_max_iterations,
                                   affine_reg_a=float(config.pba_affine_reg[0]) * c,
                                   affine_reg_b=float(config.pba_affine_reg[1]) * c)
        self.align_opts = AlignmentOptions(huber_sigma=config.huber_sigma,
                                           affine_reg_a=float(config.align_affine_reg[0]),
                                           affine_reg_b=float(config.align_affine_reg[1]))
        self.level_points = None
        self.depth_maps = None
        self.flow_points = None
        self.rmse_last = [1e8] * config.pyramid_levels
        self.t_w_last: Optional[SE3] = None
        self.t_prev_rel = SE3.identity((), dtype, self.device)
        self.last_affine = torch.zeros(2, dtype=dtype, device=self.device)
        self.num_keyframes = 0
        self.kf_id = -1
        self.kf_rmse = -1.0          # keyframe-strategy rmse memory
        self.min_distance = 3.0      # activation spacing (P-controller state)

    def is_initialized(self) -> bool:
        return self.num_keyframes >= 2

    def loop_config(self) -> DeviceLoopConfig:
        c = self.config
        return DeviceLoopConfig(
            align_opts=self.align_opts, pba_opts=self.pba_opts,
            num_levels=c.pyramid_levels, with_perturbations=c.use_rotation_perturbations,
            huber_sigma=c.huber_sigma, refine=c.refine_activation,
            immature_per_frame=c.immature_per_frame, frontend_points=c.frontend_points,
            desired_points=float(c.desired_points), keyframe_factor=c.keyframe_factor,
            window_min=c.window_min, window_max=c.window_max,
            max_marg_fraction=c.max_marginalized_fraction,
            height=self.image_shape[0], width=self.image_shape[1], embedder=c.embedder)

    def _kf_pose(self) -> SE3:
        pos = frame_count(self.window) - 1
        poses = self.window.poses()
        return SE3(poses.q[pos], poses.t[pos])

    def _need_keyframe(self, flow: float, flow_no_rot: float, rmse: float) -> bool:
        """Optical-flow + rmse strategy on host floats (reliable frames)."""
        if self.kf_rmse < 0:
            self.kf_rmse = rmse
        need = ((self.config.keyframe_factor
                 * (MAX_SHIFT_WEIGHT * flow + MAX_SHIFT_NO_ROT_WEIGHT * flow_no_rot)
                 > KEYFRAME_THRESHOLD)
                or rmse / max(self.kf_rmse, 1e-12) > MAX_EXCESS_ENERGY)
        if need:
            self.kf_rmse = -1.0
        return need

    def _rebuild_frontend(self, maps):
        h, w = self.image_shape
        idep, wei, points, flow_pts = build_frontend_state(
            self.window, self.camera, tuple(maps), h, w, self.config.pyramid_levels,
            self.config.frontend_points)
        self.depth_maps = (idep, wei)
        self.level_points = list(points)
        self.flow_points = flow_pts

    def semantic_mask(self, semantics):
        """The candidate mask of a frame with class-id image ``semantics``:
        the static mask less the pixels of the ``semantic_filter`` classes."""
        base = self.base_mask
        if base is None:
            base = torch.ones(self.image_shape, dtype=torch.bool, device=self.device)
        semantics = np.asarray(semantics)
        if self.device.type == "cuda":
            sem = self._semantic_ring.upload(semantics, self.device)
        else:
            sem = torch.as_tensor(semantics)
        return filter_semantic_objects(base, sem, self.semantic_filter)

    def tick(self, frame_id: int, timestamp: float, image, known_pose: SE3,
             force_keyframe: bool = False, semantics=None, exposure: float = 1.0):
        """One bootstrap frame of known pose T_w_c.  ``semantics``: optional
        [H, W] class-id image (numpy), as in ``PipelinedTracker.tick``."""
        if known_pose is None:
            raise ValueError("MonocularTracker.tick takes frames of known pose; "
                             "track further frames with PipelinedTracker")
        if semantics is not None:
            self._last_semantics = np.asarray(semantics)
            if self.semantic_filter:
                self.mask = self.semantic_mask(self._last_semantics)
        d = dict(dtype=self.dtype, device=self.device)
        image = torch.as_tensor(image, **d)
        pose = SE3(torch.as_tensor(known_pose.q, **d), torch.as_tensor(known_pose.t, **d))
        exp_t = torch.tensor(float(exposure), **d)
        maps = build_pyramid_maps(image, self.config.pyramid_levels)
        cfg = self.config

        if frame_count(self.window) == 0:
            self._on_keyframe(frame_id)
            self.track.on_keyframe(frame_id, timestamp)
            self.num_keyframes += 1
            self.kf_id = frame_id
            channel_map = (None if self.embedder.channels == 1
                           else build_channel_map(self.embedder(maps[0][0])))
            self.window = push_frame_slot(self.window, 0, pose.q, pose.t,
                                          torch.zeros(2, **d), exp_t, True, frame_id, maps[0],
                                          channel_map)
            bank = immature_bank(maps[0], cfg.immature_per_frame, self.mask)
            self.immature = set_bank(
                ImmaturePoints(*(torch.zeros((cfg.num_frame_slots,) + tuple(x.shape),
                                             dtype=x.dtype, device=x.device) for x in bank)),
                0, bank)
            self._rebuild_frontend(maps)
            self.t_w_last = pose
            return {"keyframe": True, "pose": pose}

        t_w_kf = self._kf_pose()
        t_t_kf = pose.inverse() @ t_w_kf
        poses = self.window.poses()
        self.immature = estimate_depths(
            self.immature, maps[0], self.camera, pose.q, pose.t, poses.q, poses.t,
            self.window.affine(), self.last_affine, exp_t, self.window.exposure,
            cfg.huber_sigma)
        flow, flow_no_rot = (float(v) for v in mean_square_flows(self.flow_points, self.camera, t_t_kf))
        need_kf = force_keyframe or self._need_keyframe(flow, flow_no_rot, 0.0)
        self.t_prev_rel = self.t_w_last.inverse() @ pose
        self.t_w_last = pose
        if not need_kf:
            mat = (t_w_kf.inverse() @ pose).matrix().cpu().numpy().astype(np.float64)
            self.track.attach_frame(AttachedFrame(
                frame_id, timestamp, self.kf_id, mat, flow=flow,
                flow_without_rotation=flow_no_rot, rmse=0.0))
            return {"keyframe": False, "pose": pose}

        self._on_keyframe(frame_id)
        self.track.on_keyframe(frame_id, timestamp)
        self.num_keyframes += 1
        self.kf_id = frame_id
        ku = keyframe_update(self.window, self.immature, maps, pose.q, pose.t,
                             self.last_affine, frame_id, torch.tensor(self.min_distance, **d),
                             self.models, self.loop_config(), exp_t, mask=self.mask,
                             covariances=cfg.estimate_uncertainty)
        if cfg.estimate_uncertainty:
            self._record_connections(ku.batch["cov_ids"], ku.batch["cov_rel"])
        self.window, self.immature = ku.window, ku.immature
        self.depth_maps = (ku.depth_idepth, ku.depth_weight)
        self.level_points = list(ku.level_points)
        self.flow_points = ku.flow_points
        self.last_affine = ku.batch["new_affine"]
        self.min_distance = float(ku.min_distance)
        record_marginalized(self.track, ku.snap, timestamp, self._kf_semantics)
        return {"keyframe": True, "pose": pose, "energy": float(ku.batch["energy"])}

    def _record_connections(self, ids, cov_rel):
        """``track.connections`` for every ordered pair of live slots (ids ≥
        0) from ``cov_rel`` [K, K, 6, 6], in one host copy."""
        k = ids.shape[0]
        host = torch.cat([ids.to(torch.float64), cov_rel.to(torch.float64).reshape(-1)])
        host = host.cpu().numpy()
        ids, cov_rel = host[:k].astype(np.int64), host[k:].reshape(k, k, 6, 6)
        live = np.where(ids >= 0)[0]
        for i in live:
            for j in live:
                if i != j:
                    self.track.connections[(int(ids[i]), int(ids[j]))] = cov_rel[i, j]

    def _on_keyframe(self, frame_id):
        if self._last_semantics is not None:
            self._kf_semantics[frame_id] = self._last_semantics

    def initialize(self, frames):
        """Bootstrap from ``(frame_id, timestamp, image, pose)`` tuples; the
        last frame is forced to be a keyframe."""
        for i, (frame_id, timestamp, image, pose) in enumerate(frames):
            self.tick(frame_id, timestamp, image, known_pose=pose,
                      force_keyframe=(i == len(frames) - 1))
