"""Track sanity checking (counterpart of ``dsopp_tpu/sanity_checker.py``, a
numpy copy of it): kinematic plausibility gates of a camera on a car-like
(Ackermann) vehicle over consecutive keyframe poses, one status a keyframe
index, the first violation winning, and the ``sanity_checker:`` config
section's fabric.

Poses are T_w_c (camera to world, 4x4); the camera's forward axis is +z and
its up axis −y by default; gravity's reference direction is taken from the
first checked keyframe, so a tilted mount does not trip the gravity
gates."""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, Optional

import numpy as np

log = logging.getLogger(__name__)


class SanityCheckStatus(IntEnum):
    """Violation kinds (sanity_check_status.hpp:6-13; proto values match
    sanity_check_status.proto)."""

    EXCEEDED_GRAVITY_ANGLE = 0
    EXCEEDED_GRAVITY_ANGULAR_VELOCITY = 1
    EXCEEDED_ROTATION_ANGLE = 2
    EXCEEDED_ROTATION_ANGULAR_VELOCITY = 3
    EXCEEDED_TRANSLATION_ERROR = 4


class SanityChecker:
    """Interface (sanity_checker.hpp:14-25): ``check`` inspects the track
    and returns True when it passes; violations are accumulated in
    ``results`` as {keyframe index → status}."""

    def __init__(self):
        self.results: Dict[int, SanityCheckStatus] = {}

    def check(self, keyframes) -> bool:
        """``keyframes``: ordered [(frame_index, timestamp, t_wc 4x4), ...]
        covering the whole track so far.  Returns True if sane."""
        raise NotImplementedError


def _rotation_angle(r: np.ndarray) -> float:
    """Geodesic angle of a rotation matrix."""
    c = (np.trace(r) - 1.0) * 0.5
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


@dataclass
class AckermannOptions:
    """Thresholds for car-like (Ackermann steering) motion."""

    max_gravity_angle: float = math.radians(30.0)
    max_gravity_angular_velocity: float = math.radians(45.0)   # rad/s
    max_rotation_angle: float = math.radians(35.0)             # per keyframe gap
    max_rotation_angular_velocity: float = math.radians(90.0)  # rad/s
    # max angle between body-frame translation and the forward axis
    # (a car cannot translate sideways): slip cone half-angle
    max_slip_angle: float = math.radians(30.0)
    min_translation: float = 1e-3   # below this the slip test is skipped
    forward_axis: np.ndarray = field(
        default_factory=lambda: np.asarray([0.0, 0.0, 1.0]))
    up_axis: np.ndarray = field(
        default_factory=lambda: np.asarray([0.0, -1.0, 0.0]))


class AckermannSanityChecker(SanityChecker):
    """Kinematic plausibility gates for a camera rigidly mounted on a
    car-like vehicle.  One status per keyframe index, first violation wins
    (matching the reference's map<frame_index, status> storage)."""

    def __init__(self, options: AckermannOptions = AckermannOptions()):
        super().__init__()
        self.options = options
        self._gravity_ref: Optional[np.ndarray] = None  # body-frame gravity
        self._last_checked: int = 0        # number of keyframes consumed
        self._prev: Optional[tuple] = None  # (index, timestamp, t_wc)
        self._prev_gravity_angle: float = 0.0

    def check(self, keyframes) -> bool:
        ok = True
        opt = self.options
        for entry in keyframes[self._last_checked:]:
            idx, ts, t_wc = entry
            t_wc = np.asarray(t_wc, np.float64)
            r_wc = t_wc[:3, :3]

            # body-frame gravity direction: world "down" seen by the camera
            down_world = -self._world_up(keyframes)
            g_body = r_wc.T @ down_world
            if self._gravity_ref is None:
                self._gravity_ref = g_body
            cosg = float(np.clip(np.dot(g_body, self._gravity_ref), -1, 1))
            gravity_angle = math.acos(cosg)

            status = None
            if gravity_angle > opt.max_gravity_angle:
                status = SanityCheckStatus.EXCEEDED_GRAVITY_ANGLE

            if self._prev is not None:
                pidx, pts, pt_wc = self._prev
                dt = max(float(ts) - float(pts), 1e-9)
                r_rel = pt_wc[:3, :3].T @ r_wc
                ang = _rotation_angle(r_rel)

                if status is None and (
                        abs(gravity_angle - self._prev_gravity_angle) / dt
                        > opt.max_gravity_angular_velocity):
                    status = SanityCheckStatus.EXCEEDED_GRAVITY_ANGULAR_VELOCITY
                if status is None and ang > opt.max_rotation_angle:
                    status = SanityCheckStatus.EXCEEDED_ROTATION_ANGLE
                if status is None and ang / dt > opt.max_rotation_angular_velocity:
                    status = (
                        SanityCheckStatus.EXCEEDED_ROTATION_ANGULAR_VELOCITY)

                # translation in the PREVIOUS body frame must lie inside the
                # slip cone around ±forward (reverse driving is legal)
                t_rel = pt_wc[:3, :3].T @ (t_wc[:3, 3] - pt_wc[:3, 3])
                norm = float(np.linalg.norm(t_rel))
                if status is None and norm > opt.min_translation:
                    cosf = abs(float(np.dot(t_rel / norm, opt.forward_axis)))
                    if math.acos(np.clip(cosf, 0.0, 1.0)) > opt.max_slip_angle:
                        status = SanityCheckStatus.EXCEEDED_TRANSLATION_ERROR

            if status is not None:
                self.results[int(idx)] = status
                ok = False
            self._prev = (idx, ts, t_wc)
            self._prev_gravity_angle = gravity_angle
            self._last_checked += 1
        return ok

    def _world_up(self, keyframes) -> np.ndarray:
        """World up from the FIRST keyframe's mounted up axis (so the checker
        is invariant to the arbitrary world frame of monocular odometry)."""
        cached = getattr(self, "_world_up_cache", None)
        if cached is None:
            r0 = np.asarray(keyframes[0][2], np.float64)[:3, :3]
            cached = r0 @ np.asarray(self.options.up_axis, np.float64)
            self._world_up_cache = cached
        return cached


def _load_extrinsic_axes(path: str):
    """Read a T_camera_vehicle extrinsic (the reference's
    ``t_camera_rear_roll_center`` file, mono.yaml:77): whitespace-separated
    12 or 16 numbers (3x4 / 4x4 row-major).  Vehicle frame: x forward,
    z up → returns the camera-frame (forward, up) axes."""
    vals = np.loadtxt(path).reshape(-1)
    if vals.size == 16:
        r = vals.reshape(4, 4)[:3, :3]
    elif vals.size == 12:
        r = vals.reshape(3, 4)[:3, :3]
    else:
        raise ValueError(f"extrinsic file needs 12 or 16 numbers, got {vals.size}")
    return r @ np.asarray([1.0, 0.0, 0.0]), r @ np.asarray([0.0, 0.0, 1.0])


def create_sanity_checker(parameters: Optional[dict],
                          base_dir: str = ".") -> Optional[SanityChecker]:
    """YAML fabric (fabric.cpp:18-40): ``mode: on`` + ``type: ackermann``.
    Unknown types and ``mode: off`` return None (checker disabled)."""
    if not parameters:
        return None
    if str(parameters.get("mode", "off")).lower() != "on":
        log.warning("Sanity checker is disabled")
        return None
    ctype = parameters.get("type")
    if ctype != "ackermann":
        log.error("Inappropriate type for sanity checker: %r", ctype)
        return None

    opt = AckermannOptions()
    extr = parameters.get("t_camera_rear_roll_center")
    if extr:
        import os

        path = extr if os.path.isabs(extr) else f"{base_dir}/{extr}"
        try:
            opt.forward_axis, opt.up_axis = _load_extrinsic_axes(path)
        except OSError:
            log.warning("extrinsic file %s missing; using default axes", path)
    deg = math.radians
    if "max_gravity_angle_deg" in parameters:
        opt.max_gravity_angle = deg(float(parameters["max_gravity_angle_deg"]))
    if "max_gravity_angular_velocity_deg" in parameters:
        opt.max_gravity_angular_velocity = deg(
            float(parameters["max_gravity_angular_velocity_deg"]))
    if "max_rotation_angle_deg" in parameters:
        opt.max_rotation_angle = deg(float(parameters["max_rotation_angle_deg"]))
    if "max_rotation_angular_velocity_deg" in parameters:
        opt.max_rotation_angular_velocity = deg(
            float(parameters["max_rotation_angular_velocity_deg"]))
    if "max_slip_angle_deg" in parameters:
        opt.max_slip_angle = deg(float(parameters["max_slip_angle_deg"]))
    return AckermannSanityChecker(opt)
