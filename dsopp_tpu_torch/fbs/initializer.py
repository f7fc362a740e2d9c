"""Monocular feature-based initializer (counterpart of
``dsopp_tpu/fbs/initializer.py``).

Per frame: the corners of the first frame are tracked with pyramidal LK
from the previous frame (``fbs/klt.py``, on the device the frames are on);
while a rotation-only RANSAC explains the flow the camera is taken to stand
still; once it moves, an essential-matrix RANSAC between the first and the
last frame, its decomposition and triangulation, PnP for the frames between,
and a geometric BA give camera-to-world poses T_wc (the monocular scale
arbitrary) of every frame held, which ``MonocularTracker.initialize`` takes.
It restarts when the tracks or the inliers collapse.

The images stay on their device; the tracked points come to the host once
a frame for the numpy geometry (``fbs/geometry.py``,
``fbs/geometric_ba.py``); the SO3×S2 refinement runs on the device in f64.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from dsopp_tpu_torch.fbs import klt
from dsopp_tpu_torch.fbs.geometric_ba import refine
from dsopp_tpu_torch.fbs.geometry import (AutocalibrationSelector, decompose_essential,
                                          ransac_essential, ransac_pnp, so3_inlier_ratio,
                                          so3xs2_refine, triangulate)


@dataclass
class InitializerOptions:
    """The bootstrap's options and their config keys (mono.yaml)."""

    num_features: int = 1000
    matcher: str = "lk"       # "lk" (the optical-flow chain); "orb" is not ported yet
    essential_ransac_threshold_px: float = 0.5   # at 1280×720 scale
    pnp_ransac_threshold_px: float = 1.0
    se3_inlier_ratio: float = 0.7
    pnp_inlier_ratio: float = 0.6
    min_parallax_px: float = 8.0
    sliding_window_length: int = 3
    min_frames: int = 5
    max_frames: int = 30
    reference_image_width: float = 1280.0
    reprojection_threshold_px: float = 2.0   # SO3×S2 Huber threshold
    autocalibrate: bool = False              # initializer_type: autocalibrated


@dataclass
class _TrackedFrame:
    frame_id: int
    timestamp: float
    points: np.ndarray      # [N, 2] pixel positions on the host (NaN = lost)
    image: torch.Tensor     # [H, W] u8 on the device


@dataclass
class MonocularInitializer:
    """Stateful bootstrap: feed frames until ``initialized``."""

    camera: object                       # Pinhole model (level 0)
    options: InitializerOptions = field(default_factory=InitializerOptions)

    frames: List[_TrackedFrame] = field(default_factory=list)
    poses: Optional[list] = None         # [(frame_id, ts, T_wc 4x4)] on success

    def __post_init__(self):
        if self.options.matcher == "orb":
            raise ValueError("matcher 'orb' (fbs/features.py, ORB descriptors) is not ported"
                             " yet; it waits for a later slice of the port: use 'lk'")

    @property
    def initialized(self) -> bool:
        return self.poses is not None

    # ------------------------------------------------------------------
    def _detect(self, image):
        return klt.good_features(image, self.options.num_features, 0.01, 8.0)

    def _track(self, prev_img, next_img, pts):
        valid_in = np.isfinite(pts[:, 0])
        out = np.full_like(pts, np.nan)
        if valid_in.sum() == 0:
            return out
        p0 = torch.as_tensor(pts[valid_in].astype(np.float32), device=next_img.device)
        p1, status = klt.pyr_lk(prev_img, next_img, p0, win=21, max_level=3)
        # the frame's one read of the tracks
        host = torch.cat([p1, status[:, None].to(p1.dtype)], 1).cpu().numpy()
        p1, status = host[:, :2].copy(), host[:, 2] != 0
        h, w = next_img.shape
        inside = (p1[:, 0] >= 0) & (p1[:, 0] < w) & (p1[:, 1] >= 0) & (p1[:, 1] < h)
        p1[~(status & inside)] = np.nan
        out[valid_in] = p1
        return out

    def _selector(self):
        if getattr(self, "selector", None) is None:
            self.selector = AutocalibrationSelector()
        return self.selector

    def _normalize(self, pts):
        fx = float(self.camera.fx)
        fy = float(self.camera.fy)
        override = getattr(self, "focal_override", None)
        if override is not None:
            fy = override * fy / fx   # keep the aspect ratio
            fx = override
        cx = float(self.camera.cx)
        cy = float(self.camera.cy)
        return np.stack([(pts[:, 0] - cx) / fx, (pts[:, 1] - cy) / fy], axis=1)

    def _threshold_norm(self, px):
        # thresholds are given in pixels at 1280-wide images
        scale = float(self.camera.width) / self.options.reference_image_width
        return px * scale / float(self.camera.fx)

    # ------------------------------------------------------------------
    def process(self, frame_id: int, timestamp: float, image) -> bool:
        """Feed one frame ([H, W] tensor); True once initialization finished."""
        image = klt.as_u8(torch.as_tensor(image))
        if not self.frames:
            pts = self._detect(image)
            self.frames.append(_TrackedFrame(frame_id, timestamp, pts, image))
            return False

        prev = self.frames[-1]
        pts = self._track(prev.image, image, prev.points)
        self.frames.append(_TrackedFrame(frame_id, timestamp, pts, image))

        first = self.frames[0]
        both = np.isfinite(first.points[:, 0]) & np.isfinite(pts[:, 0])
        if both.sum() < 30:
            self._restart(image, frame_id, timestamp)
            return False

        m1 = self._normalize(first.points[both])
        m2 = self._normalize(pts[both])

        # standstill: a rotation-only fit explains the flow
        ratio = so3_inlier_ratio(m1, m2, self._threshold_norm(3.0))
        parallax_px = np.median(np.linalg.norm(pts[both] - first.points[both], axis=1))
        moving = (ratio < self.options.se3_inlier_ratio
                  and parallax_px > self.options.min_parallax_px)

        if len(self.frames) >= self.options.max_frames and not moving:
            self._restart(image, frame_id, timestamp)
            return False
        if not moving or len(self.frames) < self.options.min_frames:
            return False

        return self._finish()

    def _restart(self, image, frame_id, timestamp):
        pts = self._detect(image)
        self.frames = [_TrackedFrame(frame_id, timestamp, pts, image)]

    # ------------------------------------------------------------------
    def _finish(self) -> bool:
        first = self.frames[0]
        last = self.frames[-1]
        both = np.isfinite(first.points[:, 0]) & np.isfinite(last.points[:, 0])
        m1 = self._normalize(first.points[both])
        m2 = self._normalize(last.points[both])

        e, inliers = ransac_essential(
            m1, m2, self._threshold_norm(self.options.essential_ransac_threshold_px * 4))
        if e is None or inliers.sum() < 20:
            self._restart(last.image, last.frame_id, last.timestamp)
            return False

        r, t, pts3d_in, front = decompose_essential(e, m1[inliers], m2[inliers])
        if front.sum() < 15:
            self._restart(last.image, last.frame_id, last.timestamp)
            return False

        # SO3×S2 Sampson refinement of the essential estimate, with the focal
        # length too when autocalibrating (the selector's consensus)
        pp = np.array([float(self.camera.cx), float(self.camera.cy)])
        pc1 = first.points[both][inliers] - pp
        pc2 = last.points[both][inliers] - pp
        r, t, f_new, _rms = so3xs2_refine(
            pc1, pc2, r, t, float(self.camera.fx), self.options.reprojection_threshold_px,
            optimize_focal=self.options.autocalibrate, device=last.image.device)
        if self.options.autocalibrate:
            self._selector().add_result(f_new)
            self.focal_override = self._selector().get_focal_length()
            # re-normalize with the consensus focal before triangulation
            m1 = self._normalize(first.points[both])
            m2 = self._normalize(last.points[both])
        pts3d_in, front = triangulate(r, t, m1[inliers], m2[inliers])
        if front.sum() < 15:
            self._restart(last.image, last.frame_id, last.timestamp)
            return False

        # landmark table in the first camera's frame
        track_idx = np.where(both)[0][inliers][front]
        points3d = pts3d_in[front]
        # scale: median depth in the first frame = 2
        depth_scale = 2.0 / np.median(points3d[:, 2])
        points3d = points3d * depth_scale
        t = t * depth_scale

        f = len(self.frames)
        poses_r = np.tile(np.eye(3), (f, 1, 1))
        poses_t = np.zeros((f, 3))
        poses_r[-1] = r
        poses_t[-1] = t

        # PnP for the frames between
        pnp_thr = self._threshold_norm(self.options.pnp_ransac_threshold_px * 4)
        for i in range(1, f - 1):
            fi = self.frames[i]
            vis = np.isfinite(fi.points[track_idx, 0])
            if vis.sum() < 10:
                # fall back: interpolate along the segment
                alpha = i / (f - 1)
                poses_r[i] = np.eye(3)
                poses_t[i] = alpha * t
                continue
            m = self._normalize(fi.points[track_idx][vis])
            ri, ti, inl = ransac_pnp(points3d[vis], m, pnp_thr)
            if ri is None or inl.sum() < max(6, self.options.pnp_inlier_ratio * vis.sum() * 0.5):
                alpha = i / (f - 1)
                poses_r[i] = np.eye(3)
                poses_t[i] = alpha * t
            else:
                poses_r[i] = ri
                poses_t[i] = ti

        # geometric BA over all frames and points
        obs_f, obs_p, obs_m = [], [], []
        for i, fr in enumerate(self.frames):
            vis = np.isfinite(fr.points[track_idx, 0])
            idx = np.where(vis)[0]
            if idx.size == 0:
                continue
            obs_f.append(np.full(idx.size, i))
            obs_p.append(idx)
            obs_m.append(self._normalize(fr.points[track_idx][idx]))
        obs_f = np.concatenate(obs_f)
        obs_p = np.concatenate(obs_p)
        obs_m = np.concatenate(obs_m)

        # pixel observations kept for the calibration refinement
        # (--refine_calibration → geometric_ba.refine_intrinsics)
        obs_px = np.concatenate([
            fr.points[track_idx][np.isfinite(fr.points[track_idx, 0])]
            for fr in self.frames
            if np.isfinite(fr.points[track_idx, 0]).any()])

        poses_r, poses_t, points3d, rms = refine(
            poses_r, poses_t, points3d, obs_f, obs_p, obs_m, huber=self._threshold_norm(2.0))
        self.calib_data = (poses_r.copy(), poses_t.copy(), points3d.copy(),
                           obs_f, obs_p, obs_px)

        # world = the first camera; T_wc = the inverse of world → camera
        poses = []
        for i, fr in enumerate(self.frames):
            rwc = poses_r[i].T
            twc = -rwc @ poses_t[i]
            mat = np.eye(4)
            mat[:3, :3] = rwc
            mat[:3, 3] = twc
            poses.append((fr.frame_id, fr.timestamp, mat))
        self.poses = poses
        return True
