"""Odometry-track bookkeeping (counterpart of ``dsopp_tpu/track/state.py``):
marginalized keyframes with their final landmark snapshots, and attached
(non-key) frames for the full-rate trajectory.  Host numpy."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class AttachedFrame:
    """Non-keyframe tracked against its reference keyframe."""

    frame_id: int
    timestamp: float
    keyframe_id: int
    t_keyframe_frame: np.ndarray  # 4x4 keyframe → frame
    exposure: float = 1.0
    affine: np.ndarray = field(default_factory=lambda: np.zeros(2))
    flow: float = 0.0
    flow_without_rotation: float = 0.0
    rmse: float = 0.0


@dataclass
class MarginalizedKeyframe:
    """Keyframe dropped from the active window (final state snapshot)."""

    frame_id: int
    timestamp: float
    t_wc: np.ndarray
    affine: np.ndarray
    exposure: float
    lm_uv: np.ndarray
    lm_idepth: np.ndarray
    lm_valid: np.ndarray
    lm_outlier: np.ndarray
    lm_baseline: np.ndarray
    attached: List[AttachedFrame] = field(default_factory=list)
    # per-landmark class id, sampled from the keyframe's own class-id image
    # when it is marginalized
    lm_semantic: Optional[np.ndarray] = None  # [M] int


def sample_semantics(semantic_image, uv):
    """Nearest-pixel class ids at ``uv`` [M, 2] from a [H, W] id image."""
    sem = np.asarray(semantic_image)
    h, w = sem.shape
    u = np.clip(np.rint(np.asarray(uv)[:, 0]).astype(int), 0, w - 1)
    v = np.clip(np.rint(np.asarray(uv)[:, 1]).astype(int), 0, h - 1)
    return sem[v, u].astype(np.int64)


@dataclass
class OdometryTrack:
    marginalized: List[MarginalizedKeyframe] = field(default_factory=list)
    attached: dict = field(default_factory=dict)
    keyframe_timestamps: dict = field(default_factory=dict)

    def attach_frame(self, frame: AttachedFrame):
        self.attached.setdefault(frame.keyframe_id, []).append(frame)

    def on_keyframe(self, frame_id: int, timestamp: float):
        self.keyframe_timestamps[frame_id] = timestamp

    def on_marginalize(self, kf: MarginalizedKeyframe):
        kf.attached = self.attached.pop(kf.frame_id, [])
        self.marginalized.append(kf)

    def trajectory(self, window=None):
        """Full-rate (timestamp, T_wc 4x4) list: marginalized + active
        keyframes (the window's BA-refined poses) with their attached frames,
        time-ordered."""
        entries = []

        def add_keyframe(timestamp, t_wc, attached):
            entries.append((timestamp, t_wc))
            for a in attached:
                entries.append((a.timestamp, t_wc @ a.t_keyframe_frame))

        for kf in self.marginalized:
            add_keyframe(kf.timestamp, kf.t_wc, kf.attached)
        if window is not None:
            mats = window.poses().matrix().cpu().numpy().astype(np.float64)
            ids = window.frame_id.cpu().numpy()
            for pos in range(int(window.frame_valid.sum())):
                fid = int(ids[pos])
                add_keyframe(self.keyframe_timestamps.get(fid, 0.0), mats[pos],
                             self.attached.get(fid, []))
        entries.sort(key=lambda e: e[0])
        return entries
