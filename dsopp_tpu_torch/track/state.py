"""Odometry-track bookkeeping (counterpart of ``dsopp_tpu/track/state.py``):
marginalized keyframes with their final landmark snapshots, and attached
(non-key) frames for the full-rate trajectory.  Host numpy."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class AttachedFrame:
    """Non-keyframe tracked against its reference keyframe."""

    frame_id: int
    timestamp: float
    keyframe_id: int
    t_keyframe_frame: np.ndarray  # 4x4 keyframe → frame
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
