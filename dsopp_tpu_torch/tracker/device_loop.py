"""Per-frame tracking loop (counterpart of ``dsopp_tpu/tracker/device_loop.py``).

``device_tick`` runs one frame: the regular tick (pyramid, hypothesis
alignment, epipolar update, flow statistic), the frontend reliability gate
and the keyframe decision; then, on a keyframe, the backend: push,
activation, windowed BA, marginalization policy and ledger fold, and the
rebuild of the frontend depth maps.

The keyframe decision is read on the host once per frame (a Python ``if``
in place of the reference's ``lax.cond``), as is the escalation flag of the
perturbation re-track; every other per-frame value stays on the device.
:class:`PipelinedTracker` queues the per-frame diagnostics and folds them
into the host track every ``flush_every`` frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.solvers.pba import PBAOptions, Window, _marginalize_device, newest_slot
from dsopp_tpu_torch.solvers.pose_alignment import AlignmentOptions
from dsopp_tpu_torch.track.state import AttachedFrame, MarginalizedKeyframe, sample_semantics
from dsopp_tpu_torch.tracker.activation import MAX_DISTANCE, MIN_DISTANCE, P_GAIN
from dsopp_tpu_torch.tracker.depth_estimation import ImmaturePoints
from dsopp_tpu_torch.tracker.depth_map import (KEYFRAME_THRESHOLD, MAX_EXCESS_ENERGY,
                                               MAX_SHIFT_NO_ROT_WEIGHT, MAX_SHIFT_WEIGHT,
                                               build_frontend_state)
from dsopp_tpu_torch.tracker.fused_keyframe import fused_keyframe_push
from dsopp_tpu_torch.tracker.fused_tick import ENERGY_RATIO_THRESHOLD, fused_regular_tick
from dsopp_tpu_torch.tracker.marginalization import flags_device


class DeviceLoopConfig(NamedTuple):
    align_opts: AlignmentOptions
    pba_opts: PBAOptions
    num_levels: int
    with_perturbations: bool
    huber_sigma: float
    refine: bool
    immature_per_frame: int
    frontend_points: int
    desired_points: float
    keyframe_factor: float
    window_min: int
    window_max: int
    max_marg_fraction: float
    height: int
    width: int


class DeviceTrackerState(NamedTuple):
    window: Window
    immature: ImmaturePoints    # [K, N] banks
    depth_idepth: tuple         # per-level [H_l, W_l]
    depth_weight: tuple
    level_points: tuple         # per-level LevelPoints
    flow_points: object         # compact flow-statistic LevelPoints
    last_q: torch.Tensor
    last_t: torch.Tensor
    prev_q: torch.Tensor
    prev_t: torch.Tensor
    last_affine: torch.Tensor   # [2]
    rmse_last0: torch.Tensor    # frontend re-track ledger
    kf_rmse: torch.Tensor       # keyframe-strategy rmse memory (−1 = unset)
    min_distance: torch.Tensor  # activation density controller


class TickDiag(NamedTuple):
    """Per-frame diagnostics (host bookkeeping only); keyframe-path fields
    are zeros on regular frames."""

    is_keyframe: bool
    escalated: bool
    rmse_chunk0: torch.Tensor   # the rmse the re-track gate tested
    pose_q: torch.Tensor
    pose_t: torch.Tensor
    affine: torch.Tensor
    rmse: torch.Tensor
    flow: torch.Tensor
    flow_no_rot: torch.Tensor
    num_valid_align: torch.Tensor
    t_kf_frame_mat: torch.Tensor
    energy: torch.Tensor
    num_valid_solve: torch.Tensor
    n_active: torch.Tensor
    n_activated: torch.Tensor
    min_distance: torch.Tensor
    frame_flags: torch.Tensor   # [K] (pre-permutation slots)
    kf_frame_id: torch.Tensor   # [K]
    kf_poses_mat: torch.Tensor  # [K, 4, 4]
    kf_affine: torch.Tensor     # [K, 2]
    kf_exposure: torch.Tensor   # [K]
    lm_uv: torch.Tensor         # [K, N, 2]
    lm_idepth: torch.Tensor     # [K, N]
    lm_valid: torch.Tensor      # [K, N]
    lm_outlier: torch.Tensor    # [K, N]
    lm_baseline: torch.Tensor   # [K, N]


class KeyframeUpdate(NamedTuple):
    window: Window
    immature: ImmaturePoints
    depth_idepth: tuple
    depth_weight: tuple
    level_points: tuple
    flow_points: object
    min_distance: torch.Tensor
    batch: dict
    snap: dict


def keyframe_update(window: Window, immature: ImmaturePoints, maps, pose_q, pose_t,
                    affine, frame_id: int, min_distance, models,
                    cfg: DeviceLoopConfig, exposure, mask=None) -> KeyframeUpdate:
    """The keyframe backend shared by ``device_tick`` and the bootstrap.
    ``mask``: [H, W] bool candidate-selection mask or None."""
    dtype = window.eps.dtype
    kf = fused_keyframe_push(window, models[0], immature, maps[0], pose_q, pose_t,
                             affine, frame_id, min_distance, cfg.pba_opts, cfg.refine,
                             cfg.huber_sigma, cfg.immature_per_frame, exposure, mask=mask)
    win, immature, batch = kf.window, kf.immature, kf.batch
    min_distance = torch.clamp(
        min_distance + (batch["n_active"].to(dtype) - cfg.desired_points) * P_GAIN,
        MIN_DISTANCE, MAX_DISTANCE)
    imm_counts = torch.sum(immature.valid, dim=1)
    frame_flags, lm_flags, new_outliers, perm = flags_device(
        win, imm_counts, cfg.window_min, cfg.window_max, cfg.max_marg_fraction)
    snap = dict(frame_flags=frame_flags, kf_frame_id=win.frame_id,
                kf_poses_mat=batch["poses_mat"], kf_affine=win.affine(),
                kf_exposure=win.exposure, lm_uv=win.lm_uv, lm_idepth=win.lm_idepth,
                lm_valid=win.lm_valid, lm_outlier=win.lm_outlier,
                lm_baseline=win.lm_baseline)
    win = win.replace(lm_outlier=win.lm_outlier | new_outliers,
                      frame_marg=frame_flags, lm_marg_flag=lm_flags)
    win = _marginalize_device(win, models[0], perm, cfg.pba_opts)
    immature = ImmaturePoints(*(x[perm] for x in immature))
    immature = immature._replace(valid=immature.valid & win.frame_valid[:, None])
    idep, wei, points, flow_pts = build_frontend_state(
        win, models[0], maps, cfg.height, cfg.width, cfg.num_levels, cfg.frontend_points)
    return KeyframeUpdate(win, immature, idep, wei, points, flow_pts, min_distance,
                          batch, snap)


_SNAP_KEYS = ("kf_frame_id", "kf_poses_mat", "kf_affine", "kf_exposure", "lm_uv",
              "lm_idepth", "lm_valid", "lm_outlier", "lm_baseline")


def record_marginalized(track, snap: dict, timestamp: float, kf_semantics=None):
    """Move the keyframes flagged in ``snap["frame_flags"]`` (pre-fold
    window snapshot, tensors) into the track's history.  ``kf_semantics``:
    keyframe id → its class-id image; a marginalized keyframe's image leaves
    the dict and labels its landmarks."""
    flags = snap["frame_flags"].cpu().numpy()
    if not flags.any():
        return
    host = {k: snap[k].cpu().numpy() for k in _SNAP_KEYS}
    for pos in np.where(flags)[0]:
        fid = int(host["kf_frame_id"][pos])
        sem_img = None if kf_semantics is None else kf_semantics.pop(fid, None)
        track.on_marginalize(MarginalizedKeyframe(
            frame_id=fid, timestamp=track.keyframe_timestamps.get(fid, timestamp),
            t_wc=host["kf_poses_mat"][pos].astype(np.float64),
            affine=host["kf_affine"][pos].astype(np.float64),
            exposure=float(host["kf_exposure"][pos]), lm_uv=host["lm_uv"][pos],
            lm_idepth=host["lm_idepth"][pos], lm_valid=host["lm_valid"][pos],
            lm_outlier=host["lm_outlier"][pos], lm_baseline=host["lm_baseline"][pos],
            lm_semantic=(None if sem_img is None
                         else sample_semantics(sem_img, host["lm_uv"][pos]))))


def _frontend_core(state: DeviceTrackerState, image, force_kf: bool, models,
                   cfg: DeviceLoopConfig, exposure):
    window = state.window
    poses = window.poses()
    out = fused_regular_tick(
        image, state.level_points, state.flow_points, poses.q, poses.t,
        window.affine(), window.exposure, exposure, newest_slot(window),
        state.immature, state.last_q, state.last_t, state.prev_q, state.prev_t,
        state.last_affine, models, cfg.align_opts, cfg.with_perturbations,
        cfg.num_levels, cfg.huber_sigma, state.rmse_last0)

    rmse = out.rmse
    reliable = (rmse < ENERGY_RATIO_THRESHOLD * state.rmse_last0) & (out.num_valid > 0)
    rmse_last0 = torch.where(reliable, rmse, state.rmse_last0 * ENERGY_RATIO_THRESHOLD)
    kf_rmse_eff = torch.where(state.kf_rmse < 0, rmse, state.kf_rmse)
    need_strategy = (
        (cfg.keyframe_factor * (MAX_SHIFT_WEIGHT * out.flow
                                + MAX_SHIFT_NO_ROT_WEIGHT * out.flow_no_rot)
         > KEYFRAME_THRESHOLD)
        | (rmse / torch.clamp(kf_rmse_eff, min=1e-12) > MAX_EXCESS_ENERGY)
    ) & reliable
    if force_kf:
        kf_rmse, need_kf = state.kf_rmse, True
    else:
        kf_rmse = torch.where(need_strategy, torch.full_like(kf_rmse_eff, -1.0), kf_rmse_eff)
        need_kf = bool(need_strategy)

    t_w_t = SE3(out.pose_q, out.pose_t)
    t_prev_rel = SE3(state.last_q, state.last_t).inverse() @ t_w_t
    base = state._replace(immature=out.immature, last_q=t_w_t.q, last_t=t_w_t.t,
                          prev_q=t_prev_rel.q, prev_t=t_prev_rel.t,
                          last_affine=out.affine, rmse_last0=rmse_last0,
                          kf_rmse=kf_rmse)
    return base, need_kf, out


def _backend_core(base: DeviceTrackerState, out, need_kf: bool, frame_id: int,
                  models, cfg: DeviceLoopConfig, exposure, mask=None):
    dtype = base.last_affine.dtype
    dev = base.last_affine.device
    front = dict(is_keyframe=need_kf, escalated=out.escalated,
                 rmse_chunk0=out.rmse_chunk0, pose_q=out.pose_q,
                 pose_t=out.pose_t, affine=out.affine, rmse=out.rmse, flow=out.flow,
                 flow_no_rot=out.flow_no_rot, num_valid_align=out.num_valid,
                 t_kf_frame_mat=out.t_kf_frame_mat)
    if not need_kf:
        win = base.window
        k, n = win.num_slots, win.num_landmark_slots
        z = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        diag = TickDiag(
            **front, energy=z(()), num_valid_solve=z((), torch.int32),
            n_active=z((), torch.int64), n_activated=z((), torch.int64),
            min_distance=base.min_distance, frame_flags=z((k,), torch.bool),
            kf_frame_id=z((k,), torch.int32), kf_poses_mat=z((k, 4, 4)),
            kf_affine=z((k, 2)), kf_exposure=z((k,)), lm_uv=z((k, n, 2)),
            lm_idepth=z((k, n)), lm_valid=z((k, n), torch.bool),
            lm_outlier=z((k, n), torch.bool), lm_baseline=z((k, n)))
        return base, diag

    ku = keyframe_update(base.window, base.immature, out.maps, out.pose_q, out.pose_t,
                         out.affine, frame_id, base.min_distance, models, cfg, exposure,
                         mask=mask)
    st = base._replace(window=ku.window, immature=ku.immature,
                       depth_idepth=ku.depth_idepth, depth_weight=ku.depth_weight,
                       level_points=ku.level_points, flow_points=ku.flow_points,
                       min_distance=ku.min_distance,
                       last_affine=ku.batch["new_affine"])
    b = ku.batch
    diag = TickDiag(**front, energy=b["energy"], num_valid_solve=b["num_valid"],
                    n_active=b["n_active"], n_activated=b["n_activated"],
                    min_distance=ku.min_distance, **ku.snap)
    return st, diag


def device_tick(state: DeviceTrackerState, image, frame_id: int, force_kf: bool,
                models, cfg: DeviceLoopConfig, exposure=1.0, mask=None):
    """One tracked frame → (state', diag).  ``mask``: [H, W] bool
    candidate-selection mask (the sensor's CameraMask) or None for all-valid;
    it reaches the candidate selection of a keyframe and nothing else."""
    exposure = torch.full((), float(exposure), dtype=image.dtype, device=image.device)
    base, need_kf, front = _frontend_core(state, image, force_kf, models, cfg, exposure)
    return _backend_core(base, front, need_kf, frame_id, models, cfg, exposure, mask=mask)


class PipelinedTracker:
    """Host driver of the loop around an initialized
    :class:`~dsopp_tpu_torch.tracker.monocular.MonocularTracker`: one
    ``device_tick`` per frame, diagnostics folded into the host track every
    ``flush_every`` frames; ``finalize`` writes the state back."""

    def __init__(self, tracker, flush_every: int = 16):
        if tracker.level_points is None or tracker.t_w_last is None:
            raise ValueError("tracker must be initialized (≥2 keyframes)")
        cfgt = tracker.config
        if cfgt.num_frame_slots < cfgt.window_max + 2:
            raise ValueError("the loop needs num_frame_slots ≥ window_max+2")
        self.tracker = tracker
        self.dtype = tracker.dtype
        self.device = tracker.device
        self.models = tuple(tracker.models)
        self.cfg = tracker.loop_config()
        self.mask = tracker.mask
        d = dict(dtype=self.dtype, device=self.device)
        self.state = DeviceTrackerState(
            window=tracker.window, immature=tracker.immature,
            depth_idepth=tuple(tracker.depth_maps[0]),
            depth_weight=tuple(tracker.depth_maps[1]),
            level_points=tuple(tracker.level_points), flow_points=tracker.flow_points,
            last_q=tracker.t_w_last.q, last_t=tracker.t_w_last.t,
            prev_q=tracker.t_prev_rel.q, prev_t=tracker.t_prev_rel.t,
            last_affine=tracker.last_affine,
            rmse_last0=torch.tensor(tracker.rmse_last[0], **d),
            kf_rmse=torch.tensor(tracker.kf_rmse, **d),
            min_distance=torch.tensor(tracker.min_distance, **d))
        self.cur_kf = tracker.kf_id
        self.num_keyframes = tracker.num_keyframes
        self.flush_every = flush_every
        self.pending = []
        # semantics bookkeeping on the host: per pending frame until its
        # keyframe flag is read, then per keyframe until it is marginalized
        self._sem_pending = {}
        self._kf_semantics = dict(tracker._kf_semantics)

    def tick(self, frame_id: int, timestamp: float, image,
             force_keyframe: bool = False, semantics=None, exposure: float = 1.0):
        """One tracked frame.  ``semantics``: optional [H, W] class-id image
        (numpy): the tracker's ``semantic_filter`` classes leave the
        candidate mask, and the ids label the landmarks of the frame, should
        it become a keyframe, when it is marginalized.  ``exposure``: the
        frame's exposure time."""
        if semantics is not None:
            self._sem_pending[frame_id] = np.asarray(semantics)
            if self.tracker.semantic_filter:
                self.mask = self.tracker.semantic_mask(semantics)
        image = torch.as_tensor(image, dtype=self.dtype, device=self.device)
        self.state, diag = device_tick(self.state, image, int(frame_id),
                                       bool(force_keyframe), self.models, self.cfg,
                                       exposure=float(exposure), mask=self.mask)
        self.pending.append((frame_id, timestamp, diag))
        if len(self.pending) >= self.flush_every:
            self.drain()
        return diag

    def drain(self):
        """Fold the queued diagnostics into the host track."""
        pending, self.pending = self.pending, []
        for fid, ts, d in pending:
            self._bookkeep(fid, ts, d)

    def _bookkeep(self, fid, ts, d: TickDiag):
        track = self.tracker.track
        sem = self._sem_pending.pop(fid, None)
        if d.is_keyframe:
            track.on_keyframe(fid, ts)
            self.cur_kf = fid
            self.num_keyframes += 1
            if sem is not None:
                self._kf_semantics[fid] = sem
            record_marginalized(track, d._asdict(), ts, self._kf_semantics)
        else:
            track.attach_frame(AttachedFrame(
                fid, ts, self.cur_kf, d.t_kf_frame_mat.cpu().numpy().astype(np.float64),
                flow=float(d.flow), flow_without_rotation=float(d.flow_no_rot),
                rmse=float(d.rmse)))

    def finalize(self):
        """Flush the bookkeeping and write the state back into the tracker."""
        self.drain()
        t, st = self.tracker, self.state
        t.window = st.window
        t.immature = st.immature
        t.depth_maps = (st.depth_idepth, st.depth_weight)
        t.level_points = list(st.level_points)
        t.flow_points = st.flow_points
        t.t_w_last = SE3(st.last_q, st.last_t)
        t.t_prev_rel = SE3(st.prev_q, st.prev_t)
        t.last_affine = st.last_affine
        t.rmse_last[0] = float(st.rmse_last0)
        t.kf_rmse = float(st.kf_rmse)
        t.min_distance = float(st.min_distance)
        t.num_keyframes = self.num_keyframes
        t.kf_id = self.cur_kf
        t.mask = self.mask
        t._kf_semantics = dict(self._kf_semantics)
        return t

