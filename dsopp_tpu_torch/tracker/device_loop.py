"""Per-frame tracking loop (counterpart of ``dsopp_tpu/tracker/device_loop.py``).

``device_tick`` runs one frame: the regular tick (pyramid, hypothesis
alignment, epipolar update, flow statistic), the frontend reliability gate
and the keyframe decision; then, on a keyframe, the backend: push,
activation, windowed BA, marginalization policy and ledger fold, and the
rebuild of the frontend depth maps.

The keyframe decision is read on the host once per frame (a Python ``if``
in place of the reference's ``lax.cond``): one copy of K5's packed
statistics, which also carries what the host's bookkeeping of a regular
frame reads.  The escalation flag of the perturbation re-track is read too;
every other per-frame value stays on the device.
:class:`PipelinedTracker` queues the per-frame diagnostics and folds them
into the host track every ``flush_every`` frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features.embedder import make_embedder
from dsopp_tpu_torch.solvers.pba import (PBAOptions, Window, _as_stack, _device_sequences,
                                         marginalize_sequences, newest_slot, pose_covariances,
                                         slot_rows, solve_loop_sequences, take_slots,
                                         window_at, with_sequences)
from dsopp_tpu_torch.solvers.pose_alignment import AlignmentOptions
from dsopp_tpu_torch.track.state import AttachedFrame, MarginalizedKeyframe, sample_semantics
from dsopp_tpu_torch.tracker.activation import MAX_DISTANCE, MIN_DISTANCE, P_GAIN
from dsopp_tpu_torch.tracker.depth_estimation import ImmaturePoints
from dsopp_tpu_torch.tracker.depth_map import (STAT_FLOW, STAT_FLOW_NO_ROT, STAT_KF_RMSE,
                                               STAT_MATRIX, STAT_NEED, STAT_RMSE,
                                               STAT_RMSE_LAST0, build_frontend_state_sequences)
from dsopp_tpu_torch.tracker.fused_keyframe import keyframe_front_sequences
from dsopp_tpu_torch.tracker.fused_tick import fused_regular_tick
from dsopp_tpu_torch.tracker.marginalization import flags_sequences


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
    embedder: str = "identity"   # frame-embedder kind ("identity" = C = 1)


@functools.lru_cache(maxsize=None)
def _embedder(name: str):
    """One embedder per kind: its filter bank moves to the card once."""
    return make_embedder(name)


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
    host_stats: object = None   # the frame's K5 statistics on the host (numpy, STAT_*),
    #                             None on a forced keyframe


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


def keyframe_embeddings(images, cfg: DeviceLoopConfig):
    """The frame-embedder channels [S, C, H, W] of S keyframes' intensity
    images [S, H, W] for the window's channel bank, one convolution (None
    with the identity embedder: C = 1)."""
    return None if cfg.embedder == "identity" else _embedder(cfg.embedder)(images)


def keyframe_update(window: Window, immature: ImmaturePoints, maps, pose_q, pose_t,
                    affine, frame_id: int, min_distance, models,
                    cfg: DeviceLoopConfig, exposure, mask=None,
                    covariances: bool = False) -> KeyframeUpdate:
    """The keyframe backend shared by ``device_tick`` and the bootstrap: the
    batched tick's three phases on a stack of this one sequence — the push,
    its immature bank and the activation
    (``fused_keyframe.keyframe_front_sequences``), the solver half
    (:func:`keyframe_solver_sequences`), the frontend depth maps
    (``depth_map.build_frontend_state_sequences``).  ``mask``: [H, W] bool
    candidate-selection mask or None.  A frame embedder other than the
    identity embeds the keyframe's intensity for the window's channel bank;
    the frontend and the epipolar tracer stay C = 1.  ``covariances``: the
    batch also carries the solved window's relative pose covariances
    (``cov_rel`` [K, K, 6, 6], :func:`pose_covariances`) and its frame ids
    (``cov_ids`` [K], -1 at a dead slot), before the marginalization."""
    stack = tuple(m[None] for m in maps)
    exposure = torch.as_tensor(exposure, dtype=pose_q.dtype, device=pose_q.device).reshape(1)
    min_distance = min_distance.reshape(1)
    front = keyframe_front_sequences(
        _as_stack(window), models[0], ImmaturePoints(*(x[None] for x in immature)), stack[0],
        (0,), pose_q[None], pose_t[None], affine[None], (frame_id,), min_distance, exposure,
        cfg.refine, cfg.huber_sigma, cfg.immature_per_frame, mask,
        keyframe_embeddings(stack[0][:, 0], cfg))
    half = keyframe_solver_sequences(front.window, front.immature, min_distance, (0,),
                                     front.slot, front.n_active, models[0], cfg, covariances)
    win = window_at(half.window, 0)
    batch = dict(energy=half.energy[0], num_valid=half.num_valid[0], n_active=front.n_active[0],
                 n_activated=front.n_activated[0], new_affine=half.new_affine[0],
                 poses_mat=half.poses_mat[0])
    if covariances:
        batch.update({name: x[0] for name, x in half.covariances.items()})
    idep, wei, points, flow_pts = build_frontend_state_sequences(
        half.window, models[0], stack, (0,), cfg.height, cfg.width, cfg.num_levels,
        cfg.frontend_points)
    first = lambda xs: tuple(x[0] for x in xs)                          # noqa: E731
    return KeyframeUpdate(win, ImmaturePoints(*first(half.immature)), first(idep), first(wei),
                          tuple(type(p)(*first(p)) for p in points),
                          type(flow_pts)(*first(flow_pts)), half.min_distance[0], batch,
                          {name: x[0] for name, x in half.snap.items()})


class SolverHalf(NamedTuple):
    """What :func:`keyframe_solver_sequences` returns of its S sequences."""
    window: Window              # the stack after the fold
    immature: ImmaturePoints    # the stacked banks after the permutation
    energy: torch.Tensor        # [S] the solve's energy
    num_valid: torch.Tensor     # [S] its count
    new_affine: torch.Tensor    # [S, 2] the keyframe's solved affine
    poses_mat: torch.Tensor     # [S, K, 4, 4] the solved poses
    min_distance: torch.Tensor  # [S] the controller's next value
    snap: dict                  # TickDiag's snapshot fields, [S, ...] each
    covariances: dict           # cov_rel [S, K, K, 6, 6] and cov_ids [S, K], or None


def keyframe_solver_sequences(window: Window, immature: ImmaturePoints, min_distance, seqs: tuple,
                              slots, n_active, model, cfg: DeviceLoopConfig,
                              covariances: bool = False) -> SolverHalf:
    """The solver half of :func:`keyframe_update` for the keyframing
    sequences ``seqs`` (a host tuple) of a stacked window, its stacked
    immature banks and ``min_distance`` [B], once for all of them: the
    windowed BA solve (K7–K11 in one C call), the new affine and poses, with
    ``covariances`` each solved window's pose covariances, the min-distance
    controller, the policy (K15p), the snapshot, the flags into the window,
    the fold (the marginalization pass's K7 and K8, then K15) with the
    compaction, and the banks' permutation; each kernel one launch for the S
    sequences.  ``slots`` [S] long: each keyframe's slot; ``n_active`` [S]:
    its activation's count.  Where ``seqs`` is every sequence of the stack
    in order, no tensor of the inputs is written; else the window is
    written in place at those sequences (:func:`pba.with_sequences`).
    Reads nothing on the host."""
    opts = cfg.pba_opts
    dtype, dev = window.eps.dtype, window.eps.device
    rows = _device_sequences(tuple(seqs), dev, torch.int64)
    whole = tuple(seqs) == tuple(range(window.t_lin_q.shape[0]))

    def take(x):
        return x if whole else x.index_select(0, rows)

    solved, energy, num_valid = solve_loop_sequences(window, model, opts, seqs)
    window = with_sequences(window, seqs, solved)
    affine = solved["affine0"] + solved["eps"][..., 6:]                  # [S, K, 2]
    new_affine = torch.gather(affine, 1, slots.view(-1, 1, 1).expand(-1, 1, 2))[:, 0]
    poses_mat = (SE3(solved["t_lin_q"], solved["t_lin_t"])
                 @ SE3.exp(solved["eps"][..., :6])).matrix()
    cov = None
    if covariances:
        cov = dict(cov_rel=torch.stack([pose_covariances(window_at(window, b), model, opts)[1]
                                        for b in seqs]),
                   cov_ids=take(torch.where(window.frame_valid, window.frame_id, -1)))
    min_distance = torch.clamp(
        take(min_distance) + (n_active.to(dtype) - cfg.desired_points) * P_GAIN,
        MIN_DISTANCE, MAX_DISTANCE)
    frame_flags, lm_flags, new_outliers, perm = flags_sequences(
        window, immature.valid, cfg.window_min, cfg.window_max, cfg.max_marg_fraction, seqs)
    snap = dict(frame_flags=frame_flags, kf_frame_id=take(window.frame_id),
                kf_poses_mat=poses_mat, kf_affine=affine, kf_exposure=take(window.exposure),
                lm_uv=take(window.lm_uv), lm_idepth=solved["lm_idepth"],
                lm_valid=take(window.lm_valid), lm_outlier=solved["lm_outlier"],
                lm_baseline=solved["lm_baseline"])
    window = with_sequences(window, seqs, dict(lm_outlier=solved["lm_outlier"] | new_outliers,
                                               frame_marg=frame_flags, lm_marg_flag=lm_flags))
    compact = marginalize_sequences(window, model, perm, opts, seqs)
    slots = slot_rows(seqs, perm)
    banks = ImmaturePoints(*(take_slots(x, slots) for x in immature))
    banks = banks._replace(valid=banks.valid & compact.frame_valid[..., None])
    return SolverHalf(with_sequences(window, seqs, compact),
                      ImmaturePoints(*(with_rows(x, seqs, v) for x, v in zip(immature, banks))),
                      energy, num_valid, new_affine, poses_mat, min_distance, snap, cov)


def with_rows(x, seqs: tuple, value):
    """``x`` [B, ...] with ``value`` [S, ...] at the sequences ``seqs``:
    ``value`` itself where ``seqs`` is every sequence in order, else a new
    tensor (``x`` is not written)."""
    if tuple(seqs) == tuple(range(x.shape[0])):
        return value
    return x.index_copy(0, _device_sequences(tuple(seqs), x.device, torch.int64), value)


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
    """The regular tick with the reliability gate and the keyframe decision
    (K5, inside :func:`fused_regular_tick`) → (the state after the frame, the
    keyframe flag, the tick's result).  Without ``force_kf`` the flag comes
    from the frame's one host copy of K5's packed statistics, which the
    result carries (``host_stats``) for the host's bookkeeping; with it
    nothing is read."""
    window = state.window
    poses = window.poses()
    out = fused_regular_tick(
        image, state.level_points, state.flow_points, poses.q, poses.t,
        window.affine(), window.exposure, exposure, newest_slot(window),
        state.immature, state.last_q, state.last_t, state.prev_q, state.prev_t,
        state.last_affine, models, cfg.align_opts, cfg.with_perturbations,
        cfg.num_levels, cfg.huber_sigma, state.rmse_last0, state.kf_rmse,
        cfg.keyframe_factor, force_kf)
    if force_kf:
        need_kf = True
    else:
        host = out.stats.cpu().numpy()      # the frame's one device read
        need_kf = bool(host[STAT_NEED])
        out = out._replace(host_stats=host)

    t_w_t = SE3(out.pose_q, out.pose_t)
    t_prev_rel = SE3(state.last_q, state.last_t).inverse() @ t_w_t
    base = state._replace(immature=out.immature, last_q=t_w_t.q, last_t=t_w_t.t,
                          prev_q=t_prev_rel.q, prev_t=t_prev_rel.t,
                          last_affine=out.affine, rmse_last0=out.stats[STAT_RMSE_LAST0],
                          kf_rmse=out.stats[STAT_KF_RMSE])
    return base, need_kf, out


def _backend_core(base: DeviceTrackerState, out, need_kf: bool, frame_id: int,
                  models, cfg: DeviceLoopConfig, exposure, mask=None):
    dtype = base.last_affine.dtype
    dev = base.last_affine.device
    front = dict(is_keyframe=need_kf, escalated=out.escalated,
                 rmse_chunk0=out.rmse_chunk0, pose_q=out.pose_q,
                 pose_t=out.pose_t, affine=out.affine, rmse=out.rmse, flow=out.flow,
                 flow_no_rot=out.flow_no_rot, num_valid_align=out.num_valid,
                 t_kf_frame_mat=out.t_kf_frame_mat, host_stats=out.host_stats)
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
            # a regular frame's values come from the frame's one host copy
            host = d.host_stats
            track.attach_frame(AttachedFrame(
                fid, ts, self.cur_kf,
                host[STAT_MATRIX:STAT_MATRIX + 16].reshape(4, 4).astype(np.float64),
                flow=float(host[STAT_FLOW]), flow_without_rotation=float(host[STAT_FLOW_NO_ROT]),
                rmse=float(host[STAT_RMSE])))

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

