"""Semi-dense reference depth maps for the frontend (counterpart of
``dsopp_tpu/tracker/depth_map.py``), plus the constants of the optical-flow
keyframe strategy (``dsopp_tpu/tracker/keyframe_strategy.py``).

Every live landmark of every older keyframe is reprojected into the newest
keyframe and scatter-added as (idepth, 1) into a level-0 grid; the grids are
2×2 sum-pooled into the pyramid and empty pixels take their 3×3 neighbours'
sum.  Per level the heaviest pixels become the frontend's points.

:func:`build_frontend_state` has a hand-written CUDA kernel (K16,
``csrc/depth_maps.cu``: the older keyframes' poses and landmark mask composed
from the window's raw tensors, each pixel's points chained and summed in
point order, and a counting selection, in place of ``_older_landmarks``,
``index_add_`` and the stable sorts of the plain version) and
:func:`frame_statistics` has one (K5, ``csrc/flow.cu``: the flow statistic,
the frontend's reliability gate and the keyframe decision of a frame in one
launch, packed into one buffer that the tracker copies to the host once a
frame; :func:`mean_square_flows`, the flows alone, is the same kernel), each
beside its plain version; all dispatch on their tensors' device: CUDA
tensors go to the kernel or raise.  :func:`frame_statistics` also takes B
sequences' frames (a leading ``[B]`` axis, the batched tick): the same one
launch, each sequence with its own ticket and partials, into a ``[B,
STATS]`` buffer that the batched tracker copies to the host once a tick.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.core.reproject import reproject
from dsopp_tpu_torch.features.extractor import top_k_stable
from dsopp_tpu_torch.solvers.pba import (BLOCK, Window, _kernel_sequences, active_lm_mask,
                                         newest_slot, sequence_list, stack_size, window_at)
from dsopp_tpu_torch.solvers.pose_alignment import LevelPoints

# OpticalFlowKeyframeStrategy (mean_square_optical_flow_and_rmse strategy)
MAX_SHIFT_WEIGHT = 4.5
MAX_SHIFT_NO_ROT_WEIGHT = 9.0
MAX_BRIGHTNESS_WEIGHT = 2.0
KEYFRAME_THRESHOLD = 1.0
MAX_EXCESS_ENERGY = 4.0
# the frontend's reliability gate: a frame is reliable at rmse < 2.5 x the last
# reliable rmse (monocular_tracker.cpp:185)
ENERGY_RATIO_THRESHOLD = 2.5

# frame_statistics' packed output, one host copy a frame: the two flows, the
# gate, the state's next rmse_last0 and kf_rmse, the strategy's decision, the
# tick's rmse and the 16 entries of T_kf_frame (row-major)
(STAT_FLOW, STAT_FLOW_NO_ROT, STAT_RELIABLE, STAT_RMSE_LAST0, STAT_KF_RMSE, STAT_NEED,
 STAT_RMSE, STAT_MATRIX) = range(8)
STATS = STAT_MATRIX + 16

FLOW_CAP = 8192   # slots of the compact flow-statistic point set


def _pool2(x):
    h2, w2 = (x.shape[0] // 2) * 2, (x.shape[1] // 2) * 2
    x = x[:h2, :w2]
    return ((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2]) + x[1::2, 1::2]


def _box3(x):
    p = F.pad(x, (1, 1, 1, 1))
    h, w = x.shape
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + p[dy:dy + h, dx:dx + w]
    return out


def _older_landmarks(window: Window):
    """→ (T newest ← each frame [K], mask [K, N] of the live landmarks of the
    keyframes before the newest)."""
    k = window.num_slots
    newest = newest_slot(window)
    poses = window.poses()
    t_n = SE3(poses.q.index_select(0, newest)[0],
              poses.t.index_select(0, newest)[0]).inverse()
    t_rel = SE3(t_n.q.expand(k, 4), t_n.t.expand(k, 3)).compose(poses)
    lm_mask = active_lm_mask(window) & ~window.lm_outlier
    lm_mask = lm_mask & (torch.arange(k, device=newest.device) != newest)[:, None]
    return t_rel, lm_mask


def build_depth_maps(window: Window, model, height: int, width: int,
                     num_levels: int = 5):
    """(idepth, weight) pyramids of the newest keyframe: two tuples of
    [H_l, W_l] tensors."""
    t_rel, lm_mask = _older_landmarks(window)
    rp = reproject(model, model, window.lm_uv, window.lm_idepth,
                   SE3(t_rel.q[:, None], t_rel.t[:, None]))
    ok = lm_mask & rp.valid
    xs = torch.clamp(torch.round(rp.uv[..., 0]).long(), 0, width - 1)
    ys = torch.clamp(torch.round(rp.uv[..., 1]).long(), 0, height - 1)
    dtype = window.lm_uv.dtype
    zero = torch.zeros_like(rp.idepth)
    w = torch.where(ok, torch.ones_like(zero), zero).reshape(-1)
    idep_w = (torch.where(ok, rp.idepth, zero) * torch.where(ok, 1.0, zero)).reshape(-1)
    flat = (ys * width + xs).reshape(-1)
    idepth0 = torch.zeros(height * width, dtype=dtype, device=flat.device).index_add_(0, flat, idep_w)
    weight0 = torch.zeros(height * width, dtype=dtype, device=flat.device).index_add_(0, flat, w)
    idepths = [idepth0.reshape(height, width)]
    weights = [weight0.reshape(height, width)]
    for _ in range(1, num_levels):
        idepths.append(_pool2(idepths[-1]))
        weights.append(_pool2(weights[-1]))
    out_i, out_w = [], []
    for i, w_ in zip(idepths, weights):
        empty = w_ == 0
        out_i.append(torch.where(empty, _box3(i), i))
        out_w.append(torch.where(empty, _box3(w_), w_))
    return tuple(out_i), tuple(out_w)


def depth_map_level_points(idepth_map, weight_map, pixel_map, max_points: int):
    """One (idepth, weight) level → fixed-slot LevelPoints (top-k by weight)."""
    h, w = idepth_map.shape
    flat_w = weight_map.reshape(-1)
    k = min(max_points, flat_w.shape[0])
    top_w, idx = top_k_stable(flat_w, k)
    dtype = idepth_map.dtype
    uv = torch.stack([(idx % w).to(dtype), (idx // w).to(dtype)], dim=-1)
    idep = idepth_map.reshape(-1)[idx] / torch.clamp(top_w, min=1e-12)
    vals = pixel_map[0].reshape(-1)[idx]
    valid = (top_w > 0) & (idep > 1e-6)
    pad = max_points - k
    if pad > 0:
        dev = idepth_map.device
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=dtype, device=dev)])
        idep = torch.cat([idep, torch.zeros(pad, dtype=dtype, device=dev)])
        vals = torch.cat([vals, torch.zeros(pad, dtype=dtype, device=dev)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return LevelPoints(uv.contiguous(), idep.contiguous(), vals.contiguous(), valid.contiguous())


def build_frontend_state_plain(window: Window, model, maps, height: int, width: int,
                               num_levels: int, max_points: int):
    """Depth-map pyramids, per-level frontend points and the flow set."""
    idep, wei = build_depth_maps(window, model, height, width, num_levels)
    points = tuple(depth_map_level_points(idep[l], wei[l], maps[l], max_points)
                   for l in range(num_levels))
    flow_pts = depth_map_level_points(idep[0], wei[0], maps[0], FLOW_CAP)
    return idep, wei, points, flow_pts


# the device work of the last call of build_frontend_state_cuda, as
# csrc/depth_maps.cu counts it: kernels launched and memsets issued
last_call = {"kernels": 0, "memsets": 0}
MAX_LEVELS = 5          # csrc/depth_maps.cu: a 16x16 level-0 tile holds one level-4 pixel
MAX_POINTS = 16384      # points (K * N) it takes: a weight class each in 64 KB of shared memory
MAX_FRAMES = 64         # window slots it takes: their poses in shared memory
SCRATCH_ALIGN = 64      # words: each scratch array starts on a 256-byte boundary
POSE_WIDTH = 7          # a relative pose in the kernel's optional output: q (4), t (3)


class FrontendLayout(NamedTuple):
    """K16's buffers at one size (:func:`frontend_layout`)."""
    shapes: tuple         # the levels' (h, w)
    scratch: dict         # name -> (offset, count) in 4-byte words, the C entry's order
    scratch_bytes: int
    pointers: tuple       # the scratch arrays' byte offsets, in that order
    words: int            # f32 outputs: the dilated grids, then the selections
    slots: int            # selection slots of a sequence: the levels', then the flow set's
    out_split: tuple      # the f32 outputs' pieces: each level of out_i, of out_w, uv, each
                          # round of idepth, of value
    slot_split: tuple     # the selections' rounds


@functools.lru_cache(maxsize=None)
def frontend_layout(points: int, height: int, width: int, levels: int,
                    max_points: int, seqs: int = 1) -> FrontendLayout:
    """K16's scratch and outputs for ``seqs`` sequences of ``points`` = K × N
    landmark slots and a ``levels``-level pyramid of a height × width frame
    (every array, piece and count below × ``seqs``: a scratch array is [S,
    one sequence's], an output piece a dense [S, ...] block).  Every scratch array
    holds 4-byte words: the points' pixel, idepth, next twin and has-earlier
    flag (K × N each), the raw grids of all levels (twice the cells), the
    weight-class histograms (levels × (K × N + 1)), the rounds' thresholds (2
    a round: the levels, then level 0 once more for the flow set), the
    compaction tiles' counts (2 a tile of 1024 pixels of a round), and each
    round's list of heavier pixels (2 words an entry) and their ranks (m = the
    larger slot count); each starts on a 256-byte boundary.  The outputs: the
    dilated grids (twice the cells) and the selections (uv, idepth, value: 4
    words a slot) in one f32 allocation, their validity in one bool
    allocation."""
    shapes = [(height, width)]
    for _ in range(1, levels):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    sizes = tuple(h * w for h, w in shapes)
    cells, rounds = sum(sizes), levels + 1
    tiles = sum(-(-size // 1024) for size in sizes) + -(-sizes[0] // 1024)
    m = max(max_points, FLOW_CAP)
    words = {"pix": points, "pidep": points, "next": points, "has_prev": points,
             "raw_i": cells, "raw_w": cells, "hist": levels * (points + 1),
             "params": 2 * rounds, "tile_counts": 2 * tiles, "heavy": rounds * 2 * m,
             "rank": rounds * m}
    words = {name: seqs * count for name, count in words.items()}
    scratch, at = {}, 0
    for name, count in words.items():
        scratch[name] = (at, count)
        at += -(-count // SCRATCH_ALIGN) * SCRATCH_ALIGN
    slots = levels * max_points + FLOW_CAP
    cut = tuple(seqs * c for c in (max_points,) * levels + (FLOW_CAP,))
    sizes = tuple(seqs * size for size in sizes)
    return FrontendLayout(tuple(shapes), scratch, 4 * at,
                          tuple(4 * off for off, _ in scratch.values()),
                          seqs * (2 * cells + 4 * slots), slots,
                          sizes + sizes + (2 * seqs * slots,) + cut + cut, cut)


def build_frontend_state_cuda(window: Window, model, maps, height: int, width: int,
                              num_levels: int, max_points: int, poses_out=None):
    """Kernel K16: same outputs as :func:`build_frontend_state_plain`; checks,
    the stream's scratch buffer (:func:`frontend_layout`), two output
    allocations (the outputs are their views) and one C call of 10 launches
    and no memset, no host read.  The kernel composes the frames' poses
    relative to the newest and the older keyframes' landmark mask from the
    window's raw tensors.  The idepth sums are taken in landmark order, so two
    runs on the same window give the same bits.  ``poses_out``, a [K, 7] f32
    CUDA tensor, receives the poses T_newest⁻¹ · T_f the kernel composed (q,
    t).  The one-sequence case of :func:`_frontend_sequences_cuda`."""
    return _frontend_sequences_cuda(window, model, maps, (0,), height, width, num_levels,
                                    max_points, poses_out, stacked=False)


def _frontend_sequences_cuda(windows: Window, model, maps, seqs: tuple, height: int, width: int,
                             num_levels: int, max_points: int, poses_out=None,
                             stacked: bool = True):
    """Kernel K16 for the S sequences ``seqs`` (a checked host list) of a
    stacked window and the tick's maps (``maps[l]`` [B, 3, H_l, W_l]), read
    through the list: one C call of 10 launches for all S → the outputs of
    :func:`build_frontend_state_plain`, each with a leading [S] axis (dense
    views of two allocations); ``poses_out`` [S, K, 7].  ``stacked=False``:
    one window and its [3, H_l, W_l] maps, ``seqs`` (0,), no sequence
    axis."""
    lead = tuple(windows.t_lin_q.shape[:1]) if stacked else ()
    batch = lead[0] if stacked else 1
    k, n = windows.t_lin_q.shape[-2], windows.lm_uv.shape[-2]
    if num_levels > MAX_LEVELS or k * n > MAX_POINTS or k > MAX_FRAMES:
        raise ValueError(f"depth_maps: {num_levels} levels, {k} frames and {k * n} points; the"
                         f" kernel takes up to {MAX_LEVELS} levels, {MAX_FRAMES} frames and"
                         f" {MAX_POINTS} points")
    size = len(seqs)
    own = (size,) if stacked else ()
    lay = frontend_layout(k * n, height, width, num_levels, max_points, size)
    check = kernels.check
    check(windows.lm_uv, "lm_uv", lead + (k, n, 2))
    check(windows.lm_idepth, "lm_idepth", lead + (k, n))
    check(windows.lm_valid, "lm_valid", lead + (k, n), torch.bool)
    check(windows.lm_outlier, "lm_outlier", lead + (k, n), torch.bool)
    check(windows.frame_valid, "frame_valid", lead + (k,), torch.bool)
    check(windows.t_lin_q, "t_lin_q", lead + (k, 4))
    check(windows.t_lin_t, "t_lin_t", lead + (k, 3))
    check(windows.eps, "eps", lead + (k, BLOCK))
    if poses_out is not None:
        check(poses_out, "poses_out", own + (k, POSE_WIDTH))
    for level, (h, w) in enumerate(lay.shapes):
        check(maps[level], f"maps[{level}]", lead + (3, h, w))
    dev = windows.lm_uv.device
    base = kernels.scratch(kernels.DEPTH_MAPS, lay.scratch_bytes, dev).data_ptr()
    out = torch.empty((lay.words,), dtype=torch.float32, device=dev)
    sel_valid = torch.empty((size * lay.slots,), dtype=torch.bool, device=dev)
    # the outputs are views of the two allocations, made in one split each
    # (a view costs the host about as much as a kernel launch)
    pieces = out.split_with_sizes(lay.out_split)
    levels, rounds = num_levels, num_levels + 1
    grids, sel_uv = pieces[:2 * levels], pieces[2 * levels]
    sel_idepth, sel_value = pieces[2 * levels + 1:2 * levels + 1 + rounds], pieces[-rounds:]
    # the intensity image of level l is channel 0 of maps[l]
    intensity = (ctypes.c_void_p * num_levels)(*(m.data_ptr() for m in maps[:num_levels]))
    launches = (ctypes.c_int * 2)()
    kernels.DEPTH_MAPS(
        windows.lm_uv, windows.lm_idepth, windows.lm_valid, windows.lm_outlier,
        windows.frame_valid, windows.t_lin_q, windows.t_lin_t, windows.eps, k, n, model.fx,
        model.fy, model.cx, model.cy, model.width, model.height, height, width, num_levels,
        max_points, FLOW_CAP, intensity, *(base + at for at in lay.pointers), grids[0],
        grids[levels], sel_uv, sel_idepth[0], sel_value[0], sel_valid, poses_out, launches,
        size, _kernel_sequences(seqs, batch, dev))
    last_call.update(kernels=launches[0], memsets=launches[1])
    maps2d = [x.view(own + shape) for x, shape in zip(grids, lay.shapes + lay.shapes)]
    slots = [c // size for c in lay.slot_split]
    sets = [LevelPoints(uv.view(own + (c, 2)), idepth.view(own + (c,)),
                        value.view(own + (c,)), valid.view(own + (c,)))
            for c, uv, idepth, value, valid in zip(
                slots, sel_uv.split_with_sizes(tuple(2 * x for x in lay.slot_split)),
                sel_idepth, sel_value, sel_valid.split_with_sizes(lay.slot_split))]
    return tuple(maps2d[:levels]), tuple(maps2d[levels:]), tuple(sets[:-1]), sets[-1]


def build_frontend_state(window: Window, model, maps, height: int, width: int,
                         num_levels: int, max_points: int):
    """The frontend's state after a keyframe: the kernel K16 on CUDA tensors,
    the plain version on CPU ones."""
    fn = build_frontend_state_cuda if window.lm_uv.is_cuda else build_frontend_state_plain
    return fn(window, model, maps, height, width, num_levels, max_points)


def build_frontend_state_sequences(windows: Window, model, maps, seqs, height: int, width: int,
                                   num_levels: int, max_points: int):
    """The frontend's state after a keyframe of the sequences ``seqs`` (a
    host list; None: all) of a stacked window, with the tick's maps
    (``maps[l]`` [B, 3, H_l, W_l]) → (idepth, weight: per level [S, H_l,
    W_l]; the level points and the flow set: LevelPoints of [S, ...] fields):
    the kernel K16 in one call (10 launches for all S) on CUDA tensors,
    :func:`build_frontend_state_plain` once a sequence on CPU ones."""
    seqs = sequence_list(seqs, stack_size(windows))
    if windows.lm_uv.is_cuda:
        return _frontend_sequences_cuda(windows, model, maps, seqs, height, width, num_levels,
                                        max_points)
    outs = [build_frontend_state_plain(window_at(windows, b), model,
                                       tuple(m[b] for m in maps), height, width, num_levels,
                                       max_points) for b in seqs]
    idep, wei, points, flow = zip(*outs)
    stack = lambda xs: tuple(torch.stack(x) for x in zip(*xs))          # noqa: E731
    return (stack(idep), stack(wei),
            tuple(LevelPoints(*stack(level)) for level in zip(*points)),
            LevelPoints(*stack(flow)))


def mean_square_flows_plain(pts: LevelPoints, model, t_t_r: SE3, border: int = 4):
    """(flow, flow_without_rotation): RMS ray-space flow of the flow set;
    points [..., N] against poses [...] (a leading axis of B sequences)."""
    uv = pts.uv
    valid = (pts.valid & (pts.idepth > 1e-6)
             & (uv[..., 0] >= border) & (uv[..., 0] < model.width - border)
             & (uv[..., 1] >= border) & (uv[..., 1] < model.height - border))
    ray0 = model.unproject(uv)

    def one(t):
        rp = reproject(model, model, uv, pts.idepth, SE3(t.q[..., None, :], t.t[..., None, :]))
        d2 = torch.sum((ray0 - model.unproject(rp.uv)) ** 2, dim=-1)
        ok = valid & rp.valid
        n = torch.clamp(torch.sum(ok, dim=-1), min=1)
        return torch.sqrt(torch.sum(torch.where(ok, d2, torch.zeros_like(d2)), dim=-1)
                          / n.to(d2.dtype))

    q_id = torch.zeros_like(t_t_r.q)
    q_id[..., 0] = 1.0
    return one(t_t_r), one(SE3(q_id, t_t_r.t))


def _flow_args(pts: LevelPoints, t_t_r: SE3, lead=()):
    """Check K5's point and pose tensors (``lead``: (B,) for B sequences) →
    the point count."""
    n = pts.uv.shape[-2]
    check = kernels.check
    check(pts.uv, "uv", lead + (n, 2))
    check(pts.idepth, "idepth", lead + (n,))
    check(pts.valid, "valid", lead + (n,), torch.bool)
    check(t_t_r.q, "pose q", lead + (4,))
    check(t_t_r.t, "pose t", lead + (3,))
    return n


def _strided_check(x, name: str, batch: int) -> int:
    """Check one f32 value per sequence on the card, at any stride (a
    column of the [B, STATS] buffer) → its stride in floats."""
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"{name}: expected an f32 CUDA tensor, got {x.dtype} on {x.device}")
    if tuple(x.shape) != ((batch,) if batch else ()):
        raise ValueError(f"{name}: expected shape {(batch,) if batch else ()},"
                         f" got {tuple(x.shape)}")
    return x.stride(0) if batch else 0


def mean_square_flows_cuda(pts: LevelPoints, model, t_t_r: SE3, border: int = 4):
    """Kernel K5 without the decision: same outputs as
    :func:`mean_square_flows_plain`, one launch, no host read."""
    n = _flow_args(pts, t_t_r)
    out = torch.empty((2,), dtype=pts.uv.dtype, device=pts.uv.device)
    ws = kernels.workspace(kernels.FLOW, kernels.FLOW_WORKSPACE_BYTES, out.device)
    kernels.FLOW(pts.uv, pts.idepth, pts.valid, n, 1, t_t_r.q, t_t_r.t, model.fx, model.fy,
                 model.cx, model.cy, model.width, model.height, float(border), None, None,
                 None, None, 0, None, 0, 0.0, None, ws, ws.numel(), out)
    return out[0], out[1]


def mean_square_flows(pts: LevelPoints, model, t_t_r: SE3, border: int = 4):
    """The flow statistic: the kernel K5 on CUDA tensors, the plain version
    on CPU ones."""
    fn = mean_square_flows_cuda if pts.uv.is_cuda else mean_square_flows_plain
    return fn(pts, model, t_t_r, border)


def keyframe_decision_plain(flow, flow_no_rot, rmse, num_valid, rmse_last0, kf_rmse,
                            keyframe_factor: float, force_kf):
    """The frontend's reliability gate and the keyframe strategy's decision
    (``dsopp_tpu/tracker/device_loop.py::_frontend_core``) → (reliable, the
    state's next rmse_last0, its next kf_rmse, the strategy's decision).
    With a leading axis of B sequences ``force_kf`` is a sequence of B
    flags."""
    reliable = (rmse < ENERGY_RATIO_THRESHOLD * rmse_last0) & (num_valid > 0)
    rmse_last0_new = torch.where(reliable, rmse, rmse_last0 * ENERGY_RATIO_THRESHOLD)
    kf_rmse_eff = torch.where(kf_rmse < 0, rmse, kf_rmse)
    need = (
        (keyframe_factor * (MAX_SHIFT_WEIGHT * flow + MAX_SHIFT_NO_ROT_WEIGHT * flow_no_rot)
         > KEYFRAME_THRESHOLD)
        | (rmse / torch.clamp(kf_rmse_eff, min=1e-12) > MAX_EXCESS_ENERGY)
    ) & reliable
    kf_rmse_new = torch.where(need, torch.full_like(kf_rmse_eff, -1.0), kf_rmse_eff)
    if rmse.dim() == 0:
        kf_rmse_new = kf_rmse if force_kf else kf_rmse_new
    else:
        forced = torch.tensor([bool(f) for f in force_kf], device=kf_rmse.device)
        kf_rmse_new = torch.where(forced, kf_rmse, kf_rmse_new)
    return reliable, rmse_last0_new, kf_rmse_new, need


def frame_statistics_plain(pts: LevelPoints, model, t_t_kf: SE3, t_kf_frame_mat, rmse,
                           num_valid, rmse_last0, kf_rmse, keyframe_factor: float,
                           force_kf: bool, border: int = 4):
    """The flow statistic, the frontend's reliability gate and the keyframe
    decision of one frame → the packed [STATS] statistics (``STAT_*``;
    booleans as 0 / 1); of B sequences' frames (a leading axis, ``force_kf``
    B flags) → [B, STATS]."""
    flow, flow_no_rot = mean_square_flows_plain(pts, model, t_t_kf, border)
    reliable, rmse_last0_new, kf_rmse_new, need = keyframe_decision_plain(
        flow, flow_no_rot, rmse, num_valid, rmse_last0, kf_rmse, keyframe_factor, force_kf)
    dtype = rmse.dtype
    head = torch.stack([flow, flow_no_rot, reliable.to(dtype), rmse_last0_new, kf_rmse_new,
                        need.to(dtype), rmse], dim=-1)
    return torch.cat([head, t_kf_frame_mat.reshape(tuple(rmse.shape) + (16,))], dim=-1)


def frame_statistics_cuda(pts: LevelPoints, model, t_t_kf: SE3, t_kf_frame_mat, rmse,
                          num_valid, rmse_last0, kf_rmse, keyframe_factor: float,
                          force_kf: bool, border: int = 4):
    """Kernel K5 with the decision: same outputs as
    :func:`frame_statistics_plain`, one launch into a new buffer, no host
    read, the caller's tensors untouched.  B sequences (a leading axis on
    every tensor, ``force_kf`` B flags): one launch into [B, STATS];
    ``rmse_last0`` and ``kf_rmse`` may then be columns of the last tick's
    buffer (any stride)."""
    batched = rmse.dim() == 1
    batch = rmse.shape[0] if batched else 0
    lead = (batch,) if batched else ()
    n = _flow_args(pts, t_t_kf, lead)
    check = kernels.check
    check(t_kf_frame_mat, "t_kf_frame_mat", lead + (4, 4))
    check(rmse, "rmse", lead)
    check(num_valid, "num_valid", lead, torch.int32)
    stride0 = _strided_check(rmse_last0, "rmse_last0", batch)
    stride1 = _strided_check(kf_rmse, "kf_rmse", batch)
    force = bytes(int(bool(f)) for f in force_kf) if batched else bytes([int(force_kf)])
    out = torch.empty(lead + (STATS,), dtype=torch.float32, device=pts.uv.device)
    ws = kernels.workspace(kernels.FLOW, max(batch, 1) * kernels.FLOW_WORKSPACE_BYTES,
                           out.device)
    kernels.FLOW(pts.uv, pts.idepth, pts.valid, n, max(batch, 1), t_t_kf.q, t_t_kf.t,
                 model.fx, model.fy, model.cx, model.cy, model.width, model.height,
                 float(border), t_kf_frame_mat, rmse, num_valid, rmse_last0, stride0, kf_rmse,
                 stride1, float(keyframe_factor), force, ws, ws.numel(), out)
    return out


def frame_statistics(pts: LevelPoints, model, t_t_kf: SE3, t_kf_frame_mat, rmse, num_valid,
                     rmse_last0, kf_rmse, keyframe_factor: float, force_kf: bool,
                     border: int = 4):
    """A frame's flows, gate and keyframe decision, packed for one host copy:
    the kernel K5 on CUDA tensors, the plain version on CPU ones.  B
    sequences' frames (a leading axis, ``force_kf`` a sequence of B flags):
    [B, STATS] in one call."""
    fn = frame_statistics_cuda if pts.uv.is_cuda else frame_statistics_plain
    return fn(pts, model, t_t_kf, t_kf_frame_mat, rmse, num_valid, rmse_last0, kf_rmse,
              keyframe_factor, force_kf, border)
