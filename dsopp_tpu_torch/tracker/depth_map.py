"""Semi-dense reference depth maps for the frontend (counterpart of
``dsopp_tpu/tracker/depth_map.py``), plus the constants of the optical-flow
keyframe strategy (``dsopp_tpu/tracker/keyframe_strategy.py``).

Every live landmark of every older keyframe is reprojected into the newest
keyframe and scatter-added as (idepth, 1) into a level-0 grid; the grids are
2×2 sum-pooled into the pyramid and empty pixels take their 3×3 neighbours'
sum.  Per level the heaviest pixels become the frontend's points.

:func:`build_frontend_state` has a hand-written CUDA kernel (K16,
``csrc/depth_maps.cu``: each pixel's points chained and summed in point
order, and a counting selection, in place of ``index_add_`` and the stable
sorts of the plain version) and
:func:`frame_statistics` has one (K5, ``csrc/flow.cu``: the flow statistic,
the frontend's reliability gate and the keyframe decision of a frame in one
launch, packed into one buffer that the tracker copies to the host once a
frame; :func:`mean_square_flows`, the flows alone, is the same kernel), each
beside its plain version; all dispatch on their tensors' device: CUDA
tensors go to the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.core.reproject import reproject
from dsopp_tpu_torch.features.extractor import top_k_stable
from dsopp_tpu_torch.solvers.pba import Window, active_lm_mask, newest_slot
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


def build_frontend_state_cuda(window: Window, model, maps, height: int, width: int,
                              num_levels: int, max_points: int):
    """Kernel K16: same outputs as :func:`build_frontend_state_plain`; one
    call of 10 launches and no memset, no host read.  The idepth sums are
    taken in landmark order, so two runs on the same window give the same
    bits."""
    k, n = window.num_slots, window.num_landmark_slots
    if num_levels > MAX_LEVELS or k * n > MAX_POINTS:
        raise ValueError(f"depth_maps: {num_levels} levels and {k * n} points; the kernel takes"
                         f" up to {MAX_LEVELS} levels and {MAX_POINTS} points")
    check = kernels.check
    check(window.lm_uv, "lm_uv", (k, n, 2))
    check(window.lm_idepth, "lm_idepth", (k, n))
    shapes = [(height, width)]
    for _ in range(1, num_levels):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    for level, shape in enumerate(shapes):
        check(maps[level], f"maps[{level}]", (3,) + shape)
    t_rel, lm_mask = _older_landmarks(window)
    dev = window.lm_uv.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    sizes = [h * w for h, w in shapes]
    cells = sum(sizes)
    slots = num_levels * max_points + FLOW_CAP
    raw_i, raw_w = torch.empty((cells,), **f32), torch.empty((cells,), **f32)
    out_i, out_w = torch.empty((cells,), **f32), torch.empty((cells,), **f32)
    sel_uv, sel_idepth = torch.empty((slots, 2), **f32), torch.empty((slots,), **f32)
    sel_value = torch.empty((slots,), **f32)
    sel_valid = torch.empty((slots,), dtype=torch.bool, device=dev)
    # the intensity image of level l is channel 0 of maps[l]
    intensity = (ctypes.c_void_p * num_levels)(*(m.data_ptr() for m in maps[:num_levels]))
    rounds = num_levels + 1                  # the levels, then level 0 for the flow set
    tiles = sum(-(-size // 1024) for size in sizes) + -(-sizes[0] // 1024)
    launches = (ctypes.c_int * 2)()
    kernels.DEPTH_MAPS(
        window.lm_uv, window.lm_idepth, lm_mask.contiguous(), t_rel.q.contiguous(),
        t_rel.t.contiguous(), k, n, model.fx, model.fy, model.cx, model.cy, model.width,
        model.height, height, width, num_levels, max_points, FLOW_CAP, intensity,
        torch.empty((k * n,), **i32), torch.empty((k * n,), **f32), torch.empty((k * n,), **i32),
        torch.empty((k * n,), **i32), raw_i, raw_w, torch.empty((num_levels * (k * n + 1),), **i32),
        torch.empty((2 * rounds,), **i32), torch.empty((2 * tiles,), **i32),
        torch.empty((rounds * 2 * max(max_points, FLOW_CAP),), **i32),
        torch.empty((rounds * max(max_points, FLOW_CAP),), **i32),
        out_i, out_w, sel_uv, sel_idepth, sel_value, sel_valid, launches)
    last_call.update(kernels=launches[0], memsets=launches[1])
    idep, wei, points = [], [], []
    at = 0
    for level, (shape, size) in enumerate(zip(shapes, sizes)):
        idep.append(out_i[at:at + size].view(shape))
        wei.append(out_w[at:at + size].view(shape))
        lo = level * max_points
        points.append(LevelPoints(sel_uv[lo:lo + max_points], sel_idepth[lo:lo + max_points],
                                  sel_value[lo:lo + max_points], sel_valid[lo:lo + max_points]))
        at += size
    lo = num_levels * max_points
    flow_pts = LevelPoints(sel_uv[lo:], sel_idepth[lo:], sel_value[lo:], sel_valid[lo:])
    return tuple(idep), tuple(wei), tuple(points), flow_pts


def build_frontend_state(window: Window, model, maps, height: int, width: int,
                         num_levels: int, max_points: int):
    """The frontend's state after a keyframe: the kernel K16 on CUDA tensors,
    the plain version on CPU ones."""
    fn = build_frontend_state_cuda if window.lm_uv.is_cuda else build_frontend_state_plain
    return fn(window, model, maps, height, width, num_levels, max_points)


def mean_square_flows_plain(pts: LevelPoints, model, t_t_r: SE3, border: int = 4):
    """(flow, flow_without_rotation): RMS ray-space flow of the flow set."""
    uv = pts.uv
    valid = (pts.valid & (pts.idepth > 1e-6)
             & (uv[..., 0] >= border) & (uv[..., 0] < model.width - border)
             & (uv[..., 1] >= border) & (uv[..., 1] < model.height - border))
    ray0 = model.unproject(uv)

    def one(t):
        rp = reproject(model, model, uv, pts.idepth, t)
        d2 = torch.sum((ray0 - model.unproject(rp.uv)) ** 2, dim=-1)
        ok = valid & rp.valid
        n = torch.clamp(torch.sum(ok), min=1)
        return torch.sqrt(torch.sum(torch.where(ok, d2, torch.zeros_like(d2))) / n.to(d2.dtype))

    q_id = torch.zeros(4, dtype=uv.dtype, device=uv.device)
    q_id[0] = 1.0
    return one(t_t_r), one(SE3(q_id, t_t_r.t))


def _flow_args(pts: LevelPoints, t_t_r: SE3):
    """Check K5's point and pose tensors → the point count."""
    n = pts.uv.shape[0]
    check = kernels.check
    check(pts.uv, "uv", (n, 2))
    check(pts.idepth, "idepth", (n,))
    check(pts.valid, "valid", (n,), torch.bool)
    check(t_t_r.q, "pose q", (4,))
    check(t_t_r.t, "pose t", (3,))
    return n


def mean_square_flows_cuda(pts: LevelPoints, model, t_t_r: SE3, border: int = 4):
    """Kernel K5 without the decision: same outputs as
    :func:`mean_square_flows_plain`, one launch, no host read."""
    n = _flow_args(pts, t_t_r)
    out = torch.empty((2,), dtype=pts.uv.dtype, device=pts.uv.device)
    ws = kernels.workspace(kernels.FLOW, kernels.FLOW_WORKSPACE_BYTES, out.device)
    kernels.FLOW(pts.uv, pts.idepth, pts.valid, n, t_t_r.q, t_t_r.t, model.fx, model.fy,
                 model.cx, model.cy, model.width, model.height, float(border), None, None,
                 None, None, None, 0.0, 0, ws, ws.numel(), out)
    return out[0], out[1]


def mean_square_flows(pts: LevelPoints, model, t_t_r: SE3, border: int = 4):
    """The flow statistic: the kernel K5 on CUDA tensors, the plain version
    on CPU ones."""
    fn = mean_square_flows_cuda if pts.uv.is_cuda else mean_square_flows_plain
    return fn(pts, model, t_t_r, border)


def keyframe_decision_plain(flow, flow_no_rot, rmse, num_valid, rmse_last0, kf_rmse,
                            keyframe_factor: float, force_kf: bool):
    """The frontend's reliability gate and the keyframe strategy's decision
    (``dsopp_tpu/tracker/device_loop.py::_frontend_core``) → (reliable, the
    state's next rmse_last0, its next kf_rmse, the strategy's decision)."""
    reliable = (rmse < ENERGY_RATIO_THRESHOLD * rmse_last0) & (num_valid > 0)
    rmse_last0_new = torch.where(reliable, rmse, rmse_last0 * ENERGY_RATIO_THRESHOLD)
    kf_rmse_eff = torch.where(kf_rmse < 0, rmse, kf_rmse)
    need = (
        (keyframe_factor * (MAX_SHIFT_WEIGHT * flow + MAX_SHIFT_NO_ROT_WEIGHT * flow_no_rot)
         > KEYFRAME_THRESHOLD)
        | (rmse / torch.clamp(kf_rmse_eff, min=1e-12) > MAX_EXCESS_ENERGY)
    ) & reliable
    if force_kf:
        kf_rmse_new = kf_rmse
    else:
        kf_rmse_new = torch.where(need, torch.full_like(kf_rmse_eff, -1.0), kf_rmse_eff)
    return reliable, rmse_last0_new, kf_rmse_new, need


def frame_statistics_plain(pts: LevelPoints, model, t_t_kf: SE3, t_kf_frame_mat, rmse,
                           num_valid, rmse_last0, kf_rmse, keyframe_factor: float,
                           force_kf: bool, border: int = 4):
    """The flow statistic, the frontend's reliability gate and the keyframe
    decision of one frame → the packed [STATS] statistics (``STAT_*``;
    booleans as 0 / 1)."""
    flow, flow_no_rot = mean_square_flows_plain(pts, model, t_t_kf, border)
    reliable, rmse_last0_new, kf_rmse_new, need = keyframe_decision_plain(
        flow, flow_no_rot, rmse, num_valid, rmse_last0, kf_rmse, keyframe_factor, force_kf)
    dtype = rmse.dtype
    head = torch.stack([flow, flow_no_rot, reliable.to(dtype), rmse_last0_new, kf_rmse_new,
                        need.to(dtype), rmse])
    return torch.cat([head, t_kf_frame_mat.reshape(16)])


def frame_statistics_cuda(pts: LevelPoints, model, t_t_kf: SE3, t_kf_frame_mat, rmse,
                          num_valid, rmse_last0, kf_rmse, keyframe_factor: float,
                          force_kf: bool, border: int = 4):
    """Kernel K5 with the decision: same outputs as
    :func:`frame_statistics_plain`, one launch into a new buffer, no host
    read, the caller's tensors untouched."""
    n = _flow_args(pts, t_t_kf)
    check = kernels.check
    check(t_kf_frame_mat, "t_kf_frame_mat", (4, 4))
    check(rmse, "rmse", ())
    check(num_valid, "num_valid", (), torch.int32)
    check(rmse_last0, "rmse_last0", ())
    check(kf_rmse, "kf_rmse", ())
    out = torch.empty((STATS,), dtype=torch.float32, device=pts.uv.device)
    ws = kernels.workspace(kernels.FLOW, kernels.FLOW_WORKSPACE_BYTES, out.device)
    kernels.FLOW(pts.uv, pts.idepth, pts.valid, n, t_t_kf.q, t_t_kf.t, model.fx, model.fy,
                 model.cx, model.cy, model.width, model.height, float(border), t_kf_frame_mat,
                 rmse, num_valid, rmse_last0, kf_rmse, float(keyframe_factor), int(force_kf),
                 ws, ws.numel(), out)
    return out


def frame_statistics(pts: LevelPoints, model, t_t_kf: SE3, t_kf_frame_mat, rmse, num_valid,
                     rmse_last0, kf_rmse, keyframe_factor: float, force_kf: bool,
                     border: int = 4):
    """A frame's flows, gate and keyframe decision, packed for one host copy:
    the kernel K5 on CUDA tensors, the plain version on CPU ones."""
    fn = frame_statistics_cuda if pts.uv.is_cuda else frame_statistics_plain
    return fn(pts, model, t_t_kf, t_kf_frame_mat, rmse, num_valid, rmse_last0, kf_rmse,
              keyframe_factor, force_kf, border)
