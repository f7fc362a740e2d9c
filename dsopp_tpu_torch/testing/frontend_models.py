"""Host models of what the frontend's kernels K1 (``csrc/pyramid.cu``), K4
(``csrc/epipolar.cu``) and K5 (``csrc/flow.cu``) compute in their own order,
in numpy, for the CPU tests (``tests/test_torch_frontend_models.py``).

* :func:`linspace` and :func:`alpha_group`: the sample positions K4 forms
  itself (torch.linspace's two-sided formula; the group centres from an
  arange);
* :func:`relative_poses`: K4's pose path, inverse(T_w_t) · T_w_k with
  torch.linalg.cross as the card computes it (one fma a component) and the
  card's order of the quaternion's 4-term sum;
* :func:`older_landmarks`: K16's glue (``csrc/depth_maps.cu::prepare_kernel``):
  the newest slot, T_newest⁻¹ · T_f with ``SE3.exp`` in the card's order
  (:func:`se3_exp`: the 3-term sum (x0 + x2) + x1, a division by a Python
  scalar as a product with its f32 reciprocal) and the older keyframes'
  landmark mask, from the window's raw tensors;
* :func:`pyramid`: K1's one launch, block by block: each 32×32 tile of
  level 0 read with its halo, the coarser levels' tiles built in the
  block's buffers, each level's values and gradients written from them;
* :func:`flow_block_sums`: K5's f64 sums, a thread per point over a grid of
  blocks, each block's partial in a fixed order and the last block to finish
  adding the partials in block index order.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
TILE = 32   # csrc/pyramid.cu::kTile
FLOW_THREADS = 256   # csrc/flow.cu::kFlowThreads
FLOW_MAX_BLOCKS = 64   # csrc/flow.cu::kMaxBlocks


def linspace(start: float, end: float, steps: int) -> np.ndarray:
    """``torch.linspace(start, end, steps)`` in f32 as K4 forms it: the
    lower half start + step·i, the upper end − step·(steps − 1 − i)."""
    step = (F32(end) - F32(start)) / F32(steps - 1)
    i = np.arange(steps)
    lower = F32(start) + step * i.astype(F32)
    upper = F32(end) - step * (steps - 1 - i).astype(F32)
    return np.where(i < steps // 2, lower, upper).astype(F32)


def alpha_group(samples: int = 32, group: int = 4) -> np.ndarray:
    """The group centres (group·g + (group − 1)/2) / (samples − 1), f32."""
    g = np.arange(samples // group).astype(F32)
    return (F32(group) * g + F32(0.5 * (group - 1))) / F32(samples - 1)


def _fma(a, b, c):
    """f32 a·b + c rounded once (the product is exact in f64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def cross(a, b):
    """torch.linalg.cross on the card: a_i b_j − a_j b_i = fma(a_i, b_j, −a_j b_i)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([_fma(ay, bz, -(az * by)), _fma(az, bx, -(ax * bz)),
                     _fma(ax, by, -(ay * bx))], -1)


def quat_rotate(q, v):
    u = q[..., 1:]
    uv = cross(u, v)
    return v + F32(2.0) * (q[..., :1] * uv + cross(u, uv))


def quat_multiply(a, b):
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_normalize(q):
    sq = q * q
    n2 = (sq[..., 0] + sq[..., 2]) + (sq[..., 1] + sq[..., 3])
    return q / np.sqrt(np.maximum(n2, F32(1e-30)))[..., None]


def relative_poses(pose_q, pose_t, window_q, window_t):
    """K4's [K] poses inverse(T_w_t) · T_w_k → (q [K, 4], t [K, 3]), f32."""
    pose_q, pose_t, window_q, window_t = (np.asarray(x, F32) for x in
                                          (pose_q, pose_t, window_q, window_t))
    qi = pose_q * np.array([1, -1, -1, -1], F32)
    ti = -quat_rotate(qi, pose_t)
    q = quat_normalize(quat_multiply(np.broadcast_to(qi, window_q.shape), window_q))
    return q, quat_rotate(np.broadcast_to(qi, window_q.shape), window_t) + ti


SMALL = F32(1e-6)   # core/lie.py::_SMALL, compared in f32


def se3_exp(xi):
    """``SE3.exp`` of tangents ``xi`` [..., 6] (f32) as torch runs it on the
    card → (q [..., 4], t [..., 3])."""
    xi = np.asarray(xi, F32)
    ups, om = xi[..., :3], xi[..., 3:]
    sq = om * om
    theta_sq = (sq[..., 0] + sq[..., 2]) + sq[..., 1]
    theta = np.sqrt(np.maximum(theta_sq, F32(1e-30)))
    small = theta_sq < SMALL
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.where(small, F32(0.5) - theta_sq * (F32(1) / F32(48)),
                     np.sin(F32(0.5) * theta) / theta)
        w = np.where(small, F32(1) - theta_sq * (F32(1) / F32(8)), np.cos(F32(0.5) * theta))
        a = np.where(small, F32(0.5) - theta_sq * (F32(1) / F32(24)),
                     (F32(1) - np.cos(theta)) / np.maximum(theta_sq, F32(1e-30)))
        b = np.where(small, F32(1.0 / 6.0) - theta_sq * (F32(1) / F32(120)),
                     (theta - np.sin(theta)) / np.maximum(theta_sq * theta, F32(1e-30)))
    q = quat_normalize(np.concatenate([w[..., None], k[..., None] * om], -1).astype(F32))
    c1 = cross(om, ups)
    c2 = cross(om, c1)
    return q, (ups + a[..., None] * c1) + b[..., None] * c2


def older_landmarks(t_lin_q, t_lin_t, eps, frame_valid, lm_valid, lm_outlier):
    """K16's poses and mask from the window's raw tensors → (newest slot,
    T_newest⁻¹ · T_f as (q [K, 4], t [K, 3]), the mask [K, N] of the live
    landmarks of the keyframes before the newest).  The newest slot is the
    count of valid frames less one; T_f = T_lin,f · exp(eps_f[:6])."""
    t_lin_q, t_lin_t, eps = (np.asarray(x, F32) for x in (t_lin_q, t_lin_t, eps))
    frame_valid = np.asarray(frame_valid, bool)
    newest = int(frame_valid.sum()) - 1
    eq, et = se3_exp(eps[:, :6])
    pose_q = quat_normalize(quat_multiply(t_lin_q, eq))
    pose_t = quat_rotate(t_lin_q, et) + t_lin_t
    at = max(newest, 0)
    q, t = relative_poses(pose_q[at], pose_t[at], pose_q, pose_t)
    mask = (np.asarray(lm_valid, bool) & frame_valid[:, None] & ~np.asarray(lm_outlier, bool)
            & (np.arange(frame_valid.shape[0]) != newest)[:, None])
    return newest, q, t, mask


def level_shapes(h: int, w: int, levels: int):
    shapes = [(h, w)]
    for _ in range(levels - 1):
        h, w = h // 2, w // 2
        shapes.append((h, w))
    return shapes


def pyramid(image: np.ndarray, levels: int):
    """K1's maps of ``image`` [H, W] (f32), block by block as the kernel
    indexes them → list of [3, H_l, W_l]."""
    image = np.asarray(image, F32)
    h, w = image.shape
    halo0 = 1 << (levels - 1)
    side0 = TILE + 2 * halo0
    blocks_y, blocks_x = -(-h // TILE), -(-w // TILE)
    # the image with zeros wherever a block's level-0 buffer leaves it
    padded = np.zeros((blocks_y * TILE + 2 * halo0, blocks_x * TILE + 2 * halo0), F32)
    padded[halo0:halo0 + h, halo0:halo0 + w] = image
    shapes = level_shapes(h, w, levels)
    out = [np.full((3, hl, wl), np.nan, F32) for hl, wl in shapes]
    for by in range(blocks_y):
        for bx in range(blocks_x):
            buf = padded[by * TILE:by * TILE + side0, bx * TILE:bx * TILE + side0]
            for lvl, (hl, wl) in enumerate(shapes):
                if lvl:
                    buf = F32(0.25) * (((buf[0::2, 0::2] + buf[0::2, 1::2])
                                        + buf[1::2, 0::2]) + buf[1::2, 1::2])
                tile, halo = TILE >> lvl, halo0 >> lvl
                ys = by * tile + np.arange(tile)
                xs = bx * tile + np.arange(tile)
                ys, xs = ys[ys < hl], xs[xs < wl]
                if not len(ys) or not len(xs):
                    continue
                r = ys - by * tile + halo
                c = xs - bx * tile + halo
                v = buf[np.ix_(r, c)]
                left, right = buf[np.ix_(r, c - 1)], buf[np.ix_(r, c + 1)]
                up, down = buf[np.ix_(r - 1, c)], buf[np.ix_(r + 1, c)]
                x, y = xs[None, :], ys[:, None]
                dx = np.where(x == 0, right - v,
                              np.where(x == wl - 1, v - left, F32(0.5) * (right - left)))
                dy = np.where(y == 0, down - v,
                              np.where(y == hl - 1, v - up, F32(0.5) * (down - up)))
                for plane, val in enumerate((v, dx, dy)):
                    out[lvl][plane][np.ix_(ys, xs)] = val
    return out


def flow_blocks(n: int) -> int:
    """K5's grid for ``n`` points: a block per 256, at most 64."""
    return min(-(-n // FLOW_THREADS), FLOW_MAX_BLOCKS)


def flow_block_sums(terms: np.ndarray, ok: np.ndarray, blocks: int, finish=None,
                    threads: int = FLOW_THREADS):
    """K5's sum and count of one pose's squared ray distances ``terms`` [n]
    (f32) over the points where ``ok``, in the kernel's order: each thread's
    points (p = block · 256 + thread, striding by the grid) added in f64 in
    turn, a warp butterfly (xor 16, 8, 4, 2, 1), the warps in index order;
    each block's partial stored in its own place, then, by the block that
    finishes last (``finish``: the blocks' order of finishing, any
    permutation), the partials added in block index order → (f64 sum, count).
    ``threads``: a block's threads (the kernel before this design: one block
    of 1024).
    """
    n = terms.shape[0]
    stride = blocks * threads
    per_thread = np.zeros(stride)
    count = np.zeros(stride, np.int64)
    for start in range(0, n, stride):
        chunk = np.where(ok[start:start + stride], terms[start:start + stride].astype(np.float64),
                         0.0)
        per_thread[:chunk.shape[0]] += chunk
        count[:chunk.shape[0]] += ok[start:start + stride]
    lanes = per_thread.reshape(blocks, threads // 32, 32)
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ off]
    partial_sum = np.zeros(blocks)
    for w in range(threads // 32):
        partial_sum = partial_sum + lanes[:, w, 0]
    partial_count = count.reshape(blocks, -1).sum(axis=1)
    # the partials land in their places in finishing order; the last block
    # reads them all, in index order
    stored = np.full(blocks, np.nan)
    order = range(blocks) if finish is None else finish
    for b in order:
        stored[b] = partial_sum[b]
    total = 0.0
    for b in range(blocks):
        total += stored[b]
    return total, int(partial_count.sum())


def flow_from_sums(total: float, count: int) -> np.float32:
    """``sqrtf((float)sum / (float)max(count, 1))``."""
    return np.sqrt(F32(total) / F32(max(count, 1)))
