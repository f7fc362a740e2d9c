"""Corners and pyramidal Lucas–Kanade tracking for the feature-based
bootstrap, without cv2 (the counterparts of the two cv2 calls of
``dsopp_tpu/fbs/initializer.py``: ``cv2.goodFeaturesToTrack`` with 1000
corners, quality 0.01, min distance 8, and ``cv2.calcOpticalFlowPyrLK``
with a 21×21 window and 3 levels).

Each function has two forms:

* the torch version (:func:`good_features`, :func:`pyr_lk`), which the
  bootstrap runs on the tracker's device, the card included; the images
  stay there;
* the plain version (:func:`good_features_plain`, :func:`pyr_lk_plain`) in
  numpy on the host, with loops over points and iterations, which the tests
  hold both cv2 and the torch version to.

Both follow OpenCV's arithmetic.  The corner response is the smaller
eigenvalue of the 3×3 box sum of the Sobel products, in f32 with OpenCV's
fused multiply-adds (emulated in f64, one rounding), its box sums in f64
(OpenCV's sum type for f32): the torch and the plain version give cv2's
corners to the bit on the corridor frames.  The tracker keeps cv2's
fixed-point arithmetic: 14-bit interpolation weights, int16 Scharr
derivatives, the window scaled by 32; its sums are exact integer sums
rounded once to f32, where cv2 adds f32 products in SIMD lanes (the one
difference: positions within a few thousandths of a pixel of cv2's).

Images are [H, W] tensors (or arrays): u8 as they are, any other dtype
converted as numpy's ``astype(np.uint8)`` does on x86-64 (truncation, the
low 8 bits), as the JAX initializer hands them to cv2.  Neither function
reads the device but where it says so: ``good_features`` copies its sorted
candidates to the host once (twice when more than ``CANDIDATE_BLOCK``),
where the greedy spacing pass runs; ``pyr_lk`` runs a fixed number of
masked iterations and reads nothing.
"""

from __future__ import annotations

import numpy as np
import torch

# Sobel 3×3 with OpenCV's scale 1 / (2^(3-1) · 3 · 255) folded into the
# smoothing taps, as f32 (cornerEigenValsVecs on a u8 image)
_SOBEL_F0 = np.float32(2.0 / 3060.0)
_SOBEL_F1 = np.float32(1.0 / 3060.0)
W_BITS = 14                          # the interpolation weights' bits
FLT_SCALE = np.float32(1.0 / (1 << 20))
CANDIDATE_BLOCK = 32768              # sorted candidates copied to the host in one read


def as_u8(image):
    """``image`` as u8 the way ``np.asarray(image).astype(np.uint8)`` makes
    it on x86-64: truncation toward zero, the low 8 bits kept."""
    if isinstance(image, torch.Tensor):
        if image.dtype == torch.uint8:
            return image
        return torch.bitwise_and(torch.trunc(image).to(torch.int32), 255).to(torch.uint8)
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return (np.trunc(image).astype(np.int64) & 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# shared host pieces
# ---------------------------------------------------------------------------

def _spaced(order, width, max_corners, min_distance):
    """OpenCV's greedy pass over candidates sorted by response (raster
    indices): a candidate closer than ``min_distance`` to one kept is
    dropped; the search runs over a grid of cells of ``round(min_distance)``
    pixels.  → [M, 2] f32 (x, y)."""
    corners = []
    if min_distance >= 1:
        cell = int(np.rint(min_distance))
        grid = {}
        md2 = min_distance * min_distance
        for k in order:
            y, x = divmod(int(k), width)
            xc, yc = x // cell, y // cell
            good = True
            for yy in range(yc - 1, yc + 2):
                for xx in range(xc - 1, xc + 2):
                    for px, py in grid.get((xx, yy), ()):
                        dx, dy = np.float32(x - px), np.float32(y - py)
                        if dx * dx + dy * dy < md2:
                            good = False
                            break
                    if not good:
                        break
                if not good:
                    break
            if good:
                grid.setdefault((xc, yc), []).append((x, y))
                corners.append((x, y))
                if 0 < max_corners == len(corners):
                    break
    else:
        for k in order[:max_corners] if max_corners > 0 else order:
            y, x = divmod(int(k), width)
            corners.append((x, y))
    return np.asarray(corners, np.float32).reshape(-1, 2)


def _levels(height, width, win, max_level):
    """The levels ``buildOpticalFlowPyramid`` keeps: it stops at the level
    whose half-size would not exceed the window."""
    w, h = width, height
    for level in range(max_level + 1):
        w, h = (w + 1) // 2, (h + 1) // 2
        if w <= win or h <= win:
            return level
    return max_level


# ---------------------------------------------------------------------------
# plain versions (numpy, host)
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """f32 fused multiply-add a·b + c, one rounding (the product of two f32
    values is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def min_eigenvalues_plain(image):
    """``cv2.cornerMinEigenVal(image, 3, 3)`` of a u8 [H, W] array → f32."""
    p = np.pad(image.astype(np.float32), 1, mode="reflect")
    left, mid, right = p[:, :-2], p[:, 1:-1], p[:, 2:]
    diff = right - left
    dx = _fma32(_SOBEL_F1, diff[:-2] + diff[2:], _SOBEL_F0 * diff[1:-1])
    smooth = _fma32(_SOBEL_F1, right, _fma32(_SOBEL_F0, mid, _SOBEL_F1 * left))
    dy = smooth[2:] - smooth[:-2]
    h, w = dx.shape

    def box(c):
        q = np.pad(c.astype(np.float64), 1, mode="reflect")
        rows = q[:, 0:w] + q[:, 1:w + 1] + q[:, 2:w + 2]
        return (rows[0:h] + rows[1:h + 1] + rows[2:h + 2]).astype(np.float32)

    a = box(dx * dx) * np.float32(0.5)
    b = box(dx * dy)
    c = box(dy * dy) * np.float32(0.5)
    return (a + c) - np.sqrt((a - c) * (a - c) + b * b)


def good_features_plain(image, max_corners=1000, quality=0.01, min_distance=8.0):
    """``cv2.goodFeaturesToTrack(image, max_corners, quality, min_distance)``
    (block size 3, no Harris) on the host → [M, 2] f32 corners."""
    image = as_u8(image)
    eig = min_eigenvalues_plain(image)
    h, w = eig.shape
    thr = np.float32(np.float64(eig.max()) * quality)
    eig = np.where(eig > thr, eig, np.float32(0.0))
    pad = np.pad(eig, 1, mode="constant", constant_values=-np.inf)
    dilated = np.max(np.stack([pad[i:i + h, j:j + w] for i in range(3) for j in range(3)]), 0)
    cand = (eig != 0) & (eig == dilated)
    cand[0] = cand[-1] = False
    cand[:, 0] = cand[:, -1] = False
    idx = np.flatnonzero(cand)
    # response descending, then the larger raster index first (greaterThanPtr)
    order = idx[np.lexsort((-idx, -eig.ravel()[idx]))]
    return _spaced(order, w, max_corners, min_distance)


def pyr_down_plain(image):
    """``cv2.pyrDown`` of a u8 array: the 5×5 binomial kernel, reflect-101
    borders, (sum + 128) >> 8."""
    h, w = image.shape
    p = np.pad(image.astype(np.int64), 2, mode="reflect")
    k = (1, 4, 6, 4, 1)
    dh, dw = (h + 1) // 2, (w + 1) // 2
    rows = sum(k[i] * p[:, i:i + 2 * dw:2] for i in range(5))
    s = sum(k[i] * rows[i:i + 2 * dh:2] for i in range(5))
    return ((s + 128) >> 8).astype(np.uint8)


def scharr_plain(image):
    """OpenCV's ``calcSharrDeriv`` of a u8 array → (Ix, Iy) int16: 3·10·3
    smoothing across, a central difference along, reflect-101 borders."""
    p = np.pad(image.astype(np.int32), 1, mode="reflect")
    t0 = (p[:-2] + p[2:]) * 3 + p[1:-1] * 10
    t1 = p[2:] - p[:-2]
    ix = t0[:, 2:] - t0[:, :-2]
    iy = (t1[:, 2:] + t1[:, :-2]) * 3 + t1[:, 1:-1] * 10
    return ix.astype(np.int16), iy.astype(np.int16)


def _weights_plain(a, b):
    one, s = np.float32(1.0), np.float32(1 << W_BITS)
    w00 = int(np.rint((one - a) * (one - b) * s))
    w01 = int(np.rint(a * (one - b) * s))
    w10 = int(np.rint((one - a) * b * s))
    return w00, w01, w10, (1 << W_BITS) - w00 - w01 - w10


def _window_plain(src, y0, x0, weights, win, bits):
    w00, w01, w10, w11 = weights
    a = src[y0:y0 + win + 1, x0:x0 + win + 1].astype(np.int64)
    s = a[:-1, :-1] * w00 + a[:-1, 1:] * w01 + a[1:, :-1] * w10 + a[1:, 1:] * w11
    return (s + (1 << (bits - 1))) >> bits


def pyr_lk_plain(prev, nxt, points, win=21, max_level=3, iterations=30, epsilon=0.01,
                 min_eig_threshold=1e-4):
    """``cv2.calcOpticalFlowPyrLK(prev, nxt, points, None, winSize=(win, win),
    maxLevel=max_level)`` with its default criteria on the host, a point at a
    time → (next points [N, 2] f32, status [N] bool)."""
    prev, nxt = as_u8(prev), as_u8(nxt)
    points = np.asarray(points, np.float32).reshape(-1, 2)
    levels = _levels(prev.shape[0], prev.shape[1], win, max_level)
    pyr_i, pyr_j = [prev], [nxt]
    for _ in range(levels):
        pyr_i.append(pyr_down_plain(pyr_i[-1]))
        pyr_j.append(pyr_down_plain(pyr_j[-1]))
    half = np.float32((win - 1) * 0.5)
    eps2 = epsilon * epsilon
    n = len(points)
    out = np.zeros_like(points)
    status = np.ones(n, bool)
    for level in range(levels, -1, -1):
        h, w = pyr_i[level].shape
        img_i = np.pad(pyr_i[level], win, mode="reflect")
        img_j = np.pad(pyr_j[level], win, mode="reflect")
        ix, iy = scharr_plain(pyr_i[level])
        dxs, dys = np.pad(ix, win), np.pad(iy, win)
        scale = np.float32(1.0 / (1 << level))
        for k in range(n):
            prev_pt = points[k] * scale
            next_pt = prev_pt.copy() if level == levels else out[k] * np.float32(2.0)
            out[k] = next_pt
            prev_pt = prev_pt - half
            x0, y0 = int(np.floor(prev_pt[0])), int(np.floor(prev_pt[1]))
            if x0 < -win or x0 >= w or y0 < -win or y0 >= h:
                if level == 0:
                    status[k] = False
                continue
            wts = _weights_plain(prev_pt[0] - np.float32(x0), prev_pt[1] - np.float32(y0))
            i_win = _window_plain(img_i, y0 + win, x0 + win, wts, win, W_BITS - 5)
            dx = _window_plain(dxs, y0 + win, x0 + win, wts, win, W_BITS)
            dy = _window_plain(dys, y0 + win, x0 + win, wts, win, W_BITS)
            a11 = np.float32(np.sum(dx * dx)) * FLT_SCALE
            a12 = np.float32(np.sum(dx * dy)) * FLT_SCALE
            a22 = np.float32(np.sum(dy * dy)) * FLT_SCALE
            det = a11 * a22 - a12 * a12
            min_eig = (a22 + a11 - np.sqrt((a11 - a22) * (a11 - a22) + np.float32(4.0) * a12 * a12)
                       ) / np.float32(2 * win * win)
            if min_eig < np.float32(min_eig_threshold) or det < np.finfo(np.float32).eps:
                if level == 0:
                    status[k] = False
                continue
            inv_det = np.float32(1.0) / det
            next_pt = next_pt - half
            prev_delta = None
            for j in range(iterations):
                x1, y1 = int(np.floor(next_pt[0])), int(np.floor(next_pt[1]))
                if x1 < -win or x1 >= w or y1 < -win or y1 >= h:
                    if level == 0:
                        status[k] = False
                    break
                wj = _weights_plain(next_pt[0] - np.float32(x1), next_pt[1] - np.float32(y1))
                diff = _window_plain(img_j, y1 + win, x1 + win, wj, win, W_BITS - 5) - i_win
                b1 = np.float32(np.sum(diff * dx)) * FLT_SCALE
                b2 = np.float32(np.sum(diff * dy)) * FLT_SCALE
                delta = np.array([(a12 * b2 - a22 * b1) * inv_det,
                                  (a12 * b1 - a11 * b2) * inv_det], np.float32)
                next_pt = next_pt + delta
                out[k] = next_pt + half
                if float(delta[0]) ** 2 + float(delta[1]) ** 2 <= eps2:
                    break
                if (j > 0 and abs(delta[0] + prev_delta[0]) < 0.01
                        and abs(delta[1] + prev_delta[1]) < 0.01):
                    out[k] = out[k] - delta * np.float32(0.5)
                    break
                prev_delta = delta
            if level == 0 and status[k]:
                # cv2 computes the error of a tracked point, and fails one
                # whose last step left the level
                x1, y1 = (int(v) for v in np.floor(out[k] - half))
                if x1 < -win or x1 >= w or y1 < -win or y1 >= h:
                    status[k] = False
    return out, status


# ---------------------------------------------------------------------------
# torch versions (the device the images are on)
# ---------------------------------------------------------------------------

def _reflect_index(n, pad, device):
    """Indices of a reflect-101 border of ``pad`` around ``n`` entries."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n - 2
    i = i.abs() % period
    return torch.where(i < n, i, period - i)


def _pad_reflect(x, pad):
    h, w = x.shape
    return x[_reflect_index(h, pad, x.device)][:, _reflect_index(w, pad, x.device)]


def _fma(a, b, c):
    return (a.double() * b + c.double()).float()


def min_eigenvalues(image):
    """``cv2.cornerMinEigenVal(image, 3, 3)`` of a u8 [H, W] tensor → f32,
    on its device."""
    p = _pad_reflect(image, 1).float()
    left, mid, right = p[:, :-2], p[:, 1:-1], p[:, 2:]
    diff = right - left
    dx = _fma(diff[:-2] + diff[2:], float(_SOBEL_F1), diff[1:-1] * float(_SOBEL_F0))
    smooth = _fma(right, float(_SOBEL_F1), _fma(mid, float(_SOBEL_F0), left * float(_SOBEL_F1)))
    dy = smooth[2:] - smooth[:-2]

    def box(c):
        q = _pad_reflect(c.double(), 1)
        rows = q[:, :-2] + q[:, 1:-1] + q[:, 2:]
        return (rows[:-2] + rows[1:-1] + rows[2:]).float()

    a = box(dx * dx) * 0.5
    b = box(dx * dy)
    c = box(dy * dy) * 0.5
    return (a + c) - torch.sqrt((a - c) * (a - c) + b * b)


def good_features(image, max_corners=1000, quality=0.01, min_distance=8.0):
    """The torch counterpart of ``cv2.goodFeaturesToTrack`` (block size 3,
    no Harris): the response, its threshold, the 3×3 maxima and their order
    on ``image``'s device; the sorted candidates come to the host in one
    read, where the greedy spacing pass runs → [M, 2] f32 numpy corners."""
    image = as_u8(image)
    h, w = image.shape
    eig = min_eigenvalues(image)
    thr = (eig.max().double() * quality).float()
    eig = torch.where(eig > thr, eig, torch.zeros_like(eig))
    dilated = torch.nn.functional.max_pool2d(eig[None, None], 3, stride=1, padding=1)[0, 0]
    cand = (eig != 0) & (eig == dilated)
    cand[0] = False
    cand[-1] = False
    cand[:, 0] = False
    cand[:, -1] = False
    # descending response, ties to the larger raster index: a stable sort of
    # the pixels in reverse raster order
    score = torch.where(cand, eig, torch.full_like(eig, -1.0)).reshape(-1).flip(0)
    _, order = torch.sort(score, descending=True, stable=True)
    raster = (h * w - 1) - order
    count = cand.sum()
    block = min(h * w, CANDIDATE_BLOCK)
    host = torch.cat([count.reshape(1), raster[:block]]).cpu().numpy()
    n = int(host[0])
    order = host[1:1 + n]
    if n > block:
        order = raster[:n].cpu().numpy()
    return _spaced(order, w, max_corners, min_distance)


def pyr_down(image):
    """``cv2.pyrDown`` of a u8 tensor on its device (integer arithmetic)."""
    h, w = image.shape
    p = _pad_reflect(image.to(torch.int32), 2)
    k = (1, 4, 6, 4, 1)
    dh, dw = (h + 1) // 2, (w + 1) // 2
    rows = sum(k[i] * p[:, i:i + 2 * dw:2] for i in range(5))
    s = sum(k[i] * rows[i:i + 2 * dh:2] for i in range(5))
    return ((s + 128) >> 8).to(torch.uint8)


def scharr(image):
    """``calcSharrDeriv`` of a u8 tensor → (Ix, Iy) int32 (values of int16)."""
    p = _pad_reflect(image.to(torch.int32), 1)
    t0 = (p[:-2] + p[2:]) * 3 + p[1:-1] * 10
    t1 = p[2:] - p[:-2]
    return (t0[:, 2:] - t0[:, :-2],
            (t1[:, 2:] + t1[:, :-2]) * 3 + t1[:, 1:-1] * 10)


def _weights(frac):
    """[N, 2] f32 fractions → [N, 4] int32 weights (w00, w01, w10, w11)."""
    a, b = frac[:, 0], frac[:, 1]
    s = float(1 << W_BITS)
    w00 = torch.round((1.0 - a) * (1.0 - b) * s).to(torch.int32)
    w01 = torch.round(a * (1.0 - b) * s).to(torch.int32)
    w10 = torch.round((1.0 - a) * b * s).to(torch.int32)
    return torch.stack([w00, w01, w10, (1 << W_BITS) - w00 - w01 - w10], -1)


def _windows(flat, stride, origin, offsets, weights, win, bits):
    """Bilinear windows at integer origins [N, 2] (x, y) of the padded
    image ``flat`` (row stride ``stride``) → [N, win, win] int32."""
    base = origin[:, 1] * stride + origin[:, 0]
    a = flat[base[:, None, None] + offsets].to(torch.int32)
    wt = weights[:, :, None, None]
    s = (a[:, :-1, :-1] * wt[:, 0] + a[:, :-1, 1:] * wt[:, 1]
         + a[:, 1:, :-1] * wt[:, 2] + a[:, 1:, 1:] * wt[:, 3])
    return (s + (1 << (bits - 1))) >> bits


def _inside(corner, w, h, win):
    """Window corners [N, 2] (floored, f32) → (inside the level as cv2
    tests it, the corners clamped there and moved into the padded image)."""
    x = corner[:, 0].to(torch.int64)
    y = corner[:, 1].to(torch.int64)
    ok = (x >= -win) & (x < w) & (y >= -win) & (y < h)
    return ok, torch.stack([x.clamp(-win, w - 1), y.clamp(-win, h - 1)], -1) + win


def pyr_lk(prev, nxt, points, win=21, max_level=3, iterations=30, epsilon=0.01,
           min_eig_threshold=1e-4):
    """The torch counterpart of ``cv2.calcOpticalFlowPyrLK(prev, nxt, points,
    None, winSize=(win, win), maxLevel=max_level)`` with its default
    criteria (30 iterations, ε 0.01, min eigenvalue 1e-4), batched over the
    points on their device: Bouguet's method on ``pyrDown`` pyramids with
    Scharr derivatives, every point through ``iterations`` masked
    iterations a level (a point stops at a step below ε, or at cv2's
    oscillation test), no host read → (next points [N, 2] f32, status [N]
    bool: false where the window's gradient matrix falls under the
    eigenvalue threshold or the point leaves the level)."""
    prev, nxt = as_u8(prev), as_u8(nxt)
    dev = points.device
    pts = points.to(torch.float32).reshape(-1, 2)
    n = pts.shape[0]
    levels = _levels(prev.shape[0], prev.shape[1], win, max_level)
    pyr_i, pyr_j = [prev], [nxt]
    for _ in range(levels):
        pyr_i.append(pyr_down(pyr_i[-1]))
        pyr_j.append(pyr_down(pyr_j[-1]))
    half = float((win - 1) * 0.5)
    eps2 = epsilon * epsilon
    out = torch.zeros_like(pts)
    status = torch.ones(n, dtype=torch.bool, device=dev)
    for level in range(levels, -1, -1):
        h, w = pyr_i[level].shape
        stride = w + 2 * win
        r = torch.arange(win + 1, device=dev)
        offsets = (r[:, None] * stride + r[None, :])[None]
        img_i = _pad_reflect(pyr_i[level], win).reshape(-1)
        img_j = _pad_reflect(pyr_j[level], win).reshape(-1)
        ix, iy = scharr(pyr_i[level])
        dxs = torch.nn.functional.pad(ix, (win, win, win, win)).reshape(-1)
        dys = torch.nn.functional.pad(iy, (win, win, win, win)).reshape(-1)
        prev_pt = pts * float(np.float32(1.0 / (1 << level)))
        next_pt = prev_pt if level == levels else out * 2.0
        out = next_pt.clone()
        prev_pt = prev_pt - half
        ok, origin = _inside(torch.floor(prev_pt), w, h, win)
        wts = _weights(prev_pt - torch.floor(prev_pt))
        i_win = _windows(img_i, stride, origin, offsets, wts, win, W_BITS - 5)
        dx = _windows(dxs, stride, origin, offsets, wts, win, W_BITS)
        dy = _windows(dys, stride, origin, offsets, wts, win, W_BITS)
        a11 = (dx * dx).sum((1, 2)).float() * float(FLT_SCALE)
        a12 = (dx * dy).sum((1, 2)).float() * float(FLT_SCALE)
        a22 = (dy * dy).sum((1, 2)).float() * float(FLT_SCALE)
        det = a11 * a22 - a12 * a12
        # a division by a tensor: torch divides by a Python scalar through its
        # reciprocal on the card
        min_eig = (a22 + a11 - torch.sqrt((a11 - a22) * (a11 - a22) + 4.0 * a12 * a12)
                   ) / torch.full_like(a11, float(2 * win * win))
        ok &= (min_eig >= float(np.float32(min_eig_threshold))) & (
            det >= float(np.finfo(np.float32).eps))
        if level == 0:
            status &= ok
        inv_det = 1.0 / det
        active = ok
        run = next_pt - half
        prev_delta = torch.zeros_like(pts)
        for j in range(iterations):
            corner = torch.floor(run)
            inside, origin = _inside(corner, w, h, win)
            if level == 0:
                status &= ~(active & ~inside)
            active = active & inside
            wj = _weights(run - corner)
            diff = _windows(img_j, stride, origin, offsets, wj, win, W_BITS - 5) - i_win
            b1 = (diff * dx).sum((1, 2)).float() * float(FLT_SCALE)
            b2 = (diff * dy).sum((1, 2)).float() * float(FLT_SCALE)
            delta = torch.stack([(a12 * b2 - a22 * b1) * inv_det,
                                 (a12 * b1 - a11 * b2) * inv_det], -1)
            step = active[:, None]
            run = torch.where(step, run + delta, run)
            out = torch.where(step, run + half, out)
            done = active & ((delta.double() ** 2).sum(-1) <= eps2)
            if j > 0:
                swing = ((delta + prev_delta).abs().double() < 0.01).all(-1) & active & ~done
                out = torch.where(swing[:, None], out - delta * 0.5, out)
                done = done | swing
            prev_delta = torch.where(step, delta, prev_delta)
            active = active & ~done
    # cv2 computes the error of a tracked point, and fails one whose last
    # step left the level
    status &= _inside(torch.floor(out - half), w, h, win)[0]
    return out, status
