"""Pixel maps and their sampling (counterpart of
``dsopp_tpu/core/interpolate.py`` and of the window semantics of
``dsopp_tpu/ops/patch.py``).

A pixel map is ``[3, H, W]`` of (intensity, d/dx, d/dy), gradients being
½·central differences inside the image and one-sided at the border; a
C-channel map (a frame embedder's) is ``[3C, H, W]`` in the JAX package's
group layout ``[values C | d/dx C | d/dy C]``.

Two samplers:

* :func:`sample` — plain bilinear interpolation of every map channel
  (the reference's ``PixelMap::Evaluate``); :func:`sample_stack` the same on
  S maps of a stack, each at its own points;
* :func:`sample_window` / :func:`sample_window_values` — the semantics of
  the JAX package's 10×10 patch windows, sampled directly from the
  intensity image: a group of points reads one window based at
  ``floor(center) − 4``; a point whose bilinear corners (plus the ±1
  gradient halo) leave that window is invalid, pixels outside the image
  read as 0, and gradients are ½·central differences of raw intensities.
  The window is kept as a validity rule only; nothing is tabulated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PATCH_WIN = 10   # window side: pattern ±2, bilinear +1, gradient halo ±1
PATCH_LO = 4     # window base = floor(center) − PATCH_LO
WINDOW_PAD = 5   # zero border that keeps every window read in bounds


def image_gradients(image):
    """[..., H, W] → (dx, dy): ½·central differences inside, one-sided
    (undivided) differences at the first/last row and column."""
    dx = torch.cat([image[..., :, 1:2] - image[..., :, 0:1],
                    0.5 * (image[..., :, 2:] - image[..., :, :-2]),
                    image[..., :, -1:] - image[..., :, -2:-1]], dim=-1)
    dy = torch.cat([image[..., 1:2, :] - image[..., 0:1, :],
                    0.5 * (image[..., 2:, :] - image[..., :-2, :]),
                    image[..., -1:, :] - image[..., -2:-1, :]], dim=-2)
    return dx, dy


def build_pixel_map(image):
    """[H, W] intensity → [3, H, W] (intensity, dx, dy); [C, H, W] channels →
    [3C, H, W] (values C | dx C | dy C); [S, C, H, W] → [S, 3C, H, W]."""
    if image.dim() == 2:
        image = image[None]
    dx, dy = image_gradients(image)
    return torch.cat([image, dx, dy], dim=-3)


def bilinear_weights(uv, height, width):
    """Corner base index, corner weights [..., 4] and inside mask for ``uv``.

    Corner order (iy,ix), (iy,ix+1), (iy+1,ix), (iy+1,ix+1); the fraction is
    taken against the unclamped floor, the index is clamped."""
    x, y = uv[..., 0], uv[..., 1]
    ix = torch.floor(x)
    iy = torch.floor(y)
    fx = x - ix
    fy = y - iy
    inside = (x >= 0) & (y >= 0) & (x <= width - 1) & (y <= height - 1)
    ix = torch.clamp(ix.long(), 0, width - 2)
    iy = torch.clamp(iy.long(), 0, height - 2)
    weights = torch.stack([(1.0 - fx) * (1.0 - fy), fx * (1.0 - fy),
                           (1.0 - fx) * fy, fx * fy], dim=-1)
    return iy * width + ix, weights, inside


def sample(pixel_map, uv):
    """Sample a ``[C, H, W]`` map at ``uv`` [..., 2] → ([..., C], inside)."""
    c, h, w = pixel_map.shape
    base, weights, inside = bilinear_weights(uv, h, w)
    flat = pixel_map.reshape(c, h * w)
    idx = torch.stack([base, base + 1, base + w, base + w + 1], dim=-1)
    g = flat[:, idx.reshape(-1)].reshape((c,) + idx.shape)      # [C, ..., 4]
    out = torch.sum(g * weights.to(pixel_map.dtype), dim=-1)    # [C, ...]
    return torch.movedim(out, 0, -1), inside


def sample_stack(maps, rows, uv):
    """Sample S maps of a stack ``maps`` [B, C, H, W], map ``rows[z]`` at
    ``uv[z]`` (``uv`` [S, ..., 2]; ``rows`` an [S] long device list, None: map
    z) → ([S, ..., C], inside).  Sequence z's values are those of
    :func:`sample` of its map at its points: the same gathers, products and
    4-term sums."""
    b, c, h, w = maps.shape
    s = uv.shape[0]
    base, weights, inside = bilinear_weights(uv, h, w)
    idx = torch.stack([base, base + 1, base + w, base + w + 1], dim=-1)   # [S, ..., 4]
    if rows is None:
        rows = torch.arange(s, device=maps.device)
    g = maps.reshape(b, c, h * w)[rows.view(s, 1), :, idx.reshape(s, -1)]  # [S, X, C]
    g = g.movedim(-1, 1).reshape((s, c) + tuple(idx.shape[1:]))          # [S, C, ..., 4]
    out = torch.sum(g * weights.unsqueeze(1).to(maps.dtype), dim=-1)     # [S, C, ...]
    return torch.movedim(out, 1, -1), inside


def pad_images(images):
    """[..., H, W] → [..., H+2·5, W+2·5] zero-bordered window source."""
    return F.pad(images, (WINDOW_PAD,) * 4)


def window_base(center, height, width):
    """Window base (bx, by) of a group whose center is ``center`` [..., 2]."""
    cx = torch.clamp(torch.floor(center[..., 0]).long(), 0, width - 1)
    cy = torch.clamp(torch.floor(center[..., 1]).long(), 0, height - 1)
    return cx - PATCH_LO, cy - PATCH_LO


def _window_coords(uv, bx, by, height, width, lo, hi):
    x, y = uv[..., 0], uv[..., 1]
    inside = (x >= 0) & (y >= 0) & (x <= width - 1) & (y <= height - 1)
    ix = torch.clamp(torch.floor(x).long(), 0, width - 2)
    iy = torch.clamp(torch.floor(y).long(), 0, height - 2)
    fx = x - ix.to(x.dtype)
    fy = y - iy.to(y.dtype)
    dxi = ix - bx
    dyi = iy - by
    in_win = (dxi >= lo) & (dxi <= hi) & (dyi >= lo) & (dyi <= hi)
    col = bx + torch.clamp(dxi, lo, hi)
    row = by + torch.clamp(dyi, lo, hi)
    return fx, fy, col, row, inside & in_win


def _reader(padded, img_idx, height, width):
    hp, wp = height + 2 * WINDOW_PAD, width + 2 * WINDOW_PAD
    flat = padded.reshape(-1)

    def read(row, col):
        idx = (row + WINDOW_PAD) * wp + (col + WINDOW_PAD)
        if img_idx is not None:
            idx = idx + img_idx * (hp * wp)
        return flat[idx]
    return read


def sample_window_values(padded, uv, bx, by, height, width, img_idx=None):
    """Bilinear VALUES at ``uv`` [..., 2] read from the window (bx, by).

    ``padded``: :func:`pad_images` output, one image or a stack indexed by
    ``img_idx``.  Corners may sit anywhere in the 10×10 window.
    Returns (vals [...], ok [...]) with ok = inside image & inside window.
    """
    fx, fy, col, row, ok = _window_coords(uv, bx, by, height, width, 0, PATCH_WIN - 2)
    read = _reader(padded, img_idx, height, width)
    t0 = read(row, col) * (1.0 - fy) + read(row + 1, col) * fy
    t1 = read(row, col + 1) * (1.0 - fy) + read(row + 1, col + 1) * fy
    return t0 * (1.0 - fx) + t1 * fx, ok


def sample_window(padded, uv, bx, by, height, width, img_idx=None):
    """Values and ½·central-difference gradients at ``uv`` from the window.

    Corners plus the ±1 gradient halo must stay inside the window.
    Returns (vals, gx, gy, ok), each [...].
    """
    fx, fy, col, row, ok = _window_coords(uv, bx, by, height, width, 1, PATCH_WIN - 3)
    read = _reader(padded, img_idx, height, width)
    wy0, wy1 = 1.0 - fy, fy
    wx0, wx1 = 1.0 - fx, fx
    # y contracted first (values and dx), x first for dy
    ty = [read(row, col + d) * wy0 + read(row + 1, col + d) * wy1 for d in (-1, 0, 1, 2)]
    tx = [read(row + d, col) * wx0 + read(row + d, col + 1) * wx1 for d in (-1, 0, 1, 2)]
    vals = ty[1] * wx0 + ty[2] * wx1
    gx = ((ty[0] * (-0.5 * wx0) + ty[1] * (-0.5 * wx1))
          + ty[2] * (0.5 * wx0)) + ty[3] * (0.5 * wx1)
    gy = ((tx[0] * (-0.5 * wy0) + tx[1] * (-0.5 * wy1))
          + tx[2] * (0.5 * wy0)) + tx[3] * (0.5 * wy1)
    return vals, gx, gy, ok
