"""Port parity of the candidate selection (K12) against the JAX package, and
host models of the kernel's algorithm (``csrc/candidates.cu``).

* ``select_candidates`` (JAX on the CPU in x64 against the port's plain
  version in f64, inputs from a numpy seed): uv, validity and slot order
  exact, grad2 1e-12 relative — at 120×160 and at a size that is a multiple of
  neither the 32-pixel region nor the tile, with no mask, a half mask and a
  random mask, with ``num_points`` above the tile count, and on an image of
  constant gradient (every score a tie);
* the kernel's three steps as numpy models against the plain version: the
  50-bin histogram median against ``_region_threshold``; the per-tile first
  argmax; the rank-by-counting slot order (a warp a tile, per-lane counts over
  the staged scores, then a warp sum) against ``top_k_stable``, also where
  every score ties and with masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.features import extractor as jext
from dsopp_tpu_torch.features import extractor as text

from tests._torch_port import assert_close, assert_equal, to_torch


def _pixel_map(h, w, seed, constant=False):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w))
    if constant:
        # g2 = 0.61 in every pixel: bin 0, threshold 0, so every allowed pixel
        # scores the same
        dx, dy = np.full((h, w), 0.6), np.full((h, w), -0.5)
    else:
        dx, dy = rng.normal(0, 20, (h, w)), rng.normal(0, 20, (h, w))
        dx[: h // 3, : w // 4] *= 0.05          # a flat corner: regions with a low median
    return np.stack([img, dx, dy])


def _mask(kind, h, w, seed):
    if kind == "none":
        return None
    mask = np.ones((h, w), bool)
    if kind == "half":
        mask[:, : w // 2] = False
    else:
        mask = np.random.default_rng(seed).random((h, w)) < 0.6
    return mask


CASES = [
    # h, w, num_points, mask, constant gradient
    (120, 160, 200, "none", False),
    (120, 160, 200, "half", False),
    (120, 160, 200, "random", False),
    (120, 160, 6000, "none", False),        # more slots than the 60 x 80 tiles of 2 x 2
    (100, 150, 300, "none", False),         # 3.125 x 4.69 regions, tile 5: ragged edges
    (100, 150, 300, "random", False),
    (100, 150, 160, "half", True),          # all ties: order by tile index alone
    (120, 160, 500, "none", True),
]


@pytest.mark.parametrize("h,w,num_points,mask_kind,constant", CASES)
def test_select_candidates_matches_with_masks_and_ties(h, w, num_points, mask_kind, constant):
    pm = _pixel_map(h, w, seed=h + num_points, constant=constant)
    mask = _mask(mask_kind, h, w, seed=3)
    ref = jext.select_candidates(jnp.asarray(pm), num_points,
                                 mask=None if mask is None else jnp.asarray(mask))
    out = text.select_candidates(to_torch(pm), num_points,
                                 mask=None if mask is None else torch.as_tensor(mask))
    assert out.uv.shape == (num_points, 2) and out.valid.shape == (num_points,)
    assert_equal(out.uv, ref.uv)                 # slot by slot: the bank's order
    assert_equal(out.valid, ref.valid)
    assert_close(out.grad2, ref.grad2, rtol=1e-12)
    valid = np.asarray(ref.valid)
    assert valid.any()
    if mask is not None:
        uv = np.asarray(ref.uv)[valid].astype(int)
        assert mask[uv[:, 1], uv[:, 0]].all()
    tiles = (h // text._tile_size(h, w, num_points, 0)) * (w // text._tile_size(h, w, num_points, 0))
    if num_points > tiles:
        assert not valid[tiles:].any()           # the padded slots


# -- host models of csrc/candidates.cu ---------------------------------------

def _region_threshold_model(g2, factor):
    """One block per region: a 50-bin histogram, the first bin whose running
    count exceeds half the region, squared, × factor; pixels beyond the last
    whole region take the nearest region's threshold."""
    h, w = g2.shape
    rh, rw = h // 32, w // 32
    thr = np.zeros((rh, rw), g2.dtype)
    for ry in range(rh):
        for rx in range(rw):
            block = g2[ry * 32:(ry + 1) * 32, rx * 32:(rx + 1) * 32]
            bins = np.minimum(np.sqrt(block), 49.0).astype(np.int64).reshape(-1)
            hist = np.bincount(bins, minlength=50)
            run, med = 0, 0
            for b in range(50):
                run += hist[b]
                if run > (32 * 32) // 2:
                    med = b
                    break
            thr[ry, rx] = g2.dtype.type(med) * g2.dtype.type(med) * g2.dtype.type(factor)
    yy = np.minimum(np.arange(h) // 32, rh - 1)
    xx = np.minimum(np.arange(w) // 32, rw - 1)
    return thr[yy[:, None], xx[None, :]]


def _tile_argmax_model(score, block):
    """One warp per tile: the lanes stride over the tile's pixels in row-major
    order keeping their first maximum, then a reduction that prefers the larger
    score and, among equal ones, the lower position."""
    h, w = score.shape
    bh, bw = h // block, w // block
    best = np.zeros((bh, bw), score.dtype)
    pos = np.zeros((bh, bw, 2), np.int64)
    for ty in range(bh):
        for tx in range(bw):
            lanes = []
            for lane in range(32):
                top, at = -2.0, 0
                for i in range(lane, block * block, 32):
                    s = score[ty * block + i // block, tx * block + i % block]
                    if s > top:
                        top, at = s, i
                lanes.append((top, at))
            top, at = lanes[0]
            for other, other_at in lanes[1:]:
                if other > top or (other == top and other_at < at):
                    top, at = other, other_at
            best[ty, tx] = top
            pos[ty, tx] = (tx * block + at % block, ty * block + at // block)
    return best.reshape(-1), pos.reshape(-1, 2)


def _rank_model(scores, num_points):
    """A warp a tile: lane l counts the tiles l, l + 32, ... (the kernel
    stages the scores 4096 at a time, a multiple of 32, so a tile's lane is
    its index mod 32) that have a larger score or an equal score and a lower
    index; a warp sum of the 32 counts is the rank, and the slot of a tile
    is its rank → (tile of each slot or −1, ...)."""
    t = scores.shape[0]
    idx = np.arange(t)
    before = ((scores[None, :] > scores[:, None])
              | ((scores[None, :] == scores[:, None]) & (idx[None, :] < idx[:, None])))
    lanes = np.zeros((t, -(-t // 32) * 32), np.int64)
    lanes[:, :t] = before
    lanes = lanes.reshape(t, -1, 32).sum(axis=1)       # [tiles, 32]: each lane's count
    rank = lanes.sum(axis=1)
    slots = np.full(num_points, -1)
    keep = rank < num_points
    slots[rank[keep]] = idx[keep]
    return slots


@pytest.mark.parametrize("h,w,num_points,mask_kind,constant", CASES[:3] + CASES[4:7])
def test_kernel_algorithm_models_match_plain(h, w, num_points, mask_kind, constant):
    pm = _pixel_map(h, w, seed=h + num_points, constant=constant).astype(np.float32)
    mask = _mask(mask_kind, h, w, seed=3)
    g2 = pm[1] * pm[1] + pm[2] * pm[2]
    thr = _region_threshold_model(g2, np.float32(2.0))
    assert_equal(thr, text._region_threshold(torch.tensor(g2), 2.0))

    block = text._tile_size(h, w, num_points, 0)
    yy, xx = np.arange(h)[:, None], np.arange(w)[None, :]
    allowed = (yy >= 4) & (yy < h - 4) & (xx >= 4) & (xx < w - 4)
    if mask is not None:
        allowed &= mask
    score = np.where(allowed & (g2 > thr), g2, np.float32(-1.0))
    best, pos = _tile_argmax_model(score, block)
    slots = _rank_model(best, num_points)

    plain = text.select_candidates_plain(torch.tensor(pm), num_points,
                                         None if mask is None else torch.as_tensor(mask))
    filled = slots >= 0
    uv = np.where(filled[:, None], pos[np.maximum(slots, 0)], 0).astype(np.float32)
    top = np.where(filled, best[np.maximum(slots, 0)], np.float32(-1.0))
    assert_equal(uv, plain.uv)
    assert_equal(top > 0, plain.valid)
    assert_equal(np.maximum(top, 0), plain.grad2)
    # the rank is the stable descending sort's order
    _, order = text.top_k_stable(torch.tensor(best), min(num_points, best.shape[0]))
    assert_equal(slots[: order.shape[0]], order)
