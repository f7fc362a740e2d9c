"""Port parity of the frontend's depth maps (K16) against the JAX package, and
host models of the kernel's algorithm (``csrc/depth_maps.cu``).

* ``build_frontend_state`` (JAX on the CPU in x64 against the port's plain
  version in f64) on a 4-frame window and on the dense operating point's 17
  slots: weights exact, the selected pixels of every valid slot exact,
  validity exact, idepth 1e-12 relative, intensity exact; level 4 (7×10
  pixels) pads its slots;
* the weight-class counting selection as a numpy model against
  ``top_k_stable`` on weight grids with many ties (hypothesis), with
  ``max_points`` below and above the number of positive pixels and above the
  grid's size;
* the fixed-order scatter sum as a numpy model against ``index_add_`` in f64
  (which adds in index order on the CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dsopp_tpu.features.pyramid import build_pyramid_maps
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import build_test_window
from dsopp_tpu.tracker import depth_map as jdm
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.features.extractor import top_k_stable
from dsopp_tpu_torch.tracker import depth_map as tdm

from tests._torch_port import assert_close, assert_equal, to_np, to_torch, window_fields

H, W, LEVELS, MAX_POINTS = 120, 160, 5, 300


@pytest.mark.parametrize("frames,slots,landmarks", [([0, 2, 4, 6], 6, 96),
                                                    (list(range(13)), 17, 40)])
def test_build_frontend_state_matches(frames, slots, landmarks):
    seq = render_sequence(num_frames=frames[-1] + 1, height=H, width=W)
    window = build_test_window(seq, frames, num_landmarks=landmarks, slots=slots, seed=5)
    # some outliers and dead slots, which add nothing
    rng = np.random.default_rng(1)
    window = dataclasses.replace(
        window, lm_outlier=jnp.asarray(rng.random((slots, landmarks)) < 0.1),
        lm_valid=window.lm_valid & jnp.asarray(rng.random((slots, landmarks)) < 0.9))
    maps = build_pyramid_maps(jnp.asarray(seq.images[frames[-1]]), LEVELS)
    cam = seq.camera
    idep_j, wei_j, pts_j, flow_j = jdm.build_frontend_state(window, cam, tuple(maps), H, W,
                                                            LEVELS, MAX_POINTS)
    model = convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size)
    idep_t, wei_t, pts_t, flow_t = tdm.build_frontend_state(
        convert.window(window_fields(window)), model, tuple(to_torch(m) for m in maps), H, W,
        LEVELS, MAX_POINTS)
    assert int((to_np(wei_t[0]) > 0).sum()) > 100
    for level in range(LEVELS):
        assert_equal(wei_t[level], wei_j[level])
        assert_close(idep_t[level], idep_j[level], rtol=1e-12)
    for got, ref in list(zip(pts_t, pts_j)) + [(flow_t, flow_j)]:
        valid = np.asarray(ref.valid)
        assert_equal(got.valid, valid)
        assert_equal(to_np(got.uv)[valid], np.asarray(ref.uv)[valid])
        assert_close(to_np(got.idepth)[valid], np.asarray(ref.idepth)[valid], rtol=1e-12)
        assert_equal(to_np(got.intensity)[valid], np.asarray(ref.intensity)[valid])
        assert got.uv.shape == (ref.uv.shape[0], 2)
    last = pts_t[LEVELS - 1]
    cells = wei_t[LEVELS - 1].numel()
    assert cells < MAX_POINTS and not bool(last.valid[cells:].any())       # level 4 pads
    assert bool(pts_t[0].valid.any()) and bool(flow_t.valid.any())


# -- host models of csrc/depth_maps.cu ---------------------------------------

TILE = 8   # pixels per compaction tile in the model (the kernel's tiles hold 1024)


def _counting_select_model(weights, slots, max_class):
    """Selected flat indices, slot by slot (−1: a padded slot): a histogram of
    the positive weight classes, the class c* at which the count from the top
    crosses ``slots`` (0 when fewer pixels are positive), an ordered compaction
    of the pixels of class c* behind the heavier ones (per tile: the counts of
    the tiles before it plus the rank inside it), and the heavier pixels ranked
    among themselves by (class descending, index ascending)."""
    npix = weights.shape[0]
    cls = weights.astype(np.int64)
    hist = np.bincount(cls[cls > 0], minlength=max_class + 1)
    above, cstar, heavier = 0, 0, None
    for c in range(max_class, 0, -1):
        if above < slots <= above + hist[c]:
            cstar, heavier = c, above
        above += hist[c]
    if heavier is None:
        cstar, heavier = 0, above          # fewer positive pixels than slots
    out = np.full(slots, -1)
    tiles = [range(t, min(t + TILE, npix)) for t in range(0, npix, TILE)]
    counts = [(sum(cls[i] > cstar for i in tile), sum(cls[i] == cstar for i in tile))
              for tile in tiles]
    heavy = []
    for t, tile in enumerate(tiles):
        hi_rank = sum(c[0] for c in counts[:t])
        eq_rank = sum(c[1] for c in counts[:t])
        for i in tile:
            if cls[i] > cstar:
                heavy.append((hi_rank, i))
                hi_rank += 1
            elif cls[i] == cstar:
                if heavier + eq_rank < slots:
                    out[heavier + eq_rank] = i
                eq_rank += 1
    assert [r for r, _ in heavy] == list(range(len(heavy))) and len(heavy) == heavier
    for rank, i in heavy:
        slot = sum(1 for r2, j in heavy if cls[j] > cls[i] or (cls[j] == cls[i] and r2 < rank))
        out[slot] = i
    return out


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 70), st.integers(0, 2 ** 31 - 1), st.sampled_from([1, 2, 4, 9]),
       st.floats(0.0, 1.0), st.sampled_from([1, 5, 20, 64, 100]))
def test_counting_select_matches_stable_top_k(npix, seed, top_class, density, slots):
    rng = np.random.default_rng(seed)
    weights = (rng.integers(1, top_class + 1, npix) * (rng.random(npix) < density)).astype(np.float64)
    got = _counting_select_model(weights, slots, max_class=top_class)
    k = min(slots, npix)
    _, idx = top_k_stable(torch.tensor(weights), k)
    assert_equal(got[:k], idx)
    assert (got[k:] == -1).all()


def _ordered_scatter_model(pix, values, cells):
    """A point writes its pixel only if no earlier point shares it, and then
    adds its later twins in index order."""
    grid, count = np.zeros(cells), np.zeros(cells)
    for p, mine in enumerate(pix):
        if mine < 0 or any(pix[q] == mine for q in range(p)):
            continue
        total, n = 0.0, 0.0
        for q in range(p, len(pix)):
            if pix[q] == mine:
                total += values[q]
                n += 1.0
        grid[mine], count[mine] = total, n
    return grid, count


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_scatter_sum_matches_index_add(seed):
    rng = np.random.default_rng(seed)
    cells, points = 40, 300                         # many points share a pixel
    pix = rng.integers(0, cells, points)
    pix[rng.random(points) < 0.2] = -1              # points that are not ok add nothing
    values = rng.uniform(1e-3, 3.0, points) * 10.0 ** rng.integers(-3, 4, points)
    grid, count = _ordered_scatter_model(pix, values, cells)
    ok = pix >= 0
    flat = torch.tensor(np.where(ok, pix, 0))
    want = torch.zeros(cells, dtype=torch.float64).index_add_(
        0, flat, torch.tensor(np.where(ok, values, 0.0)))
    want_n = torch.zeros(cells, dtype=torch.float64).index_add_(
        0, flat, torch.tensor(ok.astype(np.float64)))
    assert_equal(grid, want)                        # the same order of additions, bit for bit
    assert_equal(count, want_n)
