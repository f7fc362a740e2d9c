"""Port parity of the frontend's depth maps (K16) against the JAX package, and
host models of the kernel's algorithm (``csrc/depth_maps.cu``).

* ``build_frontend_state`` (JAX on the CPU in x64 against the port's plain
  version in f64) on a 4-frame window and on the dense operating point's 17
  slots: weights exact, the selected pixels of every valid slot exact,
  validity exact, idepth 1e-12 relative, intensity exact; level 4 (7×10
  pixels) pads its slots;
* the weight-class counting selection as a numpy model (histogram, ordered
  compaction, a stable counting sort of the heavier pixels by class) against ``top_k_stable`` on weight grids with many ties (hypothesis), with
  ``max_points`` below and above the number of positive pixels and above the
  grid's size, and on named edges: every positive pixel of one class, a
  heavier count one below the slot count, more slots than pixels;
* the scatter sum as a numpy model (per point the least later point on its
  pixel, found tile by tile, and each pixel's chain summed in point order)
  against ``index_add_`` in f64 (which adds in index order on the CPU), also with up to 200 points on
  one to three pixels;
* the kernel's glue as a numpy model (``testing/frontend_models.py::
  older_landmarks``: the newest slot, T_newest⁻¹ · T_f with ``SE3.exp`` in the
  card's order, the older keyframes' landmark mask) against
  ``_older_landmarks`` in f32 on the CPU: the slot and the mask exact, the
  poses within ``parity.KERNEL_POSE_ULPS``, with one valid frame, the dense
  point's 17 slots full, outliers, and rotations on both sides of
  ``core/lie.py``'s ``_SMALL``.
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
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features.extractor import top_k_stable
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.testing import frontend_models as fm
from dsopp_tpu_torch.testing import parity
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
POINT_TILE = 16   # points per twins tile in the model (the kernel's tiles hold 256)
LIST_TILE = 16    # list entries per class_rank_kernel tile in the model (the kernel's: 256)


def _counting_select_model(weights, slots, max_class):
    """Selected flat indices, slot by slot (−1: a padded slot): a histogram of
    the positive weight classes, the class c* at which the count from the top
    crosses ``slots`` (0 when fewer pixels are positive), an ordered compaction
    of the pixels of class c* behind the heavier ones (per tile: the counts of
    the tiles before it plus the rank inside it) that lists the heavier ones
    in index order, and a stable counting sort of that list: class c starts at
    the count of the pixels heavier than c, and an entry's rank in its class
    is the count of its class's earlier entries, tile by tile."""
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
    assert [r for r, _ in heavy] == list(range(len(heavy))) and len(heavy) == heavier < slots
    # class c starts after the pixels heavier than c; an entry's rank in its
    # class: its class's earlier entries, counted tile against tile
    first_slot = {c: int(hist[c + 1:].sum()) for c in range(1, max_class + 1)}
    entries = [i for _, i in heavy]
    for x, i in enumerate(entries):
        rank = 0
        for base in range(0, x - x % LIST_TILE + 1, LIST_TILE):
            rank += sum(cls[j] == cls[i] for j in entries[base:min(base + LIST_TILE, x)])
        slot = first_slot[cls[i]] + rank
        assert out[slot] == -1
        out[slot] = i
    return out


def _check_select(weights, slots, top_class):
    got = _counting_select_model(weights, slots, max_class=top_class)
    k = min(slots, weights.shape[0])
    _, idx = top_k_stable(torch.tensor(weights), k)
    assert_equal(got[:k], idx)
    assert (got[k:] == -1).all()


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 70), st.integers(0, 2 ** 31 - 1), st.sampled_from([1, 2, 4, 9]),
       st.floats(0.0, 1.0), st.sampled_from([1, 5, 20, 64, 100]))
def test_counting_select_matches_stable_top_k(npix, seed, top_class, density, slots):
    rng = np.random.default_rng(seed)
    weights = (rng.integers(1, top_class + 1, npix) * (rng.random(npix) < density)).astype(np.float64)
    _check_select(weights, slots, top_class)


def _edge_weights(case, rng, npix, slots):
    """Weights of ``npix`` pixels for a named edge of the selection."""
    w = np.zeros(npix)
    if case == "tied_classes":              # every positive pixel of one class
        w[rng.random(npix) < 0.7] = 3.0
    elif case == "heavy_below_slots":       # slots - 1 pixels heavier than c* = 1
        w[:] = 1.0
        w[rng.choice(npix, size=slots - 1, replace=False)] = rng.integers(2, 6, slots - 1)
    elif case == "more_slots_than_pixels":  # slots > npix, some positive
        w[rng.random(npix) < 0.5] = rng.integers(1, 4)
    return w


@pytest.mark.parametrize("case", ["tied_classes", "heavy_below_slots", "more_slots_than_pixels"])
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), npix=st.integers(2, 90), slots=st.integers(2, 40))
def test_counting_select_edge_cases(case, seed, npix, slots):
    rng = np.random.default_rng(seed)
    if case == "more_slots_than_pixels":
        slots = npix + slots
    elif case == "heavy_below_slots":
        npix = max(npix, slots + 1)
    weights = _edge_weights(case, rng, npix, slots)
    if case == "heavy_below_slots":
        assert int((weights > 1).sum()) == slots - 1
    _check_select(weights, slots, top_class=6)


def _ordered_scatter_model(pix, values, cells):
    """Per point, over tiles of points: the least later point on its pixel (the
    least of the tiles' first ones) and whether an earlier one exists; then
    each pixel's first point sums the chain in point order."""
    points = len(pix)
    later, has_prev = [None] * points, [False] * points
    for p in range(points):
        if pix[p] < 0:
            continue
        for base in range(0, points, POINT_TILE):
            for q in range(base, min(base + POINT_TILE, points)):
                if q == p or pix[q] != pix[p]:
                    continue
                if q < p:
                    has_prev[p] = True
                else:
                    later[p] = q if later[p] is None else min(later[p], q)
                    break
    grid, count = np.zeros(cells), np.zeros(cells)
    for p in range(points):
        if pix[p] < 0 or has_prev[p]:
            continue
        total, n, q = 0.0, 0.0, p
        while q is not None:
            total += values[q]
            n += 1.0
            q = later[q]
        grid[pix[p]], count[pix[p]] = total, n
    return grid, count


def _check_scatter(pix, values, cells):
    grid, count = _ordered_scatter_model(pix, values, cells)
    ok = pix >= 0
    flat = torch.tensor(np.where(ok, pix, 0))
    want = torch.zeros(cells, dtype=torch.float64).index_add_(
        0, flat, torch.tensor(np.where(ok, values, 0.0)))
    want_n = torch.zeros(cells, dtype=torch.float64).index_add_(
        0, flat, torch.tensor(ok.astype(np.float64)))
    assert_equal(grid, want)                        # the same order of additions, bit for bit
    assert_equal(count, want_n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_scatter_sum_matches_index_add(seed):
    rng = np.random.default_rng(seed)
    cells, points = 40, 300                         # many points share a pixel
    pix = rng.integers(0, cells, points)
    pix[rng.random(points) < 0.2] = -1              # points that are not ok add nothing
    values = rng.uniform(1e-3, 3.0, points) * 10.0 ** rng.integers(-3, 4, points)
    _check_scatter(pix, values, cells)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), points=st.integers(1, 200), used=st.integers(1, 3))
def test_ordered_scatter_sum_many_twins(seed, points, used):
    """Up to 200 points on one to three pixels of 50."""
    rng = np.random.default_rng(seed)
    cells = 50
    pix = rng.choice(cells, size=used, replace=False)[rng.integers(0, used, points)]
    pix[rng.random(points) < 0.1] = -1
    values = rng.uniform(1e-3, 3.0, points) * 10.0 ** rng.integers(-3, 4, points)
    _check_scatter(pix, values, cells)


# -- the kernel's glue: poses and mask from the window's raw tensors ---------

# case -> (slots, valid frames, outlier share, rotation scales of the frames)
GLUE_CASES = {
    "one_frame": (10, 1, 0.0, (1e-2,)),
    "dense_full": (17, 17, 0.05, (1e-2,)),
    "outliers": (10, 7, 0.3, (1e-2,)),
    # |omega|^2 just below and above 1e-6, and far on either side
    "small_angles": (10, 8, 0.05, (9.99e-4, 1.001e-3, 1e-5, 3e-2)),
}


def _glue_window(case):
    k, valid, outliers, scales = GLUE_CASES[case]
    n = 24
    rng = np.random.default_rng(len(case))
    lin = SE3.exp(torch.tensor(np.concatenate([rng.normal(size=(k, 3)) * 2.0,
                                               rng.normal(size=(k, 3))], -1),
                               dtype=torch.float32))
    omega = rng.normal(size=(k, 3))
    omega *= (np.resize(scales, k) / np.linalg.norm(omega, axis=-1))[:, None]
    eps = np.concatenate([rng.normal(size=(k, 3)) * 1e-2, omega, rng.normal(size=(k, 2))], -1)
    win = pba.empty_window(k, n, (3, 4, 4), device="cpu")
    return win.replace(
        t_lin_q=lin.q.contiguous(), t_lin_t=lin.t.contiguous(),
        eps=torch.tensor(eps, dtype=torch.float32),
        frame_valid=torch.arange(k) < valid,
        lm_valid=torch.tensor(rng.random((k, n)) < 0.8),
        lm_outlier=torch.tensor(rng.random((k, n)) < outliers))


def _ulps(a, b):
    """Largest |a - b| in f32 ulps of the larger of |a|, |b| over each pose
    component (at least that of 1 for quaternions: their scale)."""
    scale = np.maximum(np.abs(a), np.abs(b)).max(axis=-1, keepdims=True)
    return float((np.abs(a - b) / np.spacing(scale.astype(np.float32))).max())


@pytest.mark.parametrize("case", list(GLUE_CASES))
def test_kernel_glue_model_matches_older_landmarks(case):
    win = _glue_window(case)
    if case == "small_angles":
        theta_sq = (win.eps[:, 3:6] ** 2).sum(-1)
        assert bool((theta_sq < 1e-6).any()) and bool((theta_sq >= 1e-6).any())
    t_rel, mask = tdm._older_landmarks(win)
    newest, q, t, mask_m = fm.older_landmarks(
        *(to_np(x) for x in (win.t_lin_q, win.t_lin_t, win.eps, win.frame_valid, win.lm_valid,
                             win.lm_outlier)))
    assert newest == int(pba.newest_slot(win))
    assert_equal(mask_m, mask)
    assert _ulps(q, to_np(t_rel.q)) <= parity.KERNEL_POSE_ULPS
    assert _ulps(t, to_np(t_rel.t)) <= parity.KERNEL_POSE_ULPS
    assert int(mask.sum()) > 0 or case == "one_frame"
