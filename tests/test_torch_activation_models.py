"""Host models of the K13 and K14-refine kernels' new steps against the plain
versions' definitions (``dsopp_tpu_torch/testing/activation_models.py``).

* K13's walk (bands of image rows, early exit, the any-within decision
  ``d2 <= within_threshold(min_distance)``) gives the min-based decision of
  ``_activation_plain`` (``sqrt(min d2) > min_distance``) on random sets, at
  ties exactly at ``min_distance``, at ``min_distance`` 0, negative, NaN and
  inf, with an empty active set, with NaN and inf projections, over several
  staging chunks and in any order of a band's entries; and on a rendered
  window through ``_activation_terms_plain``;
* K14's compaction (a block per bank from the later banks' count, 32 entries
  a warp step, the warps' counts scanned, places by ballot) gives
  ``parity.refine_order`` at k = 5, 17 and 40, caps below and above the
  count, with one step a warp and several;
* the refinement's f64 sums in a warp's fixed order meet the target-index
  order within ``parity.REFINE_SUM_ULPS``;
* ``ba_body.cuh``'s pose path, in torch f32 in the kernels' order, meets
  ``window.poses()`` / ``_to_newest`` / the refinement's pair poses within
  ``parity.KERNEL_POSE_ULPS``, and the reprojections it moves stay far inside
  ``parity.ACTIVATION_BAND`` and ``parity.BORDER_BAND``.
"""

import numpy as np
import pytest
import torch

from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import build_test_window
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.core.reproject import reproject
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.testing import activation_models as am
from dsopp_tpu_torch.testing import parity
from dsopp_tpu_torch.tracker import activation as act

from tests._torch_port import window_fields

F32 = np.float32


def _plain_decision(cand_uv, walkers, act_uv, min_distance):
    """``_activation_plain``'s spacing rule in f32 (activation.py: the
    [M, L] d2, its min, sqrt, > min_distance; no active landmark: spaced),
    with the inactive projections at +inf as ``_activation_terms_plain``
    writes them."""
    cu = torch.tensor(cand_uv, dtype=torch.float32)
    finite = np.isfinite(act_uv).all(axis=1)
    a = torch.tensor(np.where(finite[:, None], act_uv, np.inf), dtype=torch.float32)
    n_active = int(finite.sum())
    if a.shape[0] == 0:
        return np.asarray(walkers, bool), 0
    d2 = (cu[:, None, 0] - a[None, :, 0]) ** 2 + (cu[:, None, 1] - a[None, :, 1]) ** 2
    min_d = torch.sqrt(torch.min(d2, dim=1).values)
    md = torch.tensor(min_distance, dtype=torch.float32)
    spaced = (min_d > md).numpy() if n_active > 0 else np.ones(len(cand_uv), bool)
    return np.asarray(walkers, bool) & spaced, n_active


def _random_set(rng, m, n, height=480, width=640):
    cand = np.stack([rng.uniform(4, width - 5, m), rng.uniform(4, height - 5, m)], 1).astype(F32)
    lm = np.stack([rng.uniform(4, width - 5, n), rng.uniform(4, height - 5, n)], 1).astype(F32)
    walkers = rng.random(m) < 0.7
    active = rng.random(n) < 0.8
    lm[~active] = np.inf
    return cand, walkers, lm


def _ties(rng, m, n):
    """Landmarks at exactly 5 px (a 3-4-5 offset) of some candidates, at
    integer coordinates: d2 = 25 exactly, sqrt 5."""
    cand = np.stack([rng.integers(20, 600, m), rng.integers(20, 440, m)], 1).astype(F32)
    pick = rng.integers(0, m, n)
    sign = rng.choice([-1.0, 1.0], (n, 2))
    swap = rng.random(n) < 0.5
    off = np.where(swap[:, None], [4.0, 3.0], [3.0, 4.0]) * sign
    lm = (cand[pick] + off).astype(F32)
    far = rng.random(n) < 0.3
    lm[far] += F32(40.0)
    return cand, np.ones(m, bool), lm


CASES = {
    "random": (lambda rng: _random_set(rng, 300, 400), 1.5, 480),
    "random_wide": (lambda rng: _random_set(rng, 300, 400), 23.0, 480),
    "tie_at_5": (lambda rng: _ties(rng, 200, 150), 5.0, 480),
    "just_below_5": (lambda rng: _ties(rng, 200, 150), float(np.nextafter(F32(5), F32(0))), 480),
    "zero": (lambda rng: (lambda c, w, l: (c, w, np.concatenate([l, c[:40]])))(
        *_random_set(rng, 200, 300)), 0.0, 480),
    "negative": (lambda rng: _random_set(rng, 100, 200), -1.0, 480),
    "nan_distance": (lambda rng: _random_set(rng, 100, 200), float("nan"), 480),
    "inf_distance": (lambda rng: _random_set(rng, 100, 200), float("inf"), 480),
    "empty_active": (lambda rng: (lambda c, w, l: (c, w, np.full_like(l, np.inf)))(
        *_random_set(rng, 100, 50)), 1.5, 480),
    "no_landmark_slots": (lambda rng: (lambda c, w, l: (c, w, l[:0]))(
        *_random_set(rng, 100, 50)), 1.5, 480),
    "small_image": (lambda rng: _random_set(rng, 200, 300, height=120, width=160), 2.0, 120),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_gives_the_min_decision(case):
    make, md, height = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    cand, walkers, lm = make(rng)
    want, n_active = _plain_decision(cand, walkers, lm, md)
    for chunk, order_rng in ((am.CHUNK, None), (64, np.random.default_rng(1))):
        got, active, tested = am.walk(cand, walkers, lm, md, height, chunk=chunk, rng=order_rng)
        assert active == n_active
        assert np.array_equal(got, want), (case, chunk, int((got != want).sum()))
        assert tested <= int(walkers.sum()) * n_active
    if case in ("tie_at_5", "zero"):
        assert 0 < int(want.sum()) < int(walkers.sum())   # the ties decide some candidates


def test_walk_with_nonfinite_projections():
    """NaN or inf candidate projections are not walkers (an invalid
    reprojection), NaN or inf landmark projections are not active."""
    rng = np.random.default_rng(11)
    cand, walkers, lm = _random_set(rng, 200, 300)
    cand[:20] = np.nan
    cand[20:30, 0] = np.inf
    walkers[:30] = False
    lm[:25] = np.nan
    lm[25:40, 1] = -np.inf
    want, n_active = _plain_decision(cand, walkers, lm, 2.5)
    got, active, _ = am.walk(cand, walkers, lm, 2.5, 480)
    assert active == n_active == int(np.isfinite(lm).all(axis=1).sum())
    assert np.array_equal(got, want)


def test_walk_tests_fewer_pairs_than_all():
    """At the small spacings the density controller reaches, the bands cut
    the pairs a walker tests far below walkers x active."""
    rng = np.random.default_rng(3)
    cand, walkers, lm = _random_set(rng, 2000, 3000)
    _, active, tested = am.walk(cand, walkers, lm, 0.5, 480)
    assert tested < 0.05 * int(walkers.sum()) * active


def test_within_threshold_is_the_sqrt_boundary():
    rng = np.random.default_rng(2)
    values = np.concatenate([rng.uniform(0, 30, 500), [0.0, 1e-30, 1e-20, 1.0, 2.0, 5.0, 3e19,
                                                       1e30, np.finfo(F32).max]]).astype(F32)
    for md in values:
        t = am.within_threshold(md)
        assert np.sqrt(t) <= md
        with np.errstate(over="ignore"):
            up = np.nextafter(t, F32(np.inf))
        assert not np.sqrt(up) <= md
    assert am.within_threshold(-1.0) < 0 and am.within_threshold(float("nan")) < 0
    assert np.isinf(am.within_threshold(float("inf")))


@pytest.fixture(scope="module")
def rendered():
    """A 120×160 window of 6 slots (4 frames) with ready banks, f32."""
    seq = render_sequence(num_frames=8, height=120, width=160)
    window = build_test_window(seq, [0, 2, 4, 6], num_landmarks=96, slots=6, seed=1)
    win = convert.window(window_fields(window), dtype=torch.float32)
    rng = np.random.default_rng(4)
    # poses off their linearization points, as in a BA solve
    win = win.replace(eps=torch.tensor(rng.normal(scale=2e-3, size=(6, 8)), dtype=torch.float32))
    k, m = win.num_slots, 120
    valid = torch.tensor(rng.random((k, m)) < 0.9) & win.frame_valid[:, None]
    uv = torch.tensor(np.stack([rng.uniform(4, 155, (k, m)), rng.uniform(4, 115, (k, m))], -1),
                      dtype=torch.float32)
    idepth = torch.tensor(rng.uniform(0.2, 0.8, (k, m)), dtype=torch.float32)
    zero = torch.zeros((k, m), dtype=torch.float32)
    imm = act.ImmaturePoints(
        uv=uv, patch=torch.zeros((k, m, 8)), gradient=torch.zeros((k, m, 2)),
        idepth_min=idepth, idepth_max=idepth, status=torch.zeros((k, m), dtype=torch.int32),
        traced=torch.ones((k, m), dtype=torch.bool), uniqueness=zero + 5.0,
        search_interval=zero + 1.0, valid=valid)
    c = seq.camera
    return win, convert.pinhole(c.fx, c.fy, c.cx, c.cy, c.image_size), imm


@pytest.mark.parametrize("min_distance", [0.0, 1.0, 3.0, 12.0])
def test_walk_on_a_rendered_window_gives_the_plain_activation(rendered, min_distance):
    """The kernel's split (projections of the active landmarks, then the
    walk) on a rendered window, with the plain version's reprojections:
    ``_activation_plain``'s activate and n_active."""
    win, model, imm = rendered
    ready, rp_valid, _, n_active, cand_uv = act._activation_terms_plain(win, model, imm)
    t_rel, _ = act._to_newest(win)
    rp = reproject(model, model, win.lm_uv, win.lm_idepth, SE3(t_rel.q[:, None], t_rel.t[:, None]))
    active = pba.active_lm_mask(win) & ~win.lm_outlier & rp.valid
    lm = torch.where(active[..., None], rp.uv, torch.full_like(rp.uv, float("inf")))
    walkers = (ready & rp_valid).reshape(-1).numpy()
    got, count, _ = am.walk(cand_uv.reshape(-1, 2).numpy(), walkers, lm.reshape(-1, 2).numpy(),
                            min_distance, model.height)
    activate, _, n_plain = act._activation_plain(win, model, imm, min_distance)
    assert count == int(n_plain) == int(n_active) > 20
    assert np.array_equal(got, activate.reshape(-1).numpy())
    assert int(activate.sum()) > 0


@pytest.mark.parametrize("k", [5, 17, 40])
@pytest.mark.parametrize("share", [0.02, 0.3, 1.0])
def test_compaction_model_gives_refine_order(k, share):
    rng = np.random.default_rng(k + int(100 * share))
    m = 60
    activate = rng.random((k, m)) < share
    count = int(activate.sum())
    want = parity.refine_order(torch.tensor(activate)).numpy()
    for cap in sorted({max(count // 3, 1), count, count + 7, 512}):
        order, n, selected = am.compaction(activate, cap)
        assert n == min(cap, count)
        assert np.array_equal(order[:n], want[:n]) and (order[n:] == -1).all()
        sel = np.zeros(k * m, bool)
        sel[want[:n]] = True
        assert np.array_equal(selected.reshape(-1), sel)
        # one warp a block: two steps a warp
        order2, n2, selected2 = am.compaction(activate, cap, threads=32)
        assert n2 == n and np.array_equal(order2, order)
        assert np.array_equal(selected2, selected)


@pytest.mark.parametrize("k", [5, 17, 40])
def test_target_sums_meet_the_index_order(k):
    """The refinement's warp-order f64 sums against the target-index order:
    non-negative terms within ``REFINE_SUM_ULPS``, terms of
    both signs within the f64 rounding of their magnitudes."""
    rng = np.random.default_rng(k)
    equal = 0
    for _ in range(400):
        mag = 10.0 ** rng.uniform(-6, 4, k)
        mag[rng.random(k) < 0.2] = 0.0
        for signed in (False, True):
            v = (mag * (rng.choice([-1.0, 1.0], k) if signed else 1.0)).astype(F32)
            tree = am.target_sums(v)
            seq = F32(sum(float(x) for x in v.astype(np.float64)))
            equal += int(tree == seq)
            if signed:
                room = np.spacing(np.abs(seq)) + k * 2.0 ** -52 * float(np.abs(v).sum())
                assert abs(float(tree) - float(seq)) <= room
            else:
                assert abs(float(tree) - float(seq)) <= parity.REFINE_SUM_ULPS * np.spacing(seq)
    assert equal > 0.9 * 800


def _random_window(rng, k, frames, rot_scale, eps_scale):
    """A K-slot f32 window on the CPU, its first ``frames`` slots valid."""
    win = pba.empty_window(k, 4, (3, 8, 8), dtype=torch.float32, device="cpu")
    q = rng.normal(size=(k, 4))
    q[:, 0] += 1.0 / max(rot_scale, 1e-6)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    eps = rng.normal(scale=eps_scale, size=(k, 8))
    eps[::3, 3:6] *= 1e-3                      # the small-angle branch of SE3.exp
    return win.replace(t_lin_q=torch.tensor(q, dtype=torch.float32),
                       t_lin_t=torch.tensor(rng.normal(scale=2.0, size=(k, 3)), dtype=torch.float32),
                       eps=torch.tensor(eps, dtype=torch.float32),
                       frame_valid=torch.arange(k) < frames)


def _ulps(a, b):
    """Largest |a - b| in units of the last place of the larger of |a|, |b|
    (per pose component, at least that of 1 for quaternions: their scale)."""
    scale = torch.maximum(a.abs(), b.abs()).amax(dim=-1, keepdim=True)
    ulp = torch.tensor(np.spacing(scale.numpy().astype(F32)))
    return float(((a - b).abs() / ulp).max())


@pytest.mark.parametrize("rot_scale,eps_scale", [(0.1, 1e-3), (1.0, 0.05), (3.0, 0.3)])
def test_kernel_pose_path_meets_the_plain_poses(rot_scale, eps_scale):
    rng = np.random.default_rng(int(10 * rot_scale))
    k, frames = 17, 13
    win = _random_window(rng, k, frames, rot_scale, eps_scale)
    q, t = am.frame_poses(win.t_lin_q, win.t_lin_t, win.eps)
    poses = win.poses()
    assert _ulps(torch.stack(q, -1), poses.q) <= parity.KERNEL_POSE_ULPS
    assert _ulps(torch.stack(t, -1), poses.t) <= parity.KERNEL_POSE_ULPS
    # K13: newest <- each frame
    t_rel, newest = act._to_newest(win)
    rel_q, rel_t = am.relative_poses(win.t_lin_q, win.t_lin_t, win.eps, int(newest))
    assert _ulps(rel_q, t_rel.q) <= parity.KERNEL_POSE_ULPS
    assert _ulps(rel_t, t_rel.t) <= parity.KERNEL_POSE_ULPS
    # K14: target j <- host i, as the refinement's t_cj [host, target]
    t_inv = poses.inverse()
    t_cj = SE3(t_inv.q[None], t_inv.t[None]).compose(SE3(poses.q[:, None], poses.t[:, None]))
    for j in range(k):
        rq, rt = am.relative_poses(win.t_lin_q, win.t_lin_t, win.eps, j)
        assert _ulps(rq, t_cj.q[:, j]) <= parity.KERNEL_POSE_ULPS
        assert _ulps(rt, t_cj.t[:, j]) <= parity.KERNEL_POSE_ULPS


def test_kernel_pose_path_moves_reprojections_inside_the_bands(rendered):
    """The reprojections of a rendered window's landmarks into its newest
    frame through the kernels' poses and through ``_to_newest``: the largest
    shift is far inside the bands the error measures name."""
    win, model, _ = rendered
    t_rel, newest = act._to_newest(win)
    rel_q, rel_t = am.relative_poses(win.t_lin_q, win.t_lin_t, win.eps, int(newest))
    a = reproject(model, model, win.lm_uv, win.lm_idepth, SE3(t_rel.q[:, None], t_rel.t[:, None]))
    b = reproject(model, model, win.lm_uv, win.lm_idepth, SE3(rel_q[:, None], rel_t[:, None]))
    both = a.valid & b.valid & pba.active_lm_mask(win)
    assert int(both.sum()) > 100
    shift = float((a.uv - b.uv).abs()[both].max())
    assert shift <= 0.25 * min(parity.ACTIVATION_BAND, parity.BORDER_BAND)
