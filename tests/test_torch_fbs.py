"""The port's feature-based bootstrap against the JAX package's (f64 on the
CPU).

Tolerances: s2 and the host geometry (numpy copies with the same seeded
RANSAC draws) within 1e-12; ``so3xs2_refine`` (torch, its Jacobian in closed form)
within 1e-9 of JAX's x64 loop; ``refine`` and ``refine_intrinsics`` within
1e-12.  The corners of ``fbs/klt.py`` (the torch version on the CPU and the
plain version) equal cv2's, through the JAX initializer's ``_detect``, on
rendered corridor frames; ``pyrDown`` and the Scharr derivatives equal
cv2's.  ``pyr_lk`` (both versions) through ``_track`` against cv2's: the
lost/kept pattern equal on ≥ 99 % of the points and every other point named
(its eigenvalue within 1 % of the threshold, or its window on the image's
edge), positions within 0.05 px on ≥ 98 % of the points both keep and
within 0.01 px on all of them; the torch version equal to the plain one to
the bit.  With
cv2's corners and tracks injected into the port, its initializer equals
JAX's (the same finishing frame, poses within 1e-9); with its own, it
finishes on the same frame and meets the JAX test's gate (similarity-aligned
ATE < 0.02 m).  The file runs in ~41 s on one worker.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsopp_tpu.fbs import InitializerOptions as JaxOptions
from dsopp_tpu.fbs import MonocularInitializer as JaxInitializer
from dsopp_tpu.fbs import geometric_ba as jba
from dsopp_tpu.fbs import geometry as jgeo
from dsopp_tpu.solvers import s2 as js2
from dsopp_tpu.testing import render_sequence as jax_render
from dsopp_tpu_torch.fbs import InitializerOptions, MonocularInitializer, klt
from dsopp_tpu_torch.fbs import geometric_ba as pba
from dsopp_tpu_torch.fbs import geometry as pgeo
from dsopp_tpu_torch.output.ate import absolute_trajectory_error
from dsopp_tpu_torch.solvers import s2 as ps2
from dsopp_tpu_torch.testing.synthetic import render_sequence

from tests import _torch_port  # noqa: F401  (one torch thread a worker)

LK_STATUS_SHARE, LK_POS_SHARE, LK_POS_TOL, LK_POS_MAX = 0.99, 0.98, 0.05, 0.01
EIG_BAND = 0.01      # a status may differ where the eigenvalue is within 1 % of the threshold


def _rot(w):
    return jba._so3_exp(np.asarray(w, np.float64))


def _two_view(seed=0, n=100, noise=0.0):
    """tests/fbs/test_initializer.py's two-view scene."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 3], [2, 2, 8], (n, 3))
    r_gt = _rot([0.05, -0.1, 0.02])
    t_gt = np.array([0.5, 0.1, -0.05])
    t_gt = t_gt / np.linalg.norm(t_gt)
    m1 = pts[:, :2] / pts[:, 2:3]
    cam2 = pts @ r_gt.T + t_gt
    m2 = cam2[:, :2] / cam2[:, 2:3]
    if noise:
        m1 = m1 + rng.normal(0, noise, m1.shape)
        m2 = m2 + rng.normal(0, noise, m2.shape)
    return pts, r_gt, t_gt, m1, m2


def _close(a, b, tol, what=""):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _close(x, y, tol, what)
        return
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=tol, err_msg=what)


def test_s2_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((50, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    d = rng.uniform(-3, 3, (50, 2))
    tv, td = torch.tensor(v), torch.tensor(d)
    _close(ps2.s2_plus(tv, td), js2.s2_plus(jnp.asarray(v), jnp.asarray(d)), 1e-12)
    _close(ps2.s2_plus_jacobian(tv), js2.s2_plus_jacobian(jnp.asarray(v)), 1e-12)


def _outliers(m2, seed=1, k=40):
    rng = np.random.default_rng(seed)
    bad = rng.choice(len(m2), k, replace=False)
    m2 = m2.copy()
    m2[bad] += rng.uniform(-0.2, 0.2, (k, 2))
    return m2


GEOMETRY_CASES = {
    "essential_8pt": lambda g: g.essential_8pt(*_two_view()[3:]),
    "sampson_distance": lambda g: g.sampson_distance(
        g.essential_8pt(*_two_view()[3:]), *_two_view(noise=1e-3)[3:]),
    "ransac_essential": lambda g: g.ransac_essential(
        _two_view(n=150, noise=5e-4)[3], _outliers(_two_view(n=150, noise=5e-4)[4]), 3e-3),
    "decompose_essential": lambda g: g.decompose_essential(
        g.essential_8pt(*_two_view()[3:]), *_two_view()[3:]),
    "triangulate": lambda g: g.triangulate(*_two_view(noise=1e-4)[1:3], *_two_view(noise=1e-4)[3:]),
    "so3_fit": lambda g: g.so3_fit(*_two_view(seed=4)[3:]),
    "so3_inlier_ratio": lambda g: g.so3_inlier_ratio(*_two_view(seed=5)[3:], 5e-3),
    "pnp_dlt": lambda g: g.pnp_dlt(_two_view(n=80, noise=1e-4)[0], _two_view(n=80, noise=1e-4)[4]),
    "ransac_pnp": lambda g: g.ransac_pnp(_two_view(n=80, noise=1e-4)[0],
                                         _outliers(_two_view(n=80, noise=1e-4)[4], k=15), 3e-3),
}


@pytest.mark.parametrize("name", list(GEOMETRY_CASES))
def test_host_geometry_matches_jax(name):
    """The numpy copies give the JAX package's results (1e-12), RANSAC draws
    included."""
    _close(GEOMETRY_CASES[name](pgeo), GEOMETRY_CASES[name](jgeo), 1e-12, name)


def test_autocalibration_selector_matches_jax():
    sel_p, sel_j = pgeo.AutocalibrationSelector(), jgeo.AutocalibrationSelector()
    for f, k in ((400.0, (0.1, 0.0)), (380.0, (0.2, -0.1)), (415.0, (0.0, 0.3))):
        sel_p.add_result(f, k)
        sel_j.add_result(f, k)
    assert sel_p.get_focal_length() == sel_j.get_focal_length() and len(sel_p) == 3
    _close(sel_p.get_distortion_coeffs(), sel_j.get_distortion_coeffs(), 0.0)


@pytest.mark.parametrize("optimize_focal", [False, True], ids=["calibrated", "autocalibrated"])
def test_so3xs2_refine_matches_jax(optimize_focal):
    """The torch LM against JAX's x64 loop on the JAX test's noisy pose
    (within 1e-9): rotation, unit translation, focal, rms."""
    focal = 400.0
    _, r_gt, t_gt, m1, m2 = _two_view(seed=3, n=150, noise=5e-4)
    r0 = _rot([0.01, -0.008, 0.012]) @ r_gt
    t0 = t_gt + np.array([0.05, -0.04, 0.03])
    start = 300.0 if optimize_focal else focal
    args = (m1 * focal, m2 * focal, r0, t0, start, 2.0)
    port = pgeo.so3xs2_refine(*args, optimize_focal=optimize_focal, iterations=60,
                              device="cpu")
    ref = jgeo.so3xs2_refine(*args, optimize_focal=optimize_focal, iterations=60)
    _close(port, ref, 1e-9)
    if optimize_focal:
        assert abs(port[2] - focal) < abs(start - focal)


def _ba_problem(seed=2):
    pts, r_gt, t_gt, m1, m2 = _two_view(n=60, noise=1e-4)
    rng = np.random.default_rng(seed)
    poses_r = np.stack([np.eye(3), _rot(rng.normal(0, 0.01, 3)) @ r_gt])
    poses_t = np.stack([np.zeros(3), t_gt + rng.normal(0, 0.02, 3)])
    pts_noisy = pts * (1 + rng.normal(0, 0.02, (len(pts), 1)))
    obs_f = np.concatenate([np.zeros(60, int), np.ones(60, int)])
    obs_p = np.concatenate([np.arange(60), np.arange(60)])
    return poses_r, poses_t, pts_noisy, obs_f, obs_p, np.concatenate([m1, m2])


@pytest.mark.parametrize("case", ["refine", "refine_intrinsics"])
def test_geometric_ba_matches_jax(case):
    poses_r, poses_t, pts, obs_f, obs_p, obs_m = _ba_problem()
    if case == "refine":
        args = (poses_r, poses_t, pts, obs_f, obs_p, obs_m)
        _close(pba.refine(*args), jba.refine(*args), 1e-12)
        return
    f, c = 400.0, np.array([160.0, 120.0])
    obs_px = obs_m * f + c + np.random.default_rng(4).normal(0, 0.2, obs_m.shape)
    args = (poses_r, poses_t, pts, obs_f, obs_p, obs_px, 390.0, 405.0, 158.0, 121.0)
    _close(pba.refine_intrinsics(*args), jba.refine_intrinsics(*args), 1e-12)


@pytest.fixture(scope="module")
def corridor():
    """The corridor at 240×320 (16 frames, the JAX initializer test's) and at
    VGA (5 frames): the port's f64 renders and the JAX package's."""
    small = render_sequence(num_frames=16, height=240, width=320, dtype=torch.float64,
                            device="cpu")
    vga = render_sequence(num_frames=5, height=480, width=640, focal=520.0,
                          dtype=torch.float64, device="cpu")
    return {"small": small, "vga": vga}


def _jax_init(**kw):
    return JaxInitializer(None, JaxOptions(**kw))


@pytest.mark.parametrize("size,frame", [("small", 0), ("small", 9), ("vga", 0), ("vga", 4)])
def test_good_features_match_cv2(corridor, size, frame):
    """Corners of the torch and the plain version equal cv2's (the JAX
    initializer's ``_detect``), order included."""
    img = corridor[size].images[frame].numpy()
    ref = _jax_init()._detect(img)
    assert len(ref) > 300
    np.testing.assert_array_equal(klt.good_features(torch.as_tensor(img)), ref)
    np.testing.assert_array_equal(klt.good_features_plain(img), ref)


@pytest.mark.parametrize("size", ["small", "vga"])
def test_pyramid_and_scharr_match_cv2(corridor, size):
    import cv2

    img = klt.as_u8(corridor[size].images[1].numpy())
    for level in range(3):
        ref = cv2.pyrDown(img)
        np.testing.assert_array_equal(klt.pyr_down_plain(img), ref)
        np.testing.assert_array_equal(klt.pyr_down(torch.as_tensor(img)).numpy(), ref)
        ix, iy = klt.scharr_plain(img)
        np.testing.assert_array_equal(ix, cv2.Scharr(img, cv2.CV_16S, 1, 0))
        np.testing.assert_array_equal(iy, cv2.Scharr(img, cv2.CV_16S, 0, 1))
        tix, tiy = klt.scharr(torch.as_tensor(img))
        np.testing.assert_array_equal(tix.numpy(), ix)
        np.testing.assert_array_equal(tiy.numpy(), iy)
        img = ref


def _named_status(prev, points, lost, height, width):
    """A point whose lost/kept differs from cv2's is named when its window's
    smaller eigenvalue (level 0) lies within EIG_BAND of the threshold, or
    its window reaches past the image's edge."""
    x0, y0 = np.floor(points - 10.0).astype(int).T
    edge = (x0 < 0) | (y0 < 0) | (x0 + 21 >= width) | (y0 + 21 >= height)
    ix, iy = (np.pad(d, 21) for d in klt.scharr_plain(klt.as_u8(prev)))
    named = []
    for k in np.flatnonzero(lost):
        if edge[k]:
            named.append(True)
            continue
        frac = (points[k] - 10.0 - np.floor(points[k] - 10.0)).astype(np.float32)
        wts = klt._weights_plain(*frac)
        dx = klt._window_plain(ix, y0[k] + 21, x0[k] + 21, wts, 21, klt.W_BITS)
        dy = klt._window_plain(iy, y0[k] + 21, x0[k] + 21, wts, 21, klt.W_BITS)
        a = np.array([[np.sum(dx * dx), np.sum(dx * dy)], [np.sum(dx * dy), np.sum(dy * dy)]])
        min_eig = np.linalg.eigvalsh(a * float(klt.FLT_SCALE))[0] / 441.0
        named.append(abs(min_eig - 1e-4) <= EIG_BAND * 1e-4)
    return np.asarray(named, bool)


@pytest.mark.parametrize("size,pair", [("small", (0, 1)), ("small", (3, 7)), ("vga", (0, 1)),
                                       ("vga", (0, 4))])
def test_pyr_lk_matches_cv2(corridor, size, pair):
    """``pyr_lk`` (the torch version through the port initializer's
    ``_track``, and the plain version) against cv2 through the JAX
    initializer's ``_track``, on the corners of the first frame and 200
    points spread over and around the image (NaN: lost)."""
    seq = corridor[size]
    h, w = seq.images.shape[1:]
    prev, nxt = (seq.images[i].numpy() for i in pair)
    rng = np.random.default_rng(pair[1])
    pts = np.concatenate([klt.good_features_plain(prev),
                          rng.uniform([-30, -30], [w + 30, h + 30], (200, 2))]).astype(np.float32)
    pts[::97] = np.nan
    ref = _jax_init()._track(prev, nxt, pts)
    port = MonocularInitializer(seq.camera)._track(
        klt.as_u8(torch.as_tensor(prev)), klt.as_u8(torch.as_tensor(nxt)), pts)
    valid = np.isfinite(pts[:, 0])
    plain, status = klt.pyr_lk_plain(prev, nxt, pts[valid])
    inside = (plain[:, 0] >= 0) & (plain[:, 0] < w) & (plain[:, 1] >= 0) & (plain[:, 1] < h)
    plain[~(status & inside)] = np.nan
    np.testing.assert_array_equal(port[valid], plain)     # torch = plain, to the bit
    kept_ref, kept = np.isfinite(ref[valid, 0]), np.isfinite(plain[:, 0])
    differ = kept_ref != kept
    assert np.mean(~differ) >= LK_STATUS_SHARE, np.mean(~differ)
    named = _named_status(prev, pts[valid], differ, h, w)
    assert named.all(), pts[valid][differ][~named]
    both = kept_ref & kept
    err = np.abs(plain[both] - ref[valid][both]).max(1)
    assert both.sum() > 300
    assert np.mean(err < LK_POS_TOL) >= LK_POS_SHARE and err.max() < LK_POS_MAX, err.max()


def _run_init(init, images, timestamps):
    for i in range(len(images)):
        if init.process(i, float(timestamps[i]), images[i]):
            return i
    return None


def _cv2_klt(monkeypatch):
    """Inject cv2's corners and tracks into the port's initializer."""
    import cv2

    def corners(image, max_corners, quality, min_distance):
        pts = cv2.goodFeaturesToTrack(klt.as_u8(image).numpy(), max_corners,
                                      qualityLevel=quality, minDistance=min_distance)
        return pts.reshape(-1, 2).astype(np.float32)

    def track(prev, nxt, points, win, max_level):
        p1, status, _ = cv2.calcOpticalFlowPyrLK(
            klt.as_u8(prev).numpy(), klt.as_u8(nxt).numpy(), points.numpy().reshape(-1, 1, 2),
            None, winSize=(win, win), maxLevel=max_level)
        return torch.as_tensor(p1.reshape(-1, 2)), torch.as_tensor(status.reshape(-1) != 0)

    monkeypatch.setattr(klt, "good_features", corners)
    monkeypatch.setattr(klt, "pyr_lk", track)


@pytest.mark.parametrize("tracks", ["cv2", "port"])
def test_initializer_matches_jax(corridor, monkeypatch, tracks):
    """tests/fbs/test_initializer.py's sequence.  With cv2's corners and
    tracks injected the port's initializer equals JAX's (the same frame,
    poses within 1e-9 in f64); with its own corners and LK it finishes on
    the same frame and meets the JAX gate, similarity-aligned ATE < 0.02 m."""
    if tracks == "cv2":
        _cv2_klt(monkeypatch)
    opts = dict(min_parallax_px=6.0, min_frames=5, reference_image_width=320.0)
    jseq = jax_render(num_frames=16, height=240, width=320)
    images = np.asarray(jseq.images)      # both initializers see the same frames
    ref = JaxInitializer(jseq.camera, JaxOptions(**opts))
    port = MonocularInitializer(corridor["small"].camera, InitializerOptions(**opts))
    done_ref = _run_init(ref, images, jseq.timestamps)
    done = _run_init(port, torch.as_tensor(images), jseq.timestamps)
    assert done is not None and done == done_ref
    assert [p[0] for p in port.poses] == [p[0] for p in ref.poses]
    if tracks == "cv2":
        _close([p[2] for p in port.poses], [p[2] for p in ref.poses], 1e-9)
    est = [(ts, mat) for _, ts, mat in port.poses]
    gt = [(float(jseq.timestamps[fid]), np.asarray(jseq.pose_t_wc(fid).matrix()))
          for fid, _, _ in port.poses]
    assert absolute_trajectory_error(est, gt, align=True, with_scale=True)["rmse"] < 0.02


def test_orb_matcher_is_refused():
    with pytest.raises(ValueError, match="orb"):
        MonocularInitializer(None, InitializerOptions(matcher="orb"))
