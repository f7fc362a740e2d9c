"""Port parity: the epipolar update (K4's plain version, from the new frame's
pose T_w_t and the window's poses) vs the JAX package's vmapped
``estimate_depths`` on the relative poses its regular tick composes
(``dsopp_tpu/tracker/fused_tick.py:204-213``), on two banks built by
``make_immature_points`` from a rendered frame, with different exposures
and affines, against a frame a few steps on.  status and traced exact;
idepth_min/max, uniqueness and search_interval 1e-9 relative (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core.interpolate import build_pixel_map, sample
from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.core.pattern import shift_pattern
from dsopp_tpu.features import select_candidates
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.tracker.depth_estimation import (STATUS_GOOD, estimate_depths as jax_estimate,
                                                make_immature_points)
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.core.interpolate import pad_images, sample_window_values, window_base
from dsopp_tpu_torch.tracker import depth_estimation as tde

from tests._torch_port import assert_close, assert_equal, np_tree, to_torch

N = 160
AFFINES = np.array([[0.02, 1.0], [-0.01, -2.0]])
AFF_TGT = np.array([0.01, 0.5])
EXPOSURE = 1.05
WIN_EXPOSURES = np.array([1.0, 1.0825])


def _banks(seq):
    pm = build_pixel_map(jnp.asarray(seq.images[0]))
    cands = select_candidates(pm, N)
    patches, _ = sample(pm, shift_pattern(cands.uv))
    grads, _ = sample(pm, cands.uv)
    fresh = make_immature_points(cands.uv, patches[..., 0], grads[..., 1:], dtype=jnp.float64)
    fresh = fresh._replace(valid=fresh.valid & cands.valid)
    # bank 1: traced points with wide intervals around GT → long segments
    uv = np.asarray(cands.uv).astype(int)
    gt = seq.idepths[0][uv[:, 1], uv[:, 0]]
    traced = fresh._replace(
        idepth_min=jnp.asarray(gt * 0.3), idepth_max=jnp.asarray(gt * 3.0),
        status=jnp.full(N, STATUS_GOOD, jnp.int32), traced=jnp.ones(N, bool),
        uniqueness=jnp.full(N, 5.0))
    return jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), fresh, traced)


@pytest.fixture(scope="module")
def setup():
    seq = render_sequence(num_frames=6, height=120, width=160)
    return seq, _banks(seq)


def _poses(seq, roll):
    """T_w_t of frame 4 (its camera rolled in-plane by ``roll`` rad) and the
    two banks' host poses (frame 0's), as JAX arrays."""
    t_rel = seq.t_target_ref(4, 0)
    if roll:
        t_rel = JSE3.exp(jnp.asarray([0, 0, 0, 0, 0, roll], jnp.float64)) @ t_rel
    t_w0 = seq.poses[0]
    t_w_t = t_w0 @ t_rel.inverse()
    return t_w_t, JSE3(jnp.stack([t_w0.q, t_w0.q]), jnp.stack([t_w0.t, t_w0.t]))


def _port_args(seq, banks, roll, dtype=torch.float64):
    t_w_t, win = _poses(seq, roll)
    cam = convert.pinhole(seq.camera.fx, seq.camera.fy, seq.camera.cx, seq.camera.cy,
                          seq.camera.image_size)
    pts = convert.immature_points(np_tree(banks._asdict()), dtype=dtype)
    return pts, cam, tuple(to_torch(x, dtype) for x in (
        t_w_t.q, t_w_t.t, win.q, win.t, AFFINES, AFF_TGT, EXPOSURE, WIN_EXPOSURES))


@pytest.mark.parametrize("roll", [0.0, 0.5])
def test_estimate_depths_matches(setup, roll):
    seq, banks = setup
    t_w_t, win = _poses(seq, roll)
    target = build_pixel_map(jnp.asarray(seq.images[4]))
    # the JAX package's regular tick: t_rel = inverse(T_w_t) . T_w_k per bank
    t_inv = t_w_t.inverse()
    t_rel = JSE3(jnp.broadcast_to(t_inv.q, (2, 4)), jnp.broadcast_to(t_inv.t, (2, 3))).compose(win)
    ratios = EXPOSURE / jnp.maximum(jnp.asarray(WIN_EXPOSURES), 1e-12)
    ref = jax.vmap(jax_estimate, in_axes=(0, None, None, 0, 0, None, 0, None, None))(
        banks, target, seq.camera, t_rel, jnp.asarray(AFFINES),
        jnp.asarray(AFF_TGT), ratios, 20.0, 32)

    pts, cam, args = _port_args(seq, banks, roll)
    out = tde.estimate_depths_plain(pts, to_torch(target), cam, *args)
    assert_equal(out.status, ref.status)
    assert_equal(out.traced, ref.traced)
    for name in ("idepth_min", "idepth_max", "uniqueness", "search_interval"):
        # 1e-9 relative; 1e-14 absolute for intervals that cancel to ~0
        assert_close(getattr(out, name), getattr(ref, name), rtol=1e-9, atol=1e-14,
                     err_msg=name)
    assert int((out.status == tde.STATUS_GOOD).sum()) > 0

    # the group-window rule is exercised: some in-image, in-ROI pattern
    # points of valid samples fall outside their group's 10×10 window
    rel = tde.relative_poses(*args[:4])
    inp, _ = tde.sweep_inputs(pts, cam, rel.q, rel.t, to_torch(AFFINES), to_torch(AFF_TGT),
                              to_torch(EXPOSURE / WIN_EXPOSURES))
    sl = inp.search_len[:, None, None]
    uv_s = inp.uv_a[:, None] + (inp.alphas[None, :, None] * sl) * inp.dir[:, None]
    rho = tde._triangulate_idepth(inp.pr[:, None], inp.t[:, None], cam.unproject(uv_s))
    uv_sp, ok_proj = cam.project(inp.pr_p[:, None] + rho[..., None, None] * inp.t[:, None, None])
    uv_g = inp.uv_a[:, None] + (inp.alpha_g[None, :, None] * sl) * inp.dir[:, None]
    bx, by = window_base(uv_g, 120, 160)
    bx = bx.repeat_interleave(4, dim=1)[..., None]
    by = by.repeat_interleave(4, dim=1)[..., None]
    _, ok_win = sample_window_values(pad_images(to_torch(target[0])), uv_sp, bx, by, 120, 160)
    left_window = inp.active[:, None, None] & ok_proj & ~ok_win
    assert int(left_window.sum()) > 0


def test_sweep_plain_is_the_cpu_dispatch(setup):
    """On CPU tensors ``estimate_depths`` is the plain version."""
    seq, banks = setup
    pts, cam, args = _port_args(seq, banks, 0.0)
    target = to_torch(build_pixel_map(jnp.asarray(seq.images[2])))
    a = tde.estimate_depths(pts, target, cam, *args)
    b = tde.estimate_depths_plain(pts, target, cam, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_wrapper_refuses_cpu_tensors(setup):
    """K4's wrapper raises on CPU tensors and counts no launch."""
    from dsopp_tpu_torch import kernels

    seq, banks = setup
    pts, cam, args = _port_args(seq, banks, 0.0, torch.float32)
    target = to_torch(build_pixel_map(jnp.asarray(seq.images[2])), torch.float32)
    before = kernels.EPIPOLAR.launches
    with pytest.raises(ValueError, match="CUDA"):
        tde.estimate_depths_cuda(pts, target, cam, *args)
    assert kernels.EPIPOLAR.launches == before
