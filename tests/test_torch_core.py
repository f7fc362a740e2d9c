"""Port parity: core geometry and sampling (lie, camera, reproject,
interpolate) and the synthetic renderer, f64 on the CPU, 1e-12 abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core import camera as jcam
from dsopp_tpu.core import interpolate as jint
from dsopp_tpu.core import lie as jlie
from dsopp_tpu.core import reproject as jrep
from dsopp_tpu.testing import render_sequence as jax_render
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.core import interpolate as tint
from dsopp_tpu_torch.core import lie as tlie
from dsopp_tpu_torch.core import reproject as trep
from dsopp_tpu_torch.testing import render_sequence

from tests._torch_port import assert_close, assert_equal, to_torch

ATOL = 1e-12


def _xi(rng, n, scale=0.3):
    xi = rng.normal(size=(n, 6)) * scale
    xi[:3] *= 1e-4          # exercise the small-angle branches
    return xi


@pytest.mark.parametrize("scale", [0.3, 1e-5])
def test_lie_exp_log_compose_inverse(scale):
    rng = np.random.default_rng(0)
    xi_a, xi_b = _xi(rng, 16, scale), _xi(rng, 16, scale)
    ja, jb = jlie.SE3.exp(jnp.asarray(xi_a)), jlie.SE3.exp(jnp.asarray(xi_b))
    ta, tb = tlie.SE3.exp(to_torch(xi_a)), tlie.SE3.exp(to_torch(xi_b))
    assert_close(ta.q, ja.q, atol=ATOL)
    assert_close(ta.t, ja.t, atol=ATOL)
    assert_close(ta.log(), ja.log(), atol=ATOL)
    c_j, c_t = ja @ jb.inverse(), ta @ tb.inverse()
    assert_close(c_t.q, c_j.q, atol=ATOL)
    assert_close(c_t.t, c_j.t, atol=ATOL)
    assert_close(c_t.matrix(), c_j.matrix(), atol=ATOL)
    v = rng.normal(size=(16, 3))
    assert_close(tlie.quat_rotate(ta.q, to_torch(v)), jlie.quat_rotate(ja.q, jnp.asarray(v)), atol=ATOL)


def _camera_pair():
    j = jcam.Pinhole.create((160.0, 120.0), (130.0, 131.0), (79.5, 59.5), jnp.float64)
    t = convert.pinhole(j.fx, j.fy, j.cx, j.cy, j.image_size)
    return j, t


@pytest.mark.parametrize("level", [0, 2])
def test_pinhole_project_unproject(level):
    jc, tc = _camera_pair()
    jc, tc = jc.scaled(2.0 ** level), tc.scaled(2.0 ** level)
    rng = np.random.default_rng(1)
    p = rng.normal(size=(64, 3)) + np.array([0, 0, 2.0])
    p[:4, 2] = [1e-4, -1.0, 0.0, 5e-3]        # depth edge cases
    uv_j, ok_j = jc.project(jnp.asarray(p))
    uv_t, ok_t = tc.project(to_torch(p))
    assert_close(uv_t, uv_j, atol=1e-9)
    assert_equal(ok_t, ok_j)
    uv_j, jac_j, ok_j = jc.project_jacobian(jnp.asarray(p))
    uv_t, jac_t, ok_t = tc.project_jacobian(to_torch(p))
    assert_close(jac_t, jac_j, rtol=1e-12, atol=ATOL)
    assert_equal(ok_t, ok_j)
    uv = rng.uniform(0, 100, size=(32, 2))
    assert_close(tc.unproject(to_torch(uv)), jc.unproject(jnp.asarray(uv)), atol=ATOL)


def test_reproject_and_jacobian():
    jc, tc = _camera_pair()
    rng = np.random.default_rng(2)
    uv = rng.uniform(0, 160, size=(40, 8, 2))
    idepth = rng.uniform(-0.01, 1.0, size=(40, 8))
    xi = _xi(rng, 40, 0.05)
    jt = jlie.SE3.exp(jnp.asarray(xi))
    tt = tlie.SE3.exp(to_torch(xi))
    jt_b = jlie.SE3(jt.q[:, None], jt.t[:, None])
    tt_b = tlie.SE3(tt.q[:, None], tt.t[:, None])
    rj = jrep.reproject_jacobian(jc, jc, jnp.asarray(uv), jnp.asarray(idepth), jt_b)
    rt = trep.reproject_jacobian(tc, tc, to_torch(uv), to_torch(idepth), tt_b)
    for name in ("uv", "idepth", "d_uv_d_idepth", "d_uv_d_eps_ref", "d_uv_d_eps_tgt"):
        assert_close(getattr(rt, name), getattr(rj, name), rtol=1e-12, atol=1e-9,
                     err_msg=name)
    assert_equal(rt.valid, rj.valid)
    r0 = jrep.reproject(jc, jc, jnp.asarray(uv), jnp.asarray(idepth), jt_b)
    r1 = trep.reproject(tc, tc, to_torch(uv), to_torch(idepth), tt_b)
    assert_close(r1.uv, r0.uv, rtol=1e-12, atol=1e-9)
    assert_equal(r1.valid, r0.valid)


def test_pixel_map_and_sample():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, size=(31, 47))
    pm_j = jint.build_pixel_map(jnp.asarray(img))
    pm_t = tint.build_pixel_map(to_torch(img))
    assert_close(pm_t, pm_j, atol=ATOL)
    uv = rng.uniform(-2, 49, size=(200, 2))
    s_j, in_j = jint.sample(pm_j, jnp.asarray(uv))
    s_t, in_t = tint.sample(pm_t, to_torch(uv))
    assert_close(s_t, s_j, atol=1e-10)
    assert_equal(in_t, in_j)


def test_window_sampling_matches_patch_rows():
    """sample_window(_values) == ops/patch.py rows sampling, incl. the
    out-of-window and outside-image rules."""
    from dsopp_tpu.ops import patch as jpatch

    rng = np.random.default_rng(4)
    h, w = 24, 30
    img = rng.uniform(0, 255, size=(h, w))
    centers = rng.uniform(-3, 33, size=(50, 2))
    uv = centers[:, None, :] + rng.normal(size=(50, 8, 2)) * 3.0
    tbl = jpatch.pack_patch_table(jnp.asarray(img))
    row, bx, by = jpatch.patch_center_row(jnp.asarray(centers), h, w)
    rows = jnp.take(tbl, row, axis=0)
    v_j, gx_j, gy_j, ok_j = jpatch.sample_pattern_rows(rows, jnp.asarray(uv), bx, by, h, w)
    vv_j, okv_j = jpatch.sample_values_rows(rows, jnp.asarray(uv), bx, by, h, w)
    padded = tint.pad_images(to_torch(img))
    tbx, tby = tint.window_base(to_torch(centers), h, w)
    assert_equal(tbx, bx)
    v_t, gx_t, gy_t, ok_t = tint.sample_window(padded, to_torch(uv), tbx[:, None],
                                               tby[:, None], h, w)
    vv_t, okv_t = tint.sample_window_values(padded, to_torch(uv), tbx[:, None],
                                            tby[:, None], h, w)
    assert_equal(ok_t, ok_j)
    assert_equal(okv_t, okv_j)
    assert 0 < int(ok_t.sum()) < ok_t.numel()
    for a, b in ((v_t, v_j), (gx_t, gx_j), (gy_t, gy_j), (vv_t, vv_j)):
        assert_close(a, b, atol=1e-10)


def test_render_matches_reference():
    ref = jax_render(num_frames=3, height=30, width=40, focal=50.0, cache=False)
    seq = render_sequence(num_frames=3, height=30, width=40, focal=50.0, device="cpu")
    assert_close(seq.images, ref.images, atol=1e-9)
    assert_close(seq.depths, ref.depths, rtol=1e-12)
    for i in range(3):
        assert_close(seq.poses_q[i], ref.poses[i].q, atol=ATOL)
        assert_close(seq.poses_t[i], ref.poses[i].t, atol=ATOL)
    assert seq.images.dtype == torch.float64
