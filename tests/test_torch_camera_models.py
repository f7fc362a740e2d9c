"""The port's camera models against the JAX package's, f64 on the CPU: the
15 cases of ``tests/core/test_camera.py``, each with the same seeded numpy
inputs through both packages (projections, validity, Jacobians and
unprojections within 1e-9, validity equal) and the port's Jacobian against
``torch.autograd`` (1e-9, 1e-7 where the JAX test allows 1e-7 to its own
autodiff)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core import camera as jcam
from dsopp_tpu_torch.core import camera as tcam

import tests._torch_port  # noqa: F401  (one torch thread per worker)

SIZE = (1280.0, 720.0)
TOL = 1e-9


def _lut():
    r = np.linspace(0.0, 1.0, 42)
    return 0.06 * r * r - 0.015 * r


# name -> (JAX model, port model)
MODELS = {
    "pinhole": lambda: (jcam.Pinhole.create(SIZE, (448.155, 448.155), (640.0, 360.0),
                                            jnp.float64),
                        tcam.Pinhole.create(SIZE, (448.155, 448.155), (640.0, 360.0))),
    "radial": lambda: (jcam.SimpleRadial.create(SIZE, 448.155, (640.0, 360.0), -0.05, 0.008,
                                                jnp.float64),
                       tcam.SimpleRadial.create(SIZE, 448.155, (640.0, 360.0), -0.05, 0.008)),
    "tum_fov": lambda: (jcam.TumFov.create(SIZE, (600.0, 600.0), (640.0, 360.0), 0.9,
                                           jnp.float64),
                        tcam.TumFov.create(SIZE, (600.0, 600.0), (640.0, 360.0), 0.9)),
    "division": lambda: (jcam.Division.create(SIZE, 448.0, (640.0, 360.0), -0.08, jnp.float64),
                         tcam.Division.create(SIZE, 448.0, (640.0, 360.0), -0.08)),
    "atan": lambda: (jcam.Atan.create(SIZE, (450.0, 452.0), (640.0, 360.0),
                                      (-0.01, 0.004, -0.001), jnp.float64),
                     tcam.Atan.create(SIZE, (450.0, 452.0), (640.0, 360.0),
                                      (-0.01, 0.004, -0.001))),
    "ios": lambda: (jcam.IOSCamera.create(SIZE, (448.155, 450.2), (640.0, 360.0), _lut(),
                                          jnp.float64),
                    tcam.IOSCamera.create(SIZE, (448.155, 450.2), (640.0, 360.0), _lut())),
}


def _points_in_view(seed, n=512):
    rng = np.random.default_rng(seed)
    uv = rng.uniform([10.0, 10.0], [1269.0, 709.0], (n, 2))
    return uv, rng.uniform(0.5, 50.0, n)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


def _same_as_jax(name, seed, n=64, jac_tol=TOL):
    """Both packages' unproject, project and project_jacobian on the same
    points agree; the port's Jacobian agrees with torch.autograd."""
    jm, tm = MODELS[name]()
    uv, depth = _points_in_view(seed, n)
    rays_j, rays_t = jm.unproject(jnp.asarray(uv)), tm.unproject(_t(uv))
    _close(rays_t, rays_j)
    p3d = np.asarray(rays_j) * depth[:, None]
    (uv_j, valid_j), (uv_t, valid_t) = jm.project(jnp.asarray(p3d)), tm.project(_t(p3d))
    _close(uv_t, uv_j)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    _, j_j, v_j = jm.project_jacobian(jnp.asarray(p3d))
    uv_tj, j_t, v_t = tm.project_jacobian(_t(p3d))
    _close(j_t, j_j)
    _close(uv_tj, uv_j)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    j_ad = torch.stack([torch.autograd.functional.jacobian(lambda p: tm.project(p)[0], p)
                        for p in _t(p3d)[:16]])
    _close(j_t[:16], j_ad, jac_tol)
    _, valid_u = tm.unproject_valid(_t(uv))
    np.testing.assert_array_equal(valid_u.numpy(), np.asarray(jm.unproject_valid(
        jnp.asarray(uv))[1]))
    return tm, uv, uv_t, valid_t


def test_pinhole_project_unproject_roundtrip():
    _, uv, uv2, valid = _same_as_jax("pinhole", 0, n=512)
    _close(uv2, uv)
    assert bool(valid.all())


def test_radial_project_unproject_roundtrip():
    _, uv, uv2, _ = _same_as_jax("radial", 1, n=512)
    _close(uv2, uv, 1e-7)


def test_pinhole_jacobian_vs_autodiff():
    _same_as_jax("pinhole", 2, n=32)


def test_radial_jacobian_vs_autodiff():
    _same_as_jax("radial", 3, n=32)
    jm, tm = MODELS["radial"]()
    assert tm.max_valid_r2() == pytest.approx(float(jm._max_valid_r2()), rel=1e-15)
    for k1, k2 in ((-0.05, 0.0), (0.1, 0.0), (-0.3, 0.05), (0.2, 0.3)):
        j = jcam.SimpleRadial.create(SIZE, 400.0, (640.0, 360.0), k1, k2, jnp.float64)
        t = tcam.SimpleRadial.create(SIZE, 400.0, (640.0, 360.0), k1, k2)
        assert t.max_valid_r2() == pytest.approx(float(j._max_valid_r2()), rel=1e-15)


def test_border_and_depth_validity():
    _, tm = MODELS["pinhole"]()
    _, valid = tm.project(_t([0.0, 0.0, -1.0]))
    assert not bool(valid)
    _, valid = tm.project(tm.unproject(_t([2.0, 360.0])) * 5.0)
    assert not bool(valid)
    _, valid = tm.project(tm.unproject(_t([6.0, 360.0])) * 5.0)
    assert bool(valid)


def test_scaled_model_halves_projection():
    jm, tm = MODELS["pinhole"]()
    p3d = _t([1.0, -0.5, 4.0])
    uv0, _ = tm.project(p3d)
    uv1, _ = tm.scaled(2.0).project(p3d)
    _close(uv1, uv0 / 2.0, 1e-12)
    _close(uv1, jm.scaled(2.0).project(jnp.asarray([1.0, -0.5, 4.0]))[0])


def test_batched_intrinsics():
    """The JAX models broadcast over a leading camera axis; the port's take
    one camera each, and agree camera by camera."""
    fx = jnp.array([400.0, 500.0])
    jm = jcam.Pinhole(fx, fx, jnp.full((2,), 320.0), jnp.full((2,), 240.0),
                      jnp.broadcast_to(jnp.array([640.0, 480.0]), (2, 2)))
    p = np.array([[0.1, 0.2, 2.0], [0.1, 0.2, 2.0]])
    uv_j, valid_j = jm.project(jnp.asarray(p))
    for cam in range(2):
        tm = tcam.Pinhole.create((640.0, 480.0), (float(fx[cam]),) * 2, (320.0, 240.0))
        uv, valid = tm.project(_t(p[cam]))
        _close(uv, uv_j[cam])
        assert bool(valid) == bool(valid_j[cam])
    assert not np.allclose(np.asarray(uv_j[0]), np.asarray(uv_j[1]))


def test_tum_fov_roundtrip_and_jacobian():
    tm, uv, uv2, _ = _same_as_jax("tum_fov", 9, n=512)
    _close(tm.unproject(_t(uv))[:, 2], np.ones(len(uv)), 1e-12)
    _close(uv2, uv, 1e-7)


def test_tum_fov_optical_axis_safe():
    jm, tm = MODELS["tum_fov"]()
    uv, _ = tm.project(_t([0.0, 0.0, 3.0]))
    _close(uv, [640.0, 360.0])
    _close(uv, jm.project(jnp.asarray([0.0, 0.0, 3.0]))[0])
    _close(tm.unproject(_t([640.0, 360.0])), [0.0, 0.0, 1.0])


def test_division_roundtrip_and_jacobian():
    tm, uv, uv2, valid = _same_as_jax("division", 10, n=512, jac_tol=1e-7)
    m = valid.numpy()
    _close(uv2.numpy()[m], uv[m], 1e-6)
    assert m.mean() > 0.9


def test_atan_polynomial_roundtrip():
    tm, uv, uv2, valid = _same_as_jax("atan", 11, n=512, jac_tol=1e-7)
    m = valid.numpy()
    assert m.mean() > 0.9
    _close(uv2.numpy()[m], uv[m], 1e-6)


def test_ios_project_unproject_roundtrip():
    _, uv, uv2, valid = _same_as_jax("ios", 11, n=512)
    _close(uv2, uv, 1e-6)
    assert bool(valid.all())


def test_ios_jacobian_vs_autodiff():
    _same_as_jax("ios", 12, n=64, jac_tol=1e-7)


def test_ios_identity_lut_matches_pinhole():
    tm = tcam.IOSCamera.create(SIZE, (448.155, 448.155), (640.0, 360.0), np.zeros(42))
    _, pin = MODELS["pinhole"]()
    uv, depth = _points_in_view(13, 64)
    p3d = pin.unproject(_t(uv)) * _t(depth)[:, None]
    _close(tm.project(p3d)[0], pin.project(p3d)[0])


def test_ios_scaled_model_halves_projection():
    jm, tm = MODELS["ios"]()
    uv, depth = _points_in_view(14, 64)
    p3d = tm.unproject(_t(uv)) * _t(depth)[:, None]
    uv_full, _ = tm.project(p3d)
    uv_half, _ = tm.scaled(2.0).project(p3d, border=0)
    _close(uv_half, uv_full / 2.0, 1e-6)
    _close(uv_half, jm.scaled(2.0).project(jnp.asarray(p3d.numpy()), border=0)[0])
