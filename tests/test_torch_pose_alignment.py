"""Port parity: K2's plain version vs ``_residual_system`` and the LM driver
vs ``align_level`` on GT level points with a perturbed pose, levels 0..4.
num_valid exact; other outputs 1e-9 relative (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.solvers.pose_alignment import AlignmentOptions as JOpts
from dsopp_tpu.solvers.pose_alignment import _residual_system, align_level as jax_align_level
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import (frame_pyramid_maps, gt_level_points,
                                        perturbed_pose, pyramid_models)
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.solvers.pose_alignment import (AlignmentOptions, align_level,
                                                    residual_system, residual_system_cuda)

from tests._torch_port import assert_close, assert_equal, to_torch

LEVELS = 5
RATIO = 1.07          # exposure ratio ≠ 1 exercises the brightness model
AFF_REF = np.array([0.01, -1.5])
AFF = np.array([0.03, 2.0])


@pytest.fixture(scope="module")
def problem():
    seq = render_sequence(num_frames=4, height=240, width=320)
    pts = gt_level_points(seq, 0, LEVELS, stride=8)
    maps = frame_pyramid_maps(seq, 2, LEVELS)
    models = pyramid_models(seq.camera, LEVELS)
    t_gt = seq.t_target_ref(2, 0)
    init = perturbed_pose(t_gt, jax.random.PRNGKey(3), 5e-3, 5e-3)
    return pts, maps, models, init


def _port(pts, pixel_map, model):
    return (convert.level_points(*pts), to_torch(pixel_map),
            convert.pinhole(model.fx, model.fy, model.cx, model.cy, model.image_size))


@pytest.mark.parametrize("level", range(LEVELS))
def test_residual_system_matches(problem, level):
    pts, maps, models, init = problem
    e_j, n_j, (h_j, b_j) = _residual_system(
        pts[level], maps[level], models[level], init, jnp.asarray(AFF),
        jnp.asarray(AFF_REF), RATIO, JOpts(), with_jacobian=True)
    tp, tm, tc = _port(pts[level], maps[level], models[level])
    e_t, n_t, h_t, b_t = residual_system(
        tp, tm, tc, SE3(to_torch(init.q)[None], to_torch(init.t)[None]),
        to_torch(AFF)[None], to_torch(AFF_REF), RATIO, AlignmentOptions())
    assert int(n_t[0]) == int(n_j) > 0
    assert_close(e_t[0], e_j, rtol=1e-9)
    assert_close(b_t[0], b_j, rtol=1e-9, atol=1e-9 * float(jnp.max(jnp.abs(b_j))))
    assert_close(h_t[0], h_j, rtol=1e-9, atol=1e-9 * float(jnp.max(jnp.abs(h_j))))


@pytest.mark.parametrize("level", range(LEVELS))
def test_align_level_matches(problem, level):
    pts, maps, models, init = problem
    res_j = jax_align_level(pts[level], maps[level], models[level], init,
                            jnp.asarray(AFF), jnp.asarray(AFF_REF), RATIO, JOpts())
    tp, tm, tc = _port(pts[level], maps[level], models[level])
    res_t = align_level(tp, tm, tc, SE3(to_torch(init.q)[None], to_torch(init.t)[None]),
                        to_torch(AFF)[None], to_torch(AFF_REF), RATIO, AlignmentOptions())
    assert int(res_t.num_valid[0]) == int(res_j.num_valid)
    # vectors: 1e-9 relative to the vector's largest entry
    for a, b in ((res_t.t_t_r.q[0], res_j.t_t_r.q), (res_t.t_t_r.t[0], res_j.t_t_r.t),
                 (res_t.affine[0], res_j.affine)):
        assert_close(a, b, atol=1e-9 * float(jnp.max(jnp.abs(b))))
    assert_close(res_t.energy[0], res_j.energy, rtol=1e-9)
    assert_close(res_t.rmse[0], res_j.rmse, rtol=1e-9)


def test_batched_hypotheses_are_independent(problem):
    """A batch of hypotheses gives each one's solo result (the done mask
    freezes converged hypotheses as the reference's while-loop does)."""
    pts, maps, models, init = problem
    tp, tm, tc = _port(pts[2], maps[2], models[2])
    xi = np.random.default_rng(5).normal(size=(3, 6)) * 2e-2
    hyps = [init @ JSE3.exp(jnp.asarray(x)) for x in xi]
    q = to_torch(np.stack([np.asarray(h.q) for h in hyps]))
    t = to_torch(np.stack([np.asarray(h.t) for h in hyps]))
    aff = to_torch(np.tile(AFF, (3, 1)))
    batch = align_level(tp, tm, tc, SE3(q, t), aff, to_torch(AFF_REF), RATIO, AlignmentOptions())
    for i in range(3):
        solo = align_level(tp, tm, tc, SE3(q[i:i + 1], t[i:i + 1]), aff[i:i + 1],
                           to_torch(AFF_REF), RATIO, AlignmentOptions())
        assert_equal(batch.num_valid[i:i + 1], solo.num_valid)
        assert_close(batch.t_t_r.t[i:i + 1], solo.t_t_r.t, rtol=1e-12, atol=1e-15)


def test_kernel_wrapper_refuses_cpu_tensors(problem):
    pts, maps, models, init = problem
    tp, tm, tc = _port(pts[1], maps[1], models[1])
    f32 = lambda x: x.float()  # noqa: E731
    before = kernels.ALIGN.launches
    with pytest.raises(ValueError, match="CUDA"):
        residual_system_cuda(tp._replace(uv=f32(tp.uv), idepth=f32(tp.idepth),
                                         intensity=f32(tp.intensity)),
                             f32(tm), tc, SE3(f32(to_torch(init.q))[None], f32(to_torch(init.t))[None]),
                             f32(to_torch(AFF))[None], f32(to_torch(AFF_REF)), 1.0, 20.0)
    assert kernels.ALIGN.launches == before
