"""Host models of K1's and K4's own arithmetic (``testing/frontend_models.py``)
against the plain versions, f32 on the CPU:

* K4's ``linspace`` formula equals ``torch.linspace`` to the bit at the
  sweep's 32 samples and the shrink's 11 radii, and its group centres equal
  the plain version's (``sweep_inputs``);
* K4's pose path, inverse(T_w_t) · T_w_k with the card's cross product and
  4-term sum, meets ``relative_poses`` (torch's composition) within
  ``parity.KERNEL_POSE_ULPS``;
* K1's block-by-block indexing (32×32 tiles of level 0 with the coarsest
  level's halo, the coarser tiles built from the finer ones) gives the plain
  pyramid to the bit at 5 and 4 levels, on even and odd sizes.
"""

import numpy as np
import pytest
import torch

from dsopp_tpu_torch.core.camera import Pinhole
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features import pyramid
from dsopp_tpu_torch.testing import frontend_models as fm
from dsopp_tpu_torch.testing import parity
from dsopp_tpu_torch.tracker import depth_estimation as de

F32 = np.float32


@pytest.mark.parametrize("start,end,steps", [(0.0, 1.0, de.NUM_SAMPLES), (1.0, 0.0, 11)])
def test_kernel_linspace_is_torch_linspace(start, end, steps):
    model = fm.linspace(start, end, steps)
    ref = torch.linspace(start, end, steps, dtype=torch.float32).numpy()
    assert model.tobytes() == ref.tobytes()


def test_kernel_group_centres_are_the_plain_ones():
    """``alpha_g`` as the plain version's ``sweep_inputs`` forms it."""
    model = Pinhole(100.0, 100.0, 20.0, 15.0, 40.0, 30.0)
    gen = torch.Generator().manual_seed(0)
    bank = de.make_immature_points(torch.rand((8, 2), generator=gen) * 20 + 10,
                                   torch.rand((8, 8), generator=gen),
                                   torch.rand((8, 2), generator=gen))
    pts = de.ImmaturePoints(*(x[None] for x in bank))
    ident = SE3.identity((1,), torch.float32)
    inp, _ = de.sweep_inputs(pts, model, ident.q, ident.t, torch.zeros(1, 2),
                             torch.zeros(2), torch.ones(1))
    assert inp.alpha_g.numpy().tobytes() == fm.alpha_group().tobytes()
    assert inp.alphas.numpy().tobytes() == fm.linspace(0.0, 1.0, de.NUM_SAMPLES).tobytes()


def _ulps(a, b):
    """Largest |a - b| in units of the last place of the larger of |a|, |b|
    (per pose component, at least that of 1 for quaternions: their scale)."""
    scale = np.maximum(np.abs(a), np.abs(b)).max(axis=-1, keepdims=True)
    return float((np.abs(a - b) / np.spacing(scale.astype(F32))).max())


@pytest.mark.parametrize("rot_scale,trans_scale", [(0.1, 0.5), (1.0, 3.0), (3.0, 10.0)])
def test_kernel_pose_path_meets_the_torch_composition(rot_scale, trans_scale):
    rng = np.random.default_rng(int(10 * rot_scale))
    k = 17
    xi = np.concatenate([rng.normal(size=(k + 1, 3)) * trans_scale,
                         rng.normal(size=(k + 1, 3)) * rot_scale], -1)
    poses = SE3.exp(torch.tensor(xi, dtype=torch.float32))
    pose_q, pose_t = poses.q[0], poses.t[0]
    win_q, win_t = poses.q[1:].contiguous(), poses.t[1:].contiguous()
    ref = de.relative_poses(pose_q, pose_t, win_q, win_t)
    q, t = fm.relative_poses(pose_q.numpy(), pose_t.numpy(), win_q.numpy(), win_t.numpy())
    assert _ulps(q, ref.q.numpy()) <= parity.KERNEL_POSE_ULPS
    assert _ulps(t, ref.t.numpy()) <= parity.KERNEL_POSE_ULPS
    # the composition itself: f64 of the same inputs within a few f32 ulps
    ref64 = de.relative_poses(pose_q.double(), pose_t.double(), win_q.double(), win_t.double())
    assert _ulps(q, ref64.q.numpy()) <= 4 * parity.KERNEL_POSE_ULPS
    assert _ulps(t, ref64.t.numpy()) <= 4 * parity.KERNEL_POSE_ULPS


@pytest.mark.parametrize("levels", [5, 4])
@pytest.mark.parametrize("shape", [(479, 637), (480, 640), (121, 161)])
def test_pyramid_block_indexing_gives_the_plain_maps(levels, shape):
    img = np.random.default_rng(sum(shape) + levels).uniform(0, 255, size=shape).astype(F32)
    model = fm.pyramid(img, levels)
    plain = pyramid.build_pyramid_maps_plain(torch.from_numpy(img), levels)
    assert [m.shape for m in model] == [tuple(p.shape) for p in plain]
    assert [m.shape[1:] for m in model] == pyramid.level_shapes(*shape, levels)
    for lvl, (m, p) in enumerate(zip(model, plain)):
        assert m.tobytes() == p.numpy().tobytes(), f"level {lvl}"


def test_pyramid_level_shapes_refuse_a_level_below_two_pixels():
    assert pyramid.level_shapes(16, 16, 4) == [(16, 16), (8, 8), (4, 4), (2, 2)]
    with pytest.raises(ValueError, match="too small"):
        pyramid.level_shapes(16, 16, 5)
