"""The hand-written CUDA kernels against their plain PyTorch versions, f32
on the card (marked ``gpu``; skipped without a CUDA device).

Tolerances (intensities 0..255): K1 1e-3 abs; K2 num_valid exact, H and b
1e-4 relative (Frobenius), energy 1e-5 relative; K4 best sample equal on
≥ 99.9 % of active landmarks, refined GN energy 1e-4 relative where the
winners agree.

Run on a machine with a card: ``python -m pytest tests/test_torch_kernels_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features import pyramid
from dsopp_tpu_torch.solvers import pose_alignment as pa
from dsopp_tpu_torch.testing import render_sequence
from dsopp_tpu_torch.tracker import depth_estimation as de
from dsopp_tpu_torch.tracker.fused_keyframe import immature_bank

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seq = render_sequence(num_frames=4, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    return seq


def test_pyramid_kernel_matches_plain(scene):
    img = scene.images[1].contiguous()
    before = kernels.PYRAMID.launches
    for a, b in zip(pyramid.build_pyramid_maps_cuda(img, 5),
                    pyramid.build_pyramid_maps_plain(img, 5)):
        assert float((a - b).abs().max()) <= 1e-3
    assert kernels.PYRAMID.launches == before + 5
    odd = torch.rand(121, 161, device="cuda") * 255
    for a, b in zip(pyramid.build_pyramid_maps_cuda(odd, 4),
                    pyramid.build_pyramid_maps_plain(odd, 4)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-3


def test_align_kernel_matches_plain(scene):
    rng = np.random.default_rng(0)
    maps = pyramid.build_pyramid_maps_cuda(scene.images[2].contiguous(), 2)
    n = 1500
    uv = torch.tensor(rng.uniform(8, [312, 232], size=(n, 2)), dtype=torch.float32, device="cuda")
    depth = scene.depths[0][uv[:, 1].long(), uv[:, 0].long()]
    pts = pa.LevelPoints(uv, (1.0 / depth).contiguous(),
                         scene.images[0][uv[:, 1].long(), uv[:, 0].long()].contiguous(),
                         torch.tensor(rng.random(n) < 0.9, device="cuda"))
    t_rel = scene.pose(2, torch.float32, "cuda").inverse() @ scene.pose(0, torch.float32, "cuda")
    xi = torch.tensor(rng.normal(size=(5, 6)) * 3e-3, dtype=torch.float32, device="cuda")
    hyp = SE3.exp(xi) @ SE3(t_rel.q.expand(5, 4), t_rel.t.expand(5, 3))
    aff = torch.tensor(rng.normal(size=(5, 2)) * [0.01, 1.0], dtype=torch.float32, device="cuda")
    ref = torch.tensor([0.01, -1.0], device="cuda")
    args = (pts, maps[0], scene.camera, hyp, aff, ref, torch.tensor(1.05, device="cuda"), 20.0)
    hk, bk, ek, nk = pa.residual_system_cuda(*args)
    hp, bp, ep, np_ = pa.residual_system_plain(*args)
    assert torch.equal(nk, np_) and int(nk.min()) > 100
    assert float(((hk - hp).norm(dim=(1, 2)) / hp.norm(dim=(1, 2))).max()) <= 1e-4
    assert float(((bk - bp).norm(dim=1) / bp.norm(dim=1)).max()) <= 1e-4
    assert float(((ek - ep).abs() / ep.abs()).max()) <= 1e-5


def test_epipolar_kernel_matches_plain(scene):
    k = 2
    banks = [immature_bank(pyramid.build_pyramid_maps_cuda(scene.images[0].contiguous(), 1)[0], 400)
             for _ in range(k)]
    pts = de.ImmaturePoints(*(torch.stack(x) for x in zip(*banks)))
    t_rel = scene.pose(3, torch.float32, "cuda").inverse() @ scene.pose(0, torch.float32, "cuda")
    inp, geo = de.sweep_inputs(pts, scene.camera, t_rel.q.expand(k, 4).contiguous(),
                               t_rel.t.expand(k, 3).contiguous(),
                               torch.zeros(k, 2, device="cuda"), torch.zeros(2, device="cuda"),
                               torch.ones(k, device="cuda"))
    img = scene.images[3].contiguous()
    rk = de.epipolar_sweep_cuda(inp, img, scene.camera, 20.0)
    rp = de.epipolar_sweep_plain(inp, img, scene.camera, 20.0)
    act = inp.active
    same = (rk.best_idx == rp.best_idx) & act
    assert float(same.sum()) >= 0.999 * float(act.sum())
    assert torch.equal(rk.any_sample[act], rp.any_sample[act])
    fin = same & torch.isfinite(rp.refined_energy)
    rel = (rk.refined_energy[fin] - rp.refined_energy[fin]).abs() / rp.refined_energy[fin].clamp(min=1.0)
    assert float(rel.max()) <= 1e-4
    with pytest.raises(ValueError):
        de.epipolar_sweep_cuda(inp._replace(alphas=inp.alphas[:16].contiguous()), img,
                               scene.camera, 20.0)
