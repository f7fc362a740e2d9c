"""Port parity: K1's plain version vs ``build_pyramid_maps`` (f64, 1e-12 abs)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dsopp_tpu.features.pyramid import build_pyramid_maps as jax_pyramid
from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.features.pyramid import (build_pyramid_maps, build_pyramid_maps_cuda,
                                              build_pyramid_maps_plain)

from tests._torch_port import assert_close, to_torch


@pytest.mark.parametrize("shape", [(120, 160), (121, 161), (97, 130)])
def test_pyramid_maps_match_reference(shape):
    img = np.random.default_rng(sum(shape)).uniform(0, 255, size=shape)
    ref = jax_pyramid(jnp.asarray(img), 5)
    out = build_pyramid_maps(to_torch(img), 5)
    assert len(out) == 5
    for lvl, (a, b) in enumerate(zip(out, ref)):
        assert tuple(a.shape) == b.shape, lvl
        assert_close(a, b, atol=1e-12, err_msg=f"level {lvl}")


def test_cpu_dispatch_is_the_plain_version():
    img = to_torch(np.random.default_rng(0).uniform(0, 255, size=(40, 52)))
    for a, b in zip(build_pyramid_maps(img, 3), build_pyramid_maps_plain(img, 3)):
        assert_close(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper raises on a CPU tensor and counts no launch."""
    before = kernels.PYRAMID.launches
    with pytest.raises(ValueError, match="CUDA"):
        build_pyramid_maps_cuda(to_torch(np.zeros((16, 16))).float(), 2)
    assert kernels.PYRAMID.launches == before
