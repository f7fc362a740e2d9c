"""Photometric image correction (counterpart of
``dsopp_tpu/sensors/photometric.py`` and of the native
``photometric_correct``): the inverse response G⁻¹ applied to the raw
intensities by linear interpolation in its 256-entry table, then the
division by the vignetting attenuation.

:func:`correct_image` is the kernel K18 (``csrc/photometric.cu``) on a CUDA
image and the plain version on a CPU one.  Both take the raw image as u8 (as
a camera stores it) or float.
"""

from __future__ import annotations

import torch

from dsopp_tpu_torch import kernels

VIGNETTE_FLOOR = 1e-3


def correct_image_plain(image, inverse_response, vignetting=None):
    """[H, W] raw (0..255) → photometrically corrected irradiance image, in
    the JAX package's order of operations; a u8 image computes in f32."""
    if not image.is_floating_point():
        image = image.to(torch.float32)
    idx = torch.clamp(image, 0.0, 255.0)
    lo = torch.floor(idx).to(torch.int64)
    hi = torch.clamp(lo + 1, max=255)
    frac = idx - lo.to(image.dtype)
    lut = torch.as_tensor(inverse_response, dtype=image.dtype, device=image.device)
    corrected = lut[lo] * (1.0 - frac) + lut[hi] * frac
    if vignetting is not None:
        corrected = corrected / torch.clamp(vignetting, min=VIGNETTE_FLOOR)
    return corrected


def correct_image_cuda(image, inverse_response, vignetting=None):
    """Kernel K18: the same output as :func:`correct_image_plain` in f32, one
    launch.  ``image``: [H, W] u8 or f32, ``inverse_response``: [256] f32,
    ``vignetting``: [H, W] f32 or None, all contiguous on the card."""
    if image.dim() != 2:
        raise ValueError(f"image: expected [H, W], got {tuple(image.shape)}")
    h, w = image.shape
    if image.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"image: expected uint8 or float32, got {image.dtype}")
    kernels.check(image, "image", (h, w), image.dtype)
    kernels.check(inverse_response, "inverse_response", (256,))
    if vignetting is not None:
        kernels.check(vignetting, "vignetting", (h, w))
    out = torch.empty((h, w), dtype=torch.float32, device=image.device)
    kernels.PHOTOMETRIC(image, int(image.dtype == torch.uint8), inverse_response,
                        vignetting, h * w, out)
    return out


def correct_image(image, inverse_response, vignetting=None):
    """The photometric correction: the kernel K18 on a CUDA image, the plain
    version on a CPU one."""
    fn = correct_image_cuda if image.is_cuda else correct_image_plain
    return fn(image, inverse_response, vignetting)
