"""Photometric image correction (counterpart of
``dsopp_tpu/sensors/photometric.py`` and of the native
``photometric_correct``): the inverse response G⁻¹ applied to the raw
intensities by linear interpolation in its 256-entry table, then the
division by the vignetting attenuation.

The kernel K18 (``csrc/photometric.cu``) is the camera's whole frame intake:
the upload of the raw frame from pinned host memory, the undistorter's
remap, the crop and the correction, in one C call (:func:`intake_cuda`); its
plain version is the chain it replaces (:func:`intake_plain`).
:func:`correct_image` is the same kernel on a frame already on the card (a
crop may be a view), and the plain correction on a CPU one.  Both take the
raw image as u8 (as a camera stores it) or float.
"""

from __future__ import annotations

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.sensors.undistorter import remap_bilinear

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


def _check_frame(image, name):
    if image.dim() != 2:
        raise ValueError(f"{name}: expected [H, W], got {tuple(image.shape)}")
    if image.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"{name}: expected uint8 or float32, got {image.dtype}")


def _check_correction(inverse_response, vignetting, size):
    kernels.check(inverse_response, "inverse_response", (256,))
    if vignetting is not None:
        kernels.check(vignetting, "vignetting", size)


def correct_image_cuda(image, inverse_response, vignetting=None):
    """Kernel K18 on a frame on the card: the same output as
    :func:`correct_image_plain` in f32, one launch.  ``image``: [H, W] u8 or
    f32 whose rows may lie apart (a crop's view; unit column stride),
    ``inverse_response``: [256] f32, ``vignetting``: [H, W] f32 or None, both
    contiguous on the card."""
    _check_frame(image, "image")
    if not image.is_cuda:
        raise ValueError(f"image: expected a CUDA tensor, got {image.device}")
    if image.stride(1) != 1 or image.stride(0) < image.shape[1]:
        raise ValueError(f"image: expected rows of unit stride, got strides {image.stride()}")
    h, w = image.shape
    _check_correction(inverse_response, vignetting, (h, w))
    out = torch.empty((h, w), dtype=torch.float32, device=image.device)
    kernels.PHOTOMETRIC(None, image, None, int(image.dtype == torch.uint8), h, w,
                        image.stride(0), None, None, 0, inverse_response, vignetting, h, w, out)
    return out


def correct_image(image, inverse_response, vignetting=None):
    """The photometric correction: the kernel K18 on a CUDA image, the plain
    version on a CPU one."""
    fn = correct_image_cuda if image.is_cuda else correct_image_plain
    return fn(image, inverse_response, vignetting)


def intake_plain(image, inverse_response, vignetting=None, maps=None, size=None):
    """The camera's frame intake on the CPU, as the chain it replaced: the
    raw [H, W] frame (u8 or f32) remapped through ``maps`` (f32 (map_x,
    map_y), or None: no undistortion) by ``remap_bilinear``, cropped to its
    top-left ``size`` (h, w; None: all of it), then corrected by
    :func:`correct_image_plain`."""
    image = torch.as_tensor(image)
    if maps is not None:
        image = remap_bilinear(image.to(torch.float32), *maps)
    if size is not None:
        image = image[:size[0], :size[1]]
    return correct_image_plain(image, inverse_response, vignetting)


def intake_cuda(pinned, copied, inverse_response, vignetting=None, maps=None, size=None):
    """Kernel K18 as the camera's frame intake, one C call: the raw [H, W]
    frame in pinned host memory (u8 or f32) is copied into the stream's
    staging buffer and, in one launch, remapped through ``maps`` (f32
    (map_x, map_y) [Hm, Wm] on the card, or None), cropped to its top-left
    ``size`` (h, w; None: the tables' or the frame's size) and corrected.
    Nothing waits: the call records ``copied`` (a ``torch.cuda.Event`` that
    has been recorded once) right after the copy, and the caller keeps
    ``pinned`` alive and unchanged until it reports done: the pair
    ``sensors/pinned.py::PinnedRing.stage`` returns.  The same output as
    :func:`intake_plain` to the bit."""
    _check_frame(pinned, "frame")
    if pinned.is_cuda or not pinned.is_pinned() or not pinned.is_contiguous():
        raise ValueError("frame: expected a contiguous tensor in pinned host memory")
    if not isinstance(copied, torch.cuda.Event) or not copied.cuda_event:
        raise ValueError("copied: expected a torch.cuda.Event that has been recorded once")
    device = inverse_response.device
    src_h, src_w = pinned.shape
    map_x = map_y = None
    if maps is not None:
        map_x, map_y = maps
        kernels.check(map_x, "map_x", map_x.shape)
        kernels.check(map_y, "map_y", map_x.shape)
        full = tuple(map_x.shape)
    else:
        full = (src_h, src_w)
    h, w = full if size is None else size
    if not (0 <= h <= full[0] and 0 <= w <= full[1]):
        raise ValueError(f"size: expected at most {full}, got {(h, w)}")
    _check_correction(inverse_response, vignetting, (h, w))
    staging = kernels.scratch(kernels.PHOTOMETRIC, pinned.numel() * pinned.element_size(), device)
    out = torch.empty((h, w), dtype=torch.float32, device=device)
    kernels.PHOTOMETRIC(pinned, staging, copied.cuda_event, int(pinned.dtype == torch.uint8),
                        src_h, src_w, src_w, map_x, map_y, full[1], inverse_response, vignetting,
                        h, w, out)
    return out
