"""Camera sensor (counterpart of ``dsopp_tpu/sensors/camera.py``): provider →
upload → undistortion → resize → crop → photometric correction (K18).

``Camera.next_frame`` returns the corrected image as an f32 tensor on the
camera's device.  On a card, the frame crosses once, as the provider gives
it (one byte a pixel for a u8 frame), from one of a few pinned host buffers
(``sensors/pinned.py``), and K18 takes it from there in one C call: the
upload, the undistortion, the crop (the output is the crop; nothing is
copied for it) and the correction (``photometric.intake_cuda``); the host
waits for nothing.  On the CPU the same chain runs as plain torch
(``photometric.intake_plain``).  A resize ratio other than 1 resizes on the
host with cv2 (``cv2.INTER_AREA``, f32 in), as the JAX package does: before
the intake when there is nothing to undistort, else between the device's
undistortion and the intake (that route reads the remapped frame back).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from dsopp_tpu_torch import default_device
from dsopp_tpu_torch.sensors.calibration import (CameraCalibration, load_calibration,
                                                 load_photometric_calibration, load_vignetting)
from dsopp_tpu_torch.sensors.masks import load_mask
from dsopp_tpu_torch.sensors.photometric import intake_cuda, intake_plain
from dsopp_tpu_torch.sensors.pinned import PinnedRing, to_device
from dsopp_tpu_torch.sensors.providers import CameraDataFrame, create_provider
from dsopp_tpu_torch.sensors.undistorter import Undistorter, build_remaps, remap_bilinear


@dataclass
class CameraSettings:
    """Calibration bundle of one camera."""

    calibration: CameraCalibration
    inverse_response: np.ndarray             # 256-entry G⁻¹
    vignetting: Optional[np.ndarray] = None  # [H, W] attenuation
    mask: Optional[torch.Tensor] = None      # [H, W] bool
    undistorter: Optional[Undistorter] = None

    @staticmethod
    def from_files(calib_path, pcalib_path=None, vignette_path=None, mask_path=None,
                   transform_to_pinhole=True, shutter_time=0.0,
                   device=None) -> "CameraSettings":
        device = default_device(device)
        calib = load_calibration(calib_path, shutter_time)
        und = None
        if calib.model_type != "pinhole" and transform_to_pinhole:
            und = build_remaps(calib.camera_model(0), device)
            tgt = und.target_model
            calib = CameraCalibration("pinhole", calib.image_size,
                                      np.asarray([tgt.fx, tgt.fy, tgt.cx, tgt.cy]),
                                      calib.shutter_time)
        return CameraSettings(
            calibration=calib, inverse_response=load_photometric_calibration(pcalib_path),
            vignetting=load_vignetting(vignette_path),
            mask=load_mask(mask_path, calib.image_size, device), undistorter=und)


def crop_size_power_of_2(width: int, height: int, levels: int = 4):
    """Largest (w, h) ≤ the input divisible by 2^levels."""
    step = 1 << levels
    return (width >> levels) * step, (height >> levels) * step


def _resize_host(image, size=None, ratio=1.0, interpolation="area"):
    """cv2.resize of a host array (to ``size`` (w, h), or by ``ratio``)."""
    import cv2

    flag = cv2.INTER_AREA if interpolation == "area" else cv2.INTER_NEAREST
    if size is not None:
        return cv2.resize(image, size, interpolation=flag)
    return cv2.resize(image, None, fx=ratio, fy=ratio, interpolation=flag)


@dataclass
class Camera:
    """Camera sensor: pulls provider frames through the correction chain."""

    sensor_id: str
    provider: object
    settings: CameraSettings
    resize_ratio: float = 1.0
    crop_levels: int = 4                     # the cropper always runs
    semantics_folder: Optional[str] = None   # per-frame class-id images
    semantic_filter: tuple = ()              # class ids masked out
    device: Optional[torch.device] = None

    _lut: object = field(default=None, repr=False)
    _vignetting: object = field(default=None, repr=False)
    _ring: PinnedRing = field(default_factory=PinnedRing, repr=False)

    def __post_init__(self):
        self.device = default_device(self.device)

    @staticmethod
    def from_config(sensor_id: str, params: dict, base_dir: str = ".",
                    device=None) -> "Camera":
        def path(key, sub):
            v = sub.get(key)
            return os.path.join(base_dir, v) if v else None

        provider_params = dict(params["provider"])
        for key in ("folder", "timestamps", "video_file"):
            if key in provider_params:
                provider_params[key] = os.path.join(base_dir, provider_params[key])
        model_params = params.get("model", {})
        settings = CameraSettings.from_files(
            path("calibration", model_params), path("photometric_calibration", model_params),
            path("vignetting", model_params), path("camera_mask", params),
            shutter_time=float(model_params.get("shutter_time_seconds", 0.0)), device=device)
        ratio = float(params.get("transformations", {})
                      .get("resize_transformer", {}).get("resize_ratio", 1.0))
        sem_params = params.get("semantics", {}) or {}
        sem_folder = sem_params.get("folder")
        return Camera(sensor_id, create_provider(provider_params), settings, ratio,
                      semantics_folder=os.path.join(base_dir, sem_folder) if sem_folder else None,
                      semantic_filter=tuple(sem_params.get("filter", ())), device=device)

    def camera_model(self, level: int = 0):
        model = self.settings.calibration.camera_model(0)
        if self.resize_ratio != 1.0:
            model = model.scaled(1.0 / self.resize_ratio)
        if self.crop_levels:
            w, h = int(model.width), int(model.height)
            cw, ch = crop_size_power_of_2(w, h, self.crop_levels)
            if (cw, ch) != (w, h):
                # the crop keeps the intrinsics and shrinks the image
                model = model._replace(width=float(cw), height=float(ch))
        return model.scaled(float(2 ** level)) if level else model

    def processed_mask(self):
        """The CameraMask transformed as the frames are (resize + crop), on
        the camera's device."""
        mask = self.settings.mask
        if mask is None:
            return None
        if self.resize_ratio != 1.0:
            host = mask.cpu().numpy().astype(np.uint8)
            mask = torch.as_tensor(_resize_host(host, ratio=self.resize_ratio,
                                                interpolation="nearest") > 0)
        if self.crop_levels:
            cw, ch = crop_size_power_of_2(mask.shape[1], mask.shape[0], self.crop_levels)
            mask = mask[:ch, :cw]
        return mask.to(self.device).contiguous()

    def next_frame(self) -> Optional[CameraDataFrame]:
        frame = self.provider.next_frame()
        if frame is None:
            return None
        img = frame.image
        und = self.settings.undistorter
        maps = None if und is None or und.identity else und.maps32()
        if self.resize_ratio != 1.0:
            if maps is not None:
                raw = torch.as_tensor(np.ascontiguousarray(img)).to(self.device)
                img, maps = remap_bilinear(raw.to(torch.float32), *maps).cpu().numpy(), None
            img = _resize_host(np.asarray(img, np.float32), ratio=self.resize_ratio)
        h, w = img.shape if maps is None else maps[0].shape
        if self.crop_levels:
            w, h = crop_size_power_of_2(w, h, self.crop_levels)
        lut, vignetting = self._photometric((h, w))
        if self.device.type == "cuda":
            corrected = intake_cuda(*self._ring.stage(img), lut, vignetting, maps, (h, w))
        else:
            corrected = intake_plain(np.ascontiguousarray(img), lut, vignetting, maps, (h, w))
        semantics = self._load_semantics(frame.frame_id, tuple(corrected.shape))
        return CameraDataFrame(frame.frame_id, frame.timestamp, corrected, frame.exposure,
                               semantics=semantics)

    @property
    def ring_waits(self) -> int:
        """Frames whose pinned buffer was still being copied when the next
        frame came (the host polled until it was free)."""
        return self._ring.waits

    def _photometric(self, shape):
        """(G⁻¹, vignette) on the device for an image of ``shape``; a
        vignette of another size is resized once with cv2."""
        if self._lut is None:
            self._lut = to_device(np.asarray(self.settings.inverse_response, np.float32),
                                  self.device)
        vignetting = self.settings.vignetting
        if vignetting is None:
            return self._lut, None
        if tuple(vignetting.shape) != tuple(shape):
            vignetting = _resize_host(np.asarray(vignetting, np.float32), (shape[1], shape[0]))
            self.settings.vignetting = vignetting
            self._vignetting = None
        if self._vignetting is None:
            self._vignetting = to_device(np.asarray(vignetting, np.float32), self.device)
        return self._lut, self._vignetting

    def _load_semantics(self, frame_id, image_shape):
        """Class-id image of this frame (``<id>.png``, read with cv2, or
        ``<id>.npy``), transformed as the image (nearest resize + crop); None
        when no semantics are configured or the frame has none."""
        if not self.semantics_folder:
            return None
        for ext in (".png", ".npy"):
            path = os.path.join(self.semantics_folder, f"{frame_id}{ext}")
            if os.path.exists(path):
                break
        else:
            return None
        if path.endswith(".npy"):
            sem = np.load(path)
        else:
            import cv2

            sem = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if sem is None:
            return None
        h, w = image_shape
        if sem.shape != (h, w):
            if self.resize_ratio != 1.0:
                sem = _resize_host(sem, ratio=self.resize_ratio, interpolation="nearest")
            sem = sem[:h, :w]
            if sem.shape != (h, w):   # provider-sized semantics: direct map
                sem = _resize_host(sem, (w, h), interpolation="nearest")
        return np.asarray(sem)
