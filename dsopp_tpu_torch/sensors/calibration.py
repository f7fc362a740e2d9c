"""Camera calibration, photometric calibration and vignetting (counterpart
of ``dsopp_tpu/sensors/calibration.py``): ``calib.txt`` holds a model tag,
the image size and the intrinsics; ``pcalib.txt`` the 256 values of the
inverse response G⁻¹; the vignette is a 16-bit image (read with cv2)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from dsopp_tpu_torch.core.camera import IOSCamera, Pinhole, SimpleRadial, TumFov


@dataclass
class CameraCalibration:
    model_type: str             # "pinhole" | "simple_radial" | "tum_fov" | "ios"
    image_size: tuple           # (width, height)
    intrinsics: np.ndarray
    shutter_time: float = 0.0

    def camera_model(self, level: int = 0):
        """The model of pyramid level ``level`` (focal length and principal
        point divided by 2**level)."""
        intr = [float(v) for v in np.asarray(self.intrinsics).reshape(-1)]
        if self.model_type == "pinhole":
            model = Pinhole.create(self.image_size, intr[0:2], intr[2:4])
        elif self.model_type == "simple_radial":
            f, cx, cy, k1, k2 = intr[:5]
            model = SimpleRadial.create(self.image_size, f, (cx, cy), k1, k2)
        elif self.model_type == "tum_fov":
            model = TumFov.create(self.image_size, intr[0:2], intr[2:4], intr[4])
        elif self.model_type == "ios":
            model = IOSCamera.create(self.image_size, intr[0:2], intr[2:4], intr[4:])
        else:
            raise ValueError(f"unknown model type {self.model_type!r}")
        return model.scaled(float(2 ** level)) if level else model


def load_calibration(path: str, shutter_time: float = 0.0) -> CameraCalibration:
    """Parse a ``calib.txt``::

        <model>           # pinhole | simple_radial | tum_fov | ios
        <width> <height>
        <intrinsics...>   # pinhole: fx fy cx cy; simple_radial: f cx cy k1 k2;
                          # tum_fov: fx fy cx cy (relative to the size) fov;
                          # ios: fx fy cx cy and the magnifier table
    """
    with open(path) as f:
        tokens = f.read().split()
    model = tokens[0]
    vals = [float(t) for t in tokens[1:]]
    w, h = vals[0], vals[1]
    rest = vals[2:]
    needed = {"pinhole": 4, "simple_radial": 5, "tum_fov": 5, "ios": 6}.get(model)
    if needed is None:
        raise ValueError(f"unknown calibration model {model!r}")
    if len(rest) < needed:
        raise ValueError(f"{path}: {model} needs {needed} intrinsics, got {len(rest)}")
    if model == "pinhole":
        return CameraCalibration("pinhole", (w, h), np.asarray(rest[:4]), shutter_time)
    if model == "simple_radial":
        return CameraCalibration("simple_radial", (w, h), np.asarray(rest[:5]), shutter_time)
    if model == "tum_fov":
        # relative intrinsics, stored in pixels for build_remaps
        fx, fy, cx, cy, fov = rest[:5]
        intr = np.asarray([fx * w, fy * h, cx * w, cy * h, fov])
        return CameraCalibration("tum_fov", (w, h), intr, shutter_time)
    return CameraCalibration("ios", (w, h), np.asarray(rest), shutter_time)


def load_photometric_calibration(path: Optional[str]) -> np.ndarray:
    """``pcalib.txt``: 256 values of G⁻¹; the identity when the file is
    missing or does not hold 256 values."""
    identity = np.arange(256, dtype=np.float32)
    if path is None:
        return identity
    try:
        with open(path) as f:
            vals = [float(t) for t in f.read().split()]
    except OSError:
        return identity
    if len(vals) != 256:
        return identity
    return np.asarray(vals, np.float32)


def load_vignetting(path: Optional[str]) -> Optional[np.ndarray]:
    """``vignette.png`` (16-bit, read with cv2) → [H, W] attenuation in (0, 1]."""
    if path is None:
        return None
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        return None
    img = img.astype(np.float32)
    return img / img.max()
