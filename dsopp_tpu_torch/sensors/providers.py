"""Camera data providers (counterpart of ``dsopp_tpu/sensors/providers.py``):

* ``ImageFolderProvider``: a folder of ``<frame_id>.<ext>`` images and a times
  file (``id timestamp [exposure]`` per line), decoded with cv2;
* ``ImageVideoProvider``: a video file and a times CSV, decoded with cv2;
* ``NpyFolderProvider``: ``<frame_id>.npy`` arrays, read with numpy.

Frames come out as host numpy arrays with (id, timestamp, exposure), in f32
as the JAX package's providers give them, except that the npy provider keeps
a u8 frame as stored (the same values, and the camera moves one byte a pixel
to the card).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".bmp", ".png"}


@dataclass
class CameraDataFrame:
    """One camera frame."""

    frame_id: int
    timestamp: float
    image: object              # [H, W]: numpy from a provider, a tensor from Camera
    exposure: float = 1.0
    semantics: Optional[np.ndarray] = None  # [H, W] class-id image


def _read_times(path):
    """times file: ``id timestamp [exposure]`` per line."""
    times = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            fid = int(parts[0])
            ts = float(parts[1]) if len(parts) > 1 else float(fid)
            exposure = float(parts[2]) if len(parts) > 2 else 1.0
            times[fid] = (ts, exposure)
    return times


def _to_gray_f32(img):
    import cv2

    if img is None:
        raise IOError("failed to decode image")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return img.astype(np.float32)


def _numbered_files(folder, accept):
    files = {}
    for name in sorted(os.listdir(folder)):
        stem, ext = os.path.splitext(name)
        if accept(ext):
            try:
                files[int(stem)] = os.path.join(folder, name)
            except ValueError:
                continue
    return dict(sorted(files.items()))


class ImageFolderProvider:
    """Frames from a folder of ``<frame_id>.<ext>`` images."""

    def __init__(self, folder: str, timestamps: Optional[str] = None,
                 start_frame: int = 0, timestamps_start_id: int = 0):
        self.folder = folder
        self.files = _numbered_files(folder, lambda ext: ext.lower() in IMAGE_EXTENSIONS)
        self.times = _read_times(timestamps) if timestamps else {}
        self.timestamps_start_id = timestamps_start_id
        self.queue = [fid for fid in self.files if fid >= start_frame]
        self.pos = 0

    def __len__(self):
        return len(self.queue) - self.pos

    def next_frame(self) -> Optional[CameraDataFrame]:
        import cv2

        if self.pos >= len(self.queue):
            return None
        fid = self.queue[self.pos]
        self.pos += 1
        img = _to_gray_f32(cv2.imread(self.files[fid], cv2.IMREAD_UNCHANGED))
        ts, exposure = self.times.get(fid + self.timestamps_start_id, (float(fid), 1.0))
        return CameraDataFrame(fid, ts, img, exposure)


class ImageVideoProvider:
    """Frames from a video file + times CSV (``frame_id,timestamp[,exposure]``)."""

    def __init__(self, video_path: str, timestamps: str, start_frame: int = 0):
        import cv2

        self.capture = cv2.VideoCapture(video_path)
        if not self.capture.isOpened():
            raise IOError(f"cannot open video {video_path}")
        self.times = {}
        with open(timestamps) as f:
            for line in f:
                parts = line.replace(",", " ").split()
                if not parts or not parts[0].lstrip("-").isdigit():
                    continue
                fid = int(parts[0])
                ts = float(parts[1]) if len(parts) > 1 else float(fid)
                exp = float(parts[2]) if len(parts) > 2 else 1.0
                self.times[fid] = (ts, exp)
        self.frame_id = 0
        for _ in range(start_frame):
            self.capture.grab()
            self.frame_id += 1

    def next_frame(self) -> Optional[CameraDataFrame]:
        ok, img = self.capture.read()
        if not ok:
            return None
        fid = self.frame_id
        self.frame_id += 1
        ts, exposure = self.times.get(fid, (float(fid), 1.0))
        return CameraDataFrame(fid, ts, _to_gray_f32(img), exposure)


class NpyFolderProvider:
    """Frames stored as ``<frame_id>.npy`` arrays: u8 as stored, any other
    dtype as f32."""

    def __init__(self, folder: str, timestamps: Optional[str] = None,
                 start_frame: int = 0):
        self.files = _numbered_files(folder, lambda ext: ext == ".npy")
        self.times = _read_times(timestamps) if timestamps else {}
        self.queue = [fid for fid in self.files if fid >= start_frame]
        self.pos = 0

    def next_frame(self) -> Optional[CameraDataFrame]:
        if self.pos >= len(self.queue):
            return None
        fid = self.queue[self.pos]
        self.pos += 1
        ts, exposure = self.times.get(fid, (float(fid), 1.0))
        image = np.load(self.files[fid])
        if image.dtype != np.uint8:
            image = image.astype(np.float32)
        return CameraDataFrame(fid, ts, image, exposure)


def create_provider(params: dict):
    """Provider from a config section (``type``: image_folder | video |
    npy_folder)."""
    kind = params.get("type", "image_folder")
    if kind == "image_folder":
        return ImageFolderProvider(
            params["folder"], params.get("timestamps"), int(params.get("start_frame", 0)),
            int(params.get("timestamps_start_id", 0)))
    if kind == "video":
        return ImageVideoProvider(params["video_file"], params["timestamps"],
                                  int(params.get("start_frame", 0)))
    if kind == "npy_folder":
        return NpyFolderProvider(params["folder"], params.get("timestamps"),
                                 int(params.get("start_frame", 0)))
    raise ValueError(f"unknown provider type {kind!r}")
