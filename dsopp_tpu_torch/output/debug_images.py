"""Visualizer-style debug imagery (counterpart of
``dsopp_tpu/output/debug_images.py``, a numpy copy of it).

The reference visualizer's per-frame debug views (monocular_tracker.cpp's
``debugCurrentFrame`` mask overlay and ``debugCurrentKeyframe`` idepth JET
colormap, rendered live by its Pangolin window) as offline numpy images;
they take host arrays (copy a tracker's CUDA tensors to the host first).

The exponential smoothing of the visualization maximum idepth
(kSmoothingFactor = 0.9) is kept so colors are stable across frames.
"""

from __future__ import annotations

import numpy as np

SMOOTHING_FACTOR = 0.9


def _jet(values01):
    """Minimal JET colormap: values in [0, 1] → [..., 3] uint8 (B, G, R order
    like cv::applyColorMap)."""
    v = np.clip(np.asarray(values01, np.float64), 0.0, 1.0)
    four = 4.0 * v
    r = np.clip(np.minimum(four - 1.5, -four + 4.5), 0, 1)
    g = np.clip(np.minimum(four - 0.5, -four + 3.5), 0, 1)
    b = np.clip(np.minimum(four + 0.5, -four + 2.5), 0, 1)
    return (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)


def _to_bgr(image):
    img = np.asarray(image)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=-1)


def debug_current_frame(image, mask=None):
    """Grayscale frame with the invalid-mask region tinted red
    (debugCurrentFrame, monocular_tracker.cpp:323-333)."""
    debug = _to_bgr(image).astype(np.int16)
    if mask is not None:
        invalid = ~np.asarray(mask, bool)
        # subtract half-red like the reference (red channel boost on invalid)
        debug[invalid, 2] = np.clip(debug[invalid, 2] + 127, 0, 255)
        debug[invalid, 0] = debug[invalid, 0] // 2
        debug[invalid, 1] = debug[invalid, 1] // 2
    return np.clip(debug, 0, 255).astype(np.uint8)


class KeyframeDepthDebug:
    """Stateful idepth-colormap renderer (debugCurrentKeyframe,
    monocular_tracker.cpp:336-374)."""

    def __init__(self, radius: int = 3):
        self.visualization_maximum_idepth = 0.0
        self.radius = radius

    def render(self, image, idepth_map, weight_map):
        """→ BGR uint8 image with JET-colored semi-dense idepth dots.

        ``idepth_map``/``weight_map``: the accumulated [H, W] depth-map
        grids (idepth·weight sums and weight sums, tracker/depth_map.py).
        """
        idep = np.asarray(idepth_map, np.float64)
        wei = np.asarray(weight_map, np.float64)
        valid = (idep > 0) & (wei > 0)
        debug = _to_bgr(image)
        if not valid.any():
            return debug

        values = np.where(valid, idep / np.maximum(wei, 1e-12), 0.0)
        avg = values[valid].mean()
        if self.visualization_maximum_idepth == 0.0:
            self.visualization_maximum_idepth = 2.0 * avg
        self.visualization_maximum_idepth = (
            SMOOTHING_FACTOR * self.visualization_maximum_idepth
            + (1.0 - SMOOTHING_FACTOR) * 2.0 * avg)

        colors = _jet(values / max(self.visualization_maximum_idepth, 1e-12))
        ys, xs = np.where(valid)
        r = self.radius
        h, w = idep.shape
        for y, x in zip(ys, xs):
            y0, y1 = max(0, y - r), min(h, y + r + 1)
            x0, x1 = max(0, x - r), min(w, x + r + 1)
            debug[y0:y1, x0:x1] = colors[y, x]
        return debug


def save_debug_image(path, image_bgr):
    """Write a BGR uint8 image: a PNG through cv2 where cv2 imports, else
    ``<path>.npy``."""
    try:
        import cv2
    except ImportError:
        np.save(str(path) + ".npy", image_bgr)
        return
    cv2.imwrite(str(path), image_bgr)
