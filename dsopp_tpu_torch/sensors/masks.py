"""Camera masks (counterpart of ``dsopp_tpu/sensors/masks.py``): [H, W] bool
valid-region tensors, their AND-pooled pyramid, and the semantic filter."""

from __future__ import annotations

import torch

from dsopp_tpu_torch import default_device


def mask_pyramid(mask, num_levels: int):
    """[H, W] bool → tuple of per-level masks; a coarse pixel is valid only
    when its four children are."""
    levels = [mask]
    for _ in range(num_levels - 1):
        m = levels[-1]
        m = m[:(m.shape[0] // 2) * 2, :(m.shape[1] // 2) * 2]
        levels.append(m[0::2, 0::2] & m[0::2, 1::2] & m[1::2, 0::2] & m[1::2, 1::2])
    return tuple(levels)


def load_mask(path, image_size=None, device=None):
    """Mask image (zero pixels invalid, read with cv2) or, with no path, an
    all-valid mask of ``image_size`` (w, h)."""
    device = default_device(device)
    if path is None:
        w, h = int(image_size[0]), int(image_size[1])
        return torch.ones((h, w), dtype=torch.bool, device=device)
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError(f"cannot read mask {path}")
    return torch.as_tensor(img > 0, device=device)


def filter_semantic_objects(mask, semantic_image, excluded_ids):
    """``mask`` less the pixels whose class id is in ``excluded_ids``."""
    sem = torch.as_tensor(semantic_image, device=mask.device)
    bad = torch.zeros_like(mask)
    for cid in excluded_ids:
        bad = bad | (sem == cid)
    return mask & ~bad
