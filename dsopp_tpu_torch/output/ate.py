"""Absolute trajectory error (counterpart of ``dsopp_tpu/output/ate.py``,
a numpy copy of it): trajectories associated by timestamp, aligned by the
least-squares rigid or similarity transform (Horn), and the translation
error's RMSE, mean, median and spread (the TUM RGB-D benchmark's metric)."""

from __future__ import annotations

import numpy as np


def associate(est, gt, max_difference=0.02):
    """Match entries by timestamp → list of (est_idx, gt_idx)."""
    gt_times = np.asarray([t for t, _ in gt])
    pairs = []
    used = set()
    for i, (ts, _) in enumerate(est):
        j = int(np.argmin(np.abs(gt_times - ts)))
        if abs(gt_times[j] - ts) <= max_difference and j not in used:
            pairs.append((i, j))
            used.add(j)
    return pairs


def align_trajectories(est_xyz, gt_xyz, with_scale=False):
    """Horn's closed-form alignment: returns (R, t, s) minimizing
    ‖gt − (s R est + t)‖²."""
    mu_e = est_xyz.mean(0)
    mu_g = gt_xyz.mean(0)
    e = est_xyz - mu_e
    g = gt_xyz - mu_g
    w = e.T @ g
    u, d, vt = np.linalg.svd(w)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    rot = vt.T @ s_mat @ u.T
    if with_scale:
        scale = np.trace(np.diag(d) @ s_mat) / (e ** 2).sum()
    else:
        scale = 1.0
    trans = mu_g - scale * rot @ mu_e
    return rot, trans, scale


def absolute_trajectory_error(est, gt, align=True, with_scale=False,
                              max_difference=0.02):
    """ATE statistics dict between [(ts, 4x4)] trajectories."""
    pairs = associate(est, gt, max_difference)
    if not pairs:
        return {"rmse": float("inf"), "matched": 0}
    e = np.stack([np.asarray(est[i][1])[:3, 3] for i, _ in pairs])
    g = np.stack([np.asarray(gt[j][1])[:3, 3] for _, j in pairs])
    if align:
        rot, trans, scale = align_trajectories(e, g, with_scale)
        e = (scale * (rot @ e.T)).T + trans
    err = np.linalg.norm(e - g, axis=1)
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "matched": len(pairs),
    }
