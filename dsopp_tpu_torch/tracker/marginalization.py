"""Sparse frame-marginalization policy (counterpart of
``dsopp_tpu/tracker/marginalization.py::flags_device``/``kept_first_perm``).

1. flag frames whose live-landmark fraction fell below
   1 − max_marginalized_fraction while the window stays above its minimum;
2. if the window is still too large, flag the frame maximizing DSO eq (20):
   √dist(newest) · Σ 1/(ε + dist(other));
3. triage landmarks: residual to the newest frame not Ok (or anchored in a
   flagged frame) → marginalize if optimized at least once, else outlier;
   long-lived well-observed landmarks also marginalize.
"""

from __future__ import annotations

import torch

from dsopp_tpu_torch.solvers.pba import RES_OK, Window, newest_slot

KEEP_FRAMES_FROM_END = 2
MIN_FRAME_AGE = 1
EPS_DIST = 1e-5


def flags_device(window: Window, imm_counts, minimum_size: int, maximum_size: int,
                 maximum_marginalized_fraction: float):
    """→ (frame_flags [K] bool, landmark_flags [K, N] bool, new_outliers [K, N] bool)."""
    k = window.num_slots
    dev = window.frame_valid.device
    idx = torch.arange(k, device=dev)
    f = window.frame_valid.sum()
    live = window.lm_valid & ~window.lm_outlier
    active_counts = torch.sum(live, dim=1) + imm_counts
    total_counts = active_counts

    elig1 = idx < f - KEEP_FRAMES_FROM_END
    cand1 = (elig1 & (total_counts > 0)
             & (active_counts < (1.0 - maximum_marginalized_fraction) * total_counts))
    c1 = cand1.to(torch.int64)
    prior = torch.cumsum(c1, dim=0) - c1
    flag1 = cand1 & ((f - prior) > minimum_size)

    poses_t = window.poses().t
    ids = window.frame_id
    newest = newest_slot(window)
    newest_id = ids.index_select(0, newest)[0]
    t_new = poses_t.index_select(0, newest)[0]
    elig_i = elig1 & (ids + MIN_FRAME_AGE <= newest_id)
    elig_j = elig1 & (ids + MIN_FRAME_AGE <= newest_id + 1)
    dist = torch.linalg.vector_norm(poses_t[:, None, :] - poses_t[None, :, :], dim=-1)
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    inv = torch.where(elig_j[None, :] & ~eye, 1.0 / (EPS_DIST + dist), torch.zeros_like(dist))
    score = torch.sqrt(torch.linalg.vector_norm(poses_t - t_new[None, :], dim=-1)) * torch.sum(inv, dim=1)
    score = torch.where(elig_i, score, torch.zeros_like(score))
    best_i = torch.argmax(score)
    need2 = f > maximum_size + torch.sum(flag1)
    flag2 = need2 & (torch.max(score) > 0) & (idx == best_i)
    frame_flags = flag1 | flag2

    tri = ((idx < f - 1) & (f > KEEP_FRAMES_FROM_END))[:, None]
    status_newest = torch.gather(
        window.res_status, 1,
        newest.view(1, 1, 1).expand(k, 1, window.num_landmark_slots))[:, 0]
    oob = (status_newest != RES_OK) | frame_flags[:, None]
    min_good = (minimum_size + 1) // 2
    good_opts = maximum_size * 2
    valid_marg = (window.lm_inliers >= min_good) & (window.lm_opt_count > good_opts)
    sufficient = window.lm_opt_count > 0
    new_outliers = tri & live & oob & ~sufficient
    lm_flags = tri & live & ~new_outliers & (oob | valid_marg)
    lm_flags = lm_flags | ((idx < f)[:, None] & frame_flags[:, None] & live & ~new_outliers)
    return frame_flags, lm_flags, new_outliers


def kept_first_perm(frame_valid, frame_flags):
    """Stable kept-frames-first slot permutation."""
    key = torch.where(frame_valid & ~frame_flags, 0, 1)
    return torch.argsort(key, stable=True)
