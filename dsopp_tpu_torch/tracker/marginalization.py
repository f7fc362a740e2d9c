"""Sparse frame-marginalization policy (counterpart of
``dsopp_tpu/tracker/marginalization.py::flags_device``/``kept_first_perm``).

1. flag frames whose live-landmark fraction fell below
   1 − max_marginalized_fraction while the window stays above its minimum;
2. if the window is still too large, flag the frame maximizing DSO eq (20):
   √dist(newest) · Σ 1/(ε + dist(other));
3. triage landmarks: residual to the newest frame not Ok (or anchored in a
   flagged frame) → marginalize if optimized at least once, else outlier;
   long-lived well-observed landmarks also marginalize.

:func:`flags_device` takes the immature banks' valid mask [K, M] (the JAX
function takes its row sums) and dispatches on the device of its tensors: CPU
tensors take the plain version, CUDA tensors kernel K15p
(``csrc/marg_policy.cu``), which counts the valid immature points and
composes the frames' positions itself and reads nothing on the host.
:func:`kept_first_perm` is plain torch: the kernel writes the permutation with
the flags.  :func:`flags_sequences` takes S sequences of a stacked window in
one launch (the kernel's grid z), :func:`flags_device_cuda` is its case of
one.
"""

from __future__ import annotations

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.solvers.pba import (RES_OK, Window, _kernel_sequences, newest_slot,
                                         sequence_list, stack_size, window_at)

KEEP_FRAMES_FROM_END = 2
MIN_FRAME_AGE = 1
EPS_DIST = 1e-5
# frame slots kernel K15p holds in shared memory
_POLICY_MAX_FRAMES = 40


def flags_device_plain(window: Window, immature_valid, minimum_size: int, maximum_size: int,
                       maximum_marginalized_fraction: float):
    """``immature_valid`` [K, M] bool: the immature banks' valid points →
    (frame_flags [K] bool, landmark_flags [K, N] bool, new_outliers [K, N]
    bool, perm [K] long: the stable kept-frames-first slot order)."""
    k = window.num_slots
    dev = window.frame_valid.device
    idx = torch.arange(k, device=dev)
    f = window.frame_valid.sum()
    live = window.lm_valid & ~window.lm_outlier
    active_counts = torch.sum(live, dim=1) + torch.sum(immature_valid, dim=1)
    total_counts = active_counts

    elig1 = idx < f - KEEP_FRAMES_FROM_END
    cand1 = (elig1 & (total_counts > 0)
             & (active_counts < (1.0 - maximum_marginalized_fraction) * total_counts))
    c1 = cand1.to(torch.int64)
    prior = torch.cumsum(c1, dim=0) - c1
    flag1 = cand1 & ((f - prior) > minimum_size)

    score = eq20_scores(window)
    best_i = torch.argmax(score)
    need2 = f > maximum_size + torch.sum(flag1)
    flag2 = need2 & (torch.max(score) > 0) & (idx == best_i)
    frame_flags = flag1 | flag2

    lm_flags, new_outliers = landmark_triage(window, frame_flags, minimum_size, maximum_size)
    return frame_flags, lm_flags, new_outliers, kept_first_perm(window.frame_valid, frame_flags)


def landmark_triage(window: Window, frame_flags, minimum_size: int, maximum_size: int):
    """Rule 3 for the frame flags ``frame_flags`` [K] → (landmark_flags [K, N]
    bool, new_outliers [K, N] bool)."""
    k = window.num_slots
    idx = torch.arange(k, device=frame_flags.device)
    f = window.frame_valid.sum()
    live = window.lm_valid & ~window.lm_outlier
    newest = newest_slot(window)
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
    return lm_flags, new_outliers


def eq20_scores(window: Window):
    """[K] DSO eq (20) score √|t_i − t_newest| · Σ_j 1/(ε + |t_i − t_j|) of
    every slot, zero where the slot may not be flagged (the plain version's
    arithmetic)."""
    k = window.num_slots
    dev = window.frame_valid.device
    idx = torch.arange(k, device=dev)
    elig1 = idx < window.frame_valid.sum() - KEEP_FRAMES_FROM_END
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
    return torch.where(elig_i, score, torch.zeros_like(score))


def flags_device_cuda(window: Window, immature_valid, minimum_size: int, maximum_size: int,
                      maximum_marginalized_fraction: float):
    """Kernel K15p: same outputs as :func:`flags_device_plain`, from the
    window's raw tensors and ``immature_valid`` in one C call (checks, the
    outputs' ``torch.empty`` and the launch: no other torch operator).  The
    kernel composes the frames' positions T_lin·exp(ε) itself, within
    ``testing/parity.py::KERNEL_POSE_ULPS`` of ``window.poses()``.  The
    one-sequence case of :func:`_flags_sequences_cuda`."""
    return _flags_sequences_cuda(window, immature_valid, (0,), minimum_size, maximum_size,
                                 maximum_marginalized_fraction, stacked=False)


def _flags_sequences_cuda(windows: Window, immature_valid, seqs: tuple, minimum_size: int,
                          maximum_size: int, maximum_marginalized_fraction: float,
                          stacked: bool = True):
    """Kernel K15p for the S sequences ``seqs`` (a checked host list) of a
    stacked window and its stacked ``immature_valid`` [B, K, M], one block a
    sequence in one launch → the outputs of :func:`flags_device_plain`, each
    with a leading [S] axis.  ``stacked=False``: one window, ``seqs`` (0,),
    the inputs and outputs without the sequence axis."""
    lead = windows.t_lin_q.shape[:1] if stacked else ()
    batch = lead[0] if stacked else 1
    k, n = windows.t_lin_q.shape[-2], windows.lm_uv.shape[-2]
    if k > _POLICY_MAX_FRAMES:
        raise ValueError(f"marg_policy: {k} frame slots exceed the kernel's limit of "
                         f"{_POLICY_MAX_FRAMES}")
    check = kernels.check
    check(windows.frame_valid, "frame_valid", lead + (k,), torch.bool)
    for name in ("lm_valid", "lm_outlier"):
        check(getattr(windows, name), name, lead + (k, n), torch.bool)
    for name in ("lm_inliers", "lm_opt_count"):
        check(getattr(windows, name), name, lead + (k, n), torch.int32)
    check(windows.frame_id, "frame_id", lead + (k,), torch.int32)
    check(windows.res_status, "res_status", lead + (k, k, n), torch.int32)
    check(windows.t_lin_q, "t_lin_q", lead + (k, 4))
    check(windows.t_lin_t, "t_lin_t", lead + (k, 3))
    check(windows.eps, "eps", lead + (k, 8))
    m = immature_valid.shape[-1]
    check(immature_valid, "immature_valid", lead + (k, m), torch.bool)
    dev = windows.eps.device
    own = (len(seqs),) if stacked else ()
    frame_flags = torch.empty(own + (k,), dtype=torch.bool, device=dev)
    lm_flags = torch.empty(own + (k, n), dtype=torch.bool, device=dev)
    new_outliers = torch.empty(own + (k, n), dtype=torch.bool, device=dev)
    perm = torch.empty(own + (k,), dtype=torch.int64, device=dev)
    kernels.MARG_POLICY(windows.frame_valid, windows.lm_valid, windows.lm_outlier,
                        windows.lm_inliers, windows.lm_opt_count, windows.frame_id,
                        windows.res_status, windows.t_lin_q, windows.t_lin_t, windows.eps,
                        immature_valid, k, n, m, minimum_size, maximum_size,
                        1.0 - maximum_marginalized_fraction, frame_flags, lm_flags,
                        new_outliers, perm, len(seqs), _kernel_sequences(seqs, batch, dev))
    return frame_flags, lm_flags, new_outliers, perm


def flags_sequences(windows: Window, immature_valid, minimum_size: int, maximum_size: int,
                    maximum_marginalized_fraction: float, seqs=None):
    """:func:`flags_device` of the sequences ``seqs`` (a host list; None: all)
    of a stacked window and its stacked ``immature_valid`` [B, K, M] → its
    four outputs, each with a leading [S] axis.  Kernel K15p in one launch
    on CUDA tensors; the plain version once per sequence on CPU ones."""
    seqs = sequence_list(seqs, stack_size(windows))
    if windows.frame_valid.is_cuda:
        return _flags_sequences_cuda(windows, immature_valid, seqs, minimum_size,
                                     maximum_size, maximum_marginalized_fraction)
    outs = [flags_device_plain(window_at(windows, b), immature_valid[b], minimum_size,
                               maximum_size, maximum_marginalized_fraction) for b in seqs]
    return tuple(torch.stack(xs) for xs in zip(*outs))


def flags_device(window: Window, immature_valid, minimum_size: int, maximum_size: int,
                 maximum_marginalized_fraction: float):
    """``immature_valid`` [K, M] bool → (frame_flags [K] bool, landmark_flags
    [K, N] bool, new_outliers [K, N] bool, perm [K] long); ``perm`` is
    :func:`kept_first_perm` of the frame flags.  Kernel K15p on CUDA tensors,
    the plain version on CPU ones."""
    fn = flags_device_cuda if window.frame_valid.is_cuda else flags_device_plain
    return fn(window, immature_valid, minimum_size, maximum_size,
              maximum_marginalized_fraction)


def kept_first_perm(frame_valid, frame_flags):
    """Stable kept-frames-first slot permutation [K] long."""
    key = torch.where(frame_valid & ~frame_flags, 0, 1)
    return torch.argsort(key, stable=True)
