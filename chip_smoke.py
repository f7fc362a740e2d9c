#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dsopp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each with its time:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — compile the hand-written kernels of ``dsopp_tpu_torch/csrc``
   (into ``build/dsopp_tpu_torch``, ignored by git), one ``nvcc`` per source,
   all started together;
3. render — the bench's corridor sequence: 120 frames, 480×640, focal 520;
4. parity — each of the twenty kernel entry points (K1–K16, K15 as the
   policy K15p and the ledger fold; K14 has two; K18, the camera's
   photometric correction; and the row gather of the Pallas design probe)
   against its plain PyTorch version, f32
   on the card, at the shapes the main path gives it (inputs from a
   bootstrapped tracker), with its time, the plain version's time and the
   least time the card could take (bytes over 3.35 TB/s or f32 operations
   over 67 TFLOP/s, whichever is larger, counted from this run's inputs).
   The windowed-BA kernels are held twice: on a standart.yaml window (10
   frame slots × 250 landmarks; K6–K8 are timed there) and on a dense.yaml
   window (17 × 340, at least 12 valid frames; K9–K11 are timed there).  K4
   and K5 are held twice as well: on the standart bootstrap (10 banks × 800
   immature points; timed there) and on that dense window (17 × 1200).  The
   keyframe backend's kernels K12–K14 and K16 are held on both windows too,
   with the next frame pushed as the newest keyframe (timed at standart, the
   dense times on a line of their own), K12 with and without a CameraMask,
   and each runs there with host synchronisation an error.  K15p and K15 are
   held on both BA windows, with an empty and a filled ledger: the policy at
   the configuration's window sizes and with the window one frame too large
   (flags, outliers and the permutation equal; where the two best eq (20)
   scores tie within 1e-6, the frame flags may differ on those two slots
   only, and the rest must be the plain triage of the kernel's frame flags),
   the fold with no frame, one free frame, two
   frames, the fixed frame and a dead frame (no live landmark, no residual
   into it) flagged (H_m, b_m, E_m within 1e-9 of their largest entry, of
   the plain version's or, where an eigenvalue lies within 1e-6 of the
   pseudo-inverse's cutoff, of the plain version's with the cutoff at either
   edge of that band; the Jacobi solver converged; two runs equal to the
   bit), both with host synchronisation an error.  The row
   gather at the probe's shapes ([480·640, 12] table, 204800 indices) equal
   to ``table[idx]`` to the bit in f32 and bf16.  K18 equal to its plain
   version to the bit on u8 and f32 frames, with and without a vignette, at
   VGA and at 479×637;
5. track — the main path: a 6-frame known-pose bootstrap, then
   ``PipelinedTracker`` over frames 6..119 at the bench's standart.yaml
   operating point; every kernel of the path must have launched, ≥3
   keyframes and ≥1 marginalization must happen, and the per-frame
   translation error against ground truth after a similarity alignment (the
   monocular ATE of ``dsopp_tpu/output/ate.py``) must stay within the JAX
   package's end-to-end gates, RMSE < 2.2e-2 m and max < 3.5e-2 m, with the
   alignment's scale within 10 % of 1 (the known-pose bootstrap anchors
   it).  The error without alignment is printed beside it: monocular scale
   drifts by a few percent over the run, in the JAX package as in the port;
6. track-fast — the fast-motion path: the bench's fast corridor (96 frames,
   advance 0.13, texture seed 11) at the same operating point, frames 6..95;
   the perturbation re-track (105 pose hypotheses through the align chain)
   must fire at least once, ≥3 keyframes, aligned ATE RMSE < 3.0e-2 m with
   the scale within 10 % of 1.  Should no frame escalate by itself, one
   frame is escalated through the same entry point and the gate is held on
   that;
7. track-dense — the dense path: the corridor of phase 5 at the bench's
   dense.yaml operating point (17 frame slots × 340 landmarks, window 5..15,
   1200 immature points per keyframe), frames 6..119, with phase 5's gates;
8. track-masked — the masked-camera path: the first 66 frames of the corridor
   at the standart point with a static CameraMask whose rows 360..479 are
   invalid; phase 5's ATE and scale gates, and at the end no valid immature
   point and no valid landmark lies in the masked rows;
9. track-ledger — the long-horizon ledger path, the configuration of
   ``tests/tracker/test_ledger_drift_tracker.py`` (150 frames at 120×160,
   window 3..4 of 7 slots), rendered once in f64: the card's f32 run and the
   plain versions' f64 run on the CPU over the same frames, each with at least
   8 marginalized keyframes; the RMSE of the card's full-rate trajectory (the
   BA-refined keyframes with their attached frames, unaligned, as the JAX test
   reads it) below 0.35 m and below the f64 run's + 0.08 m (the f64 run's
   RMSE is printed: it moves with the host's CPU and BLAS);
10. sensor — the camera sensor path: the corridor of phase 3 written into a
   temporary folder as a camera's files (raw u8 ``.npy`` frames through a
   gamma response, a radial vignette and the oscillating exposure of the JAX
   exposure test; ``times.txt``, ``pcalib.txt``, a pinhole ``calib.txt``,
   class-id images with class 7 on rows ≥ 400, filtered), read through
   ``NpyFolderProvider`` → ``Camera`` (upload, K18) into the known-pose
   bootstrap and ``PipelinedTracker`` with the exposures and class ids: phase
   5's ATE and scale gates, K18 once per frame read, no point on the filtered
   rows, every marginalized landmark labelled with its keyframe's class; then
   the file read, the upload and K18 timed per frame;
11. undistort — the remap tables of a SimpleRadial VGA calibration built on
   the card in f64 within 1e-9 px of the CPU's, one frame remapped within
   1e-4 of the CPU's remap;
12. e2e, e2e-exposure — ``tests/tracker/test_monocular_e2e.py``'s two runs
   (240×320, 40 frames, 8-frame bootstrap) in f32 with that test's gates;
   each tick of the exposure run is also replayed from the card's state
   before it by the plain versions on the CPU (same keyframe decisions,
   poses within ``E2E_REPLAY_POSE_TOL``).

Each track line is preceded by one line with, per keyframe, the active
landmarks the activation counted, the points it activated and the spacing
``min_distance`` after it; it prints the largest ratio of chunk 0's rmse to
the last reliable one (the re-track gate's quantity), or "gate off" on a
path without the re-track.

On every path the windowed-BA solve, and the span from the marginalization
policy through the ledger fold, run under PyTorch's sync debug mode set to
"error": a host read inside them aborts the run.  K15p and K15 must launch
exactly once per keyframe.

Then a JSON line of per-kernel results, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without that
line; so does a machine without a CUDA card.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

BA_FRAMES = 14   # known-pose frames after the bootstrap, before the BA parity window
RMSE_GATE, MAX_GATE, SCALE_GATE, FAST_RMSE_GATE = 2.2e-2, 3.5e-2, 0.1, 3.0e-2
# published peaks of one H100 SXM: HBM bytes/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
# float64 outside the tensor cores (NVIDIA's H100 SXM data sheet): K15's arithmetic
PEAK_FLOPS_F64 = 34e12
# name -> (source, the JAX function it replaces); the order of the JSON line
SOURCES = {
    "pyramid_maps": ("dsopp_tpu_torch/csrc/pyramid.cu",
                     "dsopp_tpu/features/pyramid.py:50"),
    "align_residual_system": ("dsopp_tpu_torch/csrc/align.cu",
                              "dsopp_tpu/solvers/pose_alignment.py:88"),
    "align_level": ("dsopp_tpu_torch/csrc/align_level.cu",
                    "dsopp_tpu/solvers/pose_alignment.py:178"),
    "epipolar_sweep": ("dsopp_tpu_torch/csrc/epipolar.cu",
                       "dsopp_tpu/tracker/depth_estimation.py:107"),
    "flow_statistic": ("dsopp_tpu_torch/csrc/flow.cu", "dsopp_tpu/tracker/depth_map.py:134"),
    "ba_fej": ("dsopp_tpu_torch/csrc/ba_fej.cu", "dsopp_tpu/solvers/pba.py:257"),
    "ba_evaluate": ("dsopp_tpu_torch/csrc/ba_evaluate.cu", "dsopp_tpu/solvers/pba.py:315"),
    "ba_linearize_schur": ("dsopp_tpu_torch/csrc/ba_linearize.cu",
                           "dsopp_tpu/solvers/pba.py:431"),
    "ba_solve_step": ("dsopp_tpu_torch/csrc/ba_solve.cu", "dsopp_tpu/solvers/pba.py:552"),
    "ba_lm": ("dsopp_tpu_torch/csrc/ba_lm.cu", "dsopp_tpu/solvers/pba.py:647"),
    "ba_point_status": ("dsopp_tpu_torch/csrc/ba_status.cu", "dsopp_tpu/solvers/pba.py:845"),
    "select_candidates": ("dsopp_tpu_torch/csrc/candidates.cu",
                          "dsopp_tpu/features/extractor.py:77"),
    "activation": ("dsopp_tpu_torch/csrc/activation.cu", "dsopp_tpu/tracker/activation.py:71"),
    "refine_idepth": ("dsopp_tpu_torch/csrc/refine.cu", "dsopp_tpu/tracker/activation.py:153"),
    "activation_scatter": ("dsopp_tpu_torch/csrc/refine.cu",
                           "dsopp_tpu/tracker/activation.py:287"),
    "depth_maps": ("dsopp_tpu_torch/csrc/depth_maps.cu", "dsopp_tpu/tracker/depth_map.py:27"),
    "marg_policy": ("dsopp_tpu_torch/csrc/marg_policy.cu",
                    "dsopp_tpu/tracker/marginalization.py:33"),
    "marg_fold": ("dsopp_tpu_torch/csrc/marg_fold.cu", "dsopp_tpu/solvers/pba.py:941"),
    "row_gather": ("dsopp_tpu_torch/csrc/row_gather.cu", "scripts/gather_probe_pallas.py:66"),
    "photometric_correct": ("dsopp_tpu_torch/csrc/photometric.cu",
                            "dsopp_tpu/sensors/photometric.py:15"),
}
# K2's own entry point is held in the parity phase only: on the main path its
# body runs inside K3 (align_level); the row gather is the Pallas design
# probe's, on no path; K18 runs on the camera's frames, on the sensor path only
PATH_KERNELS = tuple(name for name in SOURCES if name not in ("align_residual_system",
                                                              "row_gather",
                                                              "photometric_correct"))
# the keyframe backend's kernels around the BA solve: once per keyframe each
KEYFRAME_KERNELS = ("select_candidates", "activation", "refine_idepth", "activation_scatter",
                    "depth_maps", "marg_policy", "marg_fold")
# ... and of those exactly once: the policy and the ledger fold
ONCE_PER_KEYFRAME = ("marg_policy", "marg_fold")
# the ledger path's gates (tests/tracker/test_ledger_drift_tracker.py)
LEDGER_MIN_FOLDS, LEDGER_RMSE_GATE, LEDGER_MARGIN = 8, 0.35, 0.08
LEDGER_CPU_THREADS = 8      # the f64 reference run's threads (a one-card machine's cores)
# f32 operations per unit of work, counted from the kernels' arithmetic
OPS_ALIGN_POINT = 230       # K2/K3: one valid point of one hypothesis, one pass
OPS_ALIGN_SOLVE = 600       # K3: damped 8x8 LU solve + exp + compose, one iteration
OPS_EPIPOLAR_POINT = 6500   # K4: 32 samples x 8 pattern points + 4 GN steps
OPS_FEJ_RESIDUAL = 150      # K6
OPS_EVALUATE_RESIDUAL = 120  # K7
OPS_LINEARIZE_RESIDUAL = 910  # K8: 16 Jacobian columns, 272 + 18 multiply-adds
OPS_FLOW_POINT = 80         # K5: two reprojections and ray differences
OPS_STATUS_GROUP = 12       # K11: 8 radix passes and the status walk, per group
OPS_CANDIDATE_PIXEL = 10    # K12: g2, its square root and bin, the threshold compare, the argmax
OPS_REPROJECT = 60          # K13, K16: one reprojection with its validity
OPS_ACTIVATION_PAIR = 6     # K13: dx, dy, two squares, their sum, the minimum
OPS_REFINE_POINT = 180      # K14: reprojection with d uv / d idepth, the sample, the sums
OPS_DEPTH_CELL = 12         # K16: pool, dilation and the selection's compares per grid cell
OPS_POLICY_LANDMARK = 8     # K15p: the live count and the triage of one landmark slot
OPS_POLICY_PAIR = 12        # K15p: one distance and reciprocal of the eq (20) sums
OPS_EIGEN = 9               # K15: x n^3 for a symmetric eigen-decomposition with vectors
OPS_PHOTOMETRIC_PIXEL = 10  # K18: clip, convert, frac, 1 - frac, two products, sum, floor, divide
# tests/tracker/test_monocular_e2e.py's gates: keyframes, active landmarks, the
# unaligned per-frame error of the plain run, trajectory entries, and the
# RMSE of the exposure-oscillation run
E2E_MIN_KEYFRAMES, E2E_MIN_ACTIVE, E2E_MIN_TRAJECTORY = 4, 150, 32
E2E_EXPOSURE_RMSE_GATE = 3.0e-2
# the exposure run's ticks replayed from the card's state by the plain
# versions on the CPU: the largest pose gap, m.  The port's f32 ticks from the
# JAX package's f32 state land up to 0.68 mm from JAX's on the CPU
# (tests/torch_e2e_reference.py); the card and the plain versions run the
# same algorithm in other summation orders
E2E_REPLAY_POSE_TOL = 1e-3
# [undistort]: the card's f64 remap tables against the CPU's, px; the remap, intensity
REMAP_TABLE_TOL, REMAP_TOL = 1e-9, 1e-4


class SmokeError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def no_host_reads(torch, fn, *args):
    """``fn(*args)`` with every host synchronisation an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def cuda_ms(fn, reps=50):
    """Mean time of ``fn`` per call between CUDA events
    (``dsopp_tpu_torch/testing/parity.py::cuda_ms``)."""
    from dsopp_tpu_torch.testing.parity import cuda_ms as timed
    return timed(fn, reps)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(num_bytes, num_ops, peak_flops=PEAK_FLOPS):
    """Least time of the work on the card → (ms, what bounds it)."""
    t_bytes, t_ops = num_bytes / PEAK_BYTES, num_ops / peak_flops
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sim3_aligned_errors(est, gt):
    """Per-frame errors after the least-squares similarity alignment of
    ``est`` onto ``gt`` (Horn/Umeyama, as dsopp_tpu/output/ate.py) and the
    alignment's scale."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    u, d, vt = np.linalg.svd((est - mu_e).T @ (gt - mu_g))
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    rot = vt.T @ s_mat @ u.T
    scale = np.trace(np.diag(d) @ s_mat) / ((est - mu_e) ** 2).sum()
    aligned = (scale * (rot @ (est - mu_e).T)).T + mu_g
    return np.linalg.norm(aligned - gt, axis=-1), float(scale)


def parity(seq, cfg, torch, card):
    """Each kernel against its plain version on main-path inputs."""
    from dsopp_tpu_torch.features import pyramid
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES, bootstrap

    tracker = bootstrap(seq, cfg)
    img = seq.images[INIT_FRAMES].contiguous()
    rows = {}

    # K1 — pyramid of one VGA frame, 5 levels
    maps_k = pyramid.build_pyramid_maps_cuda(img, 5)
    maps_p = pyramid.build_pyramid_maps_plain(img, 5)
    err1 = max(float((a - b).abs().max()) for a, b in zip(maps_k, maps_p))
    require(err1 <= 1e-3, f"K1 max abs diff {err1} > 1e-3")
    rows["pyramid_maps"] = dict(
        max_abs_err=err1, ms=cuda_ms(lambda: pyramid.build_pyramid_maps_cuda(img, 5)),
        plain_ms=cuda_ms(lambda: pyramid.build_pyramid_maps_plain(img, 5)),
        **bound(nbytes(img, *maps_k), 12 * sum(m[0].numel() for m in maps_k)),
        library_ms=None)
    log(f"  K1 pyramid_maps: 5 levels of {img.shape[0]}x{img.shape[1]}, max abs diff {err1:.3g}")

    parity_align(tracker, maps_k, torch, rows)
    parity_epipolar(seq, tracker, INIT_FRAMES, torch, rows, "standart")
    parity_flow(seq, tracker, INIT_FRAMES, torch, rows, "standart")
    # the BA kernels on a standart window (K6-K8 timed) ...
    parity_ba(seq, tracker, torch, rows, "standart", every=2, min_frames=5,
              timed=("ba_fej", "ba_evaluate", "ba_linearize_schur"))
    parity_keyframe(seq, tracker, INIT_FRAMES + BA_FRAMES, torch, rows, "standart")
    del tracker
    # ... and the dense operating point's shapes: K6-K11 on a dense window,
    # every further frame a keyframe (K9-K11 timed), then K4 on that window's
    # 17 banks of 1200 immature points and K5 on its flow set (both timed
    # above, at standart)
    from dsopp_tpu_torch.testing.paths import path_config
    tracker = bootstrap(seq, path_config("dense"))
    parity_ba(seq, tracker, torch, rows, "dense", every=1,
              min_frames=12, timed=("ba_solve_step", "ba_lm", "ba_point_status"))
    parity_epipolar(seq, tracker, INIT_FRAMES + BA_FRAMES, torch, rows, "dense")
    parity_flow(seq, tracker, INIT_FRAMES + BA_FRAMES, torch, rows, "dense")
    parity_keyframe(seq, tracker, INIT_FRAMES + BA_FRAMES, torch, rows, "dense")
    del tracker
    parity_gather(torch, rows)
    parity_photometric(torch, rows, card)
    for name, row in rows.items():
        log(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}) | {card}")
    return rows


def parity_align(tracker, maps, torch, rows):
    """K2 (the residual system) and K3 (the LM loop of one level)."""
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.solvers import pose_alignment as pa
    from dsopp_tpu_torch.testing import parity as par
    from dsopp_tpu_torch.tracker.fused_tick import CHUNK, _initialization_hypotheses

    # the hypotheses of the next frame as fused_tick builds them: chunk 0 is
    # the 5 base hypotheses, chunks 1..21 the 104 perturbations padded to 105
    kf = tracker._kf_pose()
    hyps = _initialization_hypotheses(tracker.t_w_last, tracker.t_prev_rel, kf, True)
    total = hyps.q.shape[0]
    pad = torch.cat([torch.arange(total, device="cuda"),
                     torch.zeros((-total) % CHUNK, dtype=torch.long, device="cuda")])
    nb = pad.shape[0]
    hyps = SE3(hyps.q[pad], hyps.t[pad])
    t_all = hyps.inverse().compose(SE3(kf.q.expand(nb, 4), kf.t.expand(nb, 3)))
    aff_all = tracker.last_affine.expand(nb, 2).contiguous()
    ratio = torch.tensor(1.0, device="cuda")
    opts = tracker.align_opts
    lp, models = tracker.level_points, tracker.models

    def level_args(level, t, aff):
        return (lp[level], maps[level], models[level],
                SE3(t.q.contiguous(), t.t.contiguous()), aff.contiguous(),
                tracker.last_affine, ratio)

    # K2 — the 5 base hypotheses against every level's frontend points
    t5 = SE3(t_all.q[:CHUNK], t_all.t[:CHUNK])
    aff5 = aff_all[:CHUNK]
    err2 = 0.0
    for lvl in range(5):
        args = level_args(lvl, t5, aff5) + (opts.huber_sigma,)
        hk, bk, ek, nk = pa.residual_system_cuda(*args)
        hp, bp, ep, np_ = pa.residual_system_plain(*args)
        require(torch.equal(nk, np_), f"K2 level {lvl}: num_valid {nk.tolist()} vs {np_.tolist()}")
        rel_h = float(((hk - hp).norm(dim=(1, 2)) / hp.norm(dim=(1, 2)).clamp(min=1e-30)).max())
        rel_b = float(((bk - bp).norm(dim=1) / bp.norm(dim=1).clamp(min=1e-30)).max())
        rel_e = float(((ek - ep).abs() / ep.abs().clamp(min=1e-30)).max())
        require(rel_h <= 1e-4 and rel_b <= 1e-4 and rel_e <= 1e-5,
                f"K2 level {lvl}: rel H {rel_h:.3g} b {rel_b:.3g} energy {rel_e:.3g}")
        err2 = max(err2, float((hk - hp).abs().max()))
        log(f"  K2 level {lvl}: {int(nk.max())} valid of {lp[lvl].uv.shape[0]},"
            f" rel H {rel_h:.2e} b {rel_b:.2e} energy {rel_e:.2e}")
    args0 = level_args(0, t5, aff5) + (opts.huber_sigma,)
    _, _, _, nv0 = pa.residual_system_cuda(*args0)
    sampled = min(nbytes(maps[0]), 48 * int(nv0.max()))
    rows["align_residual_system"] = dict(
        max_abs_err=err2, ms=cuda_ms(lambda: pa.residual_system_cuda(*args0)),
        plain_ms=cuda_ms(lambda: pa.residual_system_plain(*args0)),
        **bound(nbytes(*lp[0]) + sampled + CHUNK * 74 * 4, OPS_ALIGN_POINT * int(nv0.sum())),
        library_ms=None)

    # K3 — the base chunk down the levels (both versions start each level from
    # the plain version's result), then level 0 for the coarse winner
    def check_k3(label, res_k, res_p):
        err = par.align_level_errors(res_k, res_p)
        for name in ("rotation", "translation", "affine"):
            err[name] = float(err[name].max())
        log(f"  K3 {label}: iterations kernel {iter_summary(res_k)} plain {iter_summary(res_p)},"
            f" valid {int(res_p.num_valid.min())}..{int(res_p.num_valid.max())},"
            f" d(num_valid) {err['num_valid']:.2e} d(energy) {err['energy']:.2e}"
            f" d(rmse) {err['rmse']:.2e} rot {err['rotation']:.2e} rad"
            f" trans {err['translation']:.2e} m affine {err['affine']:.2e}")
        require(err["num_valid"] <= 5e-3, f"K3 {label}: num_valid differs by {err['num_valid']}")
        require(err["energy"] <= 1e-3 and err["rmse"] <= 1e-3,
                f"K3 {label}: energy {err['energy']:.3g} rmse {err['rmse']:.3g} relative")
        require(err["rotation"] <= 1e-4 and err["translation"] <= 1e-4,
                f"K3 {label}: rotation {err['rotation']:.3g} rad translation"
                f" {err['translation']:.3g} m")
        return max(err["translation"], err["rotation"], err["affine"])

    def coarse_winner(res):
        nv = res.num_valid
        floor = torch.clamp(nv.max() // 2, min=1)
        score = torch.where(nv >= floor, res.energy / torch.clamp(nv, min=1),
                            torch.full_like(res.energy, float("inf")))
        return int(torch.argmin(score))

    err3, t, aff, timed = 0.0, t5, aff5, None
    for lvl in range(4, 0, -1):
        args = level_args(lvl, t, aff) + (opts,)
        res_k, res_p = pa.align_level_cuda(*args), pa.align_level_plain(*args)
        err3 = max(err3, check_k3(f"level {lvl}, 5 hypotheses", res_k, res_p))
        if lvl == 1:
            timed = (args, res_k)
            wk, wp = coarse_winner(res_k), coarse_winner(res_p)
            require(wk == wp, f"K3: coarse winner {wk} (kernel) vs {wp} (plain)")
        t, aff = res_p.t_t_r, res_p.affine
    args = level_args(0, SE3(t.q[wp:wp + 1], t.t[wp:wp + 1]), aff[wp:wp + 1]) + (opts,)
    args_l0 = args
    err3 = max(err3, check_k3(f"level 0, winner {wp}", pa.align_level_cuda(*args),
                              pa.align_level_plain(*args)))

    # ... and the 105 escalation hypotheses at level 1 (levels 4..2 by the kernel)
    t, aff = SE3(t_all.q[CHUNK:], t_all.t[CHUNK:]), aff_all[CHUNK:]
    for lvl in range(4, 1, -1):
        res = pa.align_level_cuda(*level_args(lvl, t, aff), opts)
        t, aff = res.t_t_r, res.affine
    args105 = level_args(1, t, aff) + (opts,)
    res_k, res_p = pa.align_level_cuda(*args105), pa.align_level_plain(*args105)
    err3 = max(err3, check_k3(f"level 1, {nb - CHUNK} hypotheses", res_k, res_p))

    args1, res1 = timed
    iters, nv = res1.iterations.double(), res1.num_valid.double()
    ops = float(((iters + 1) * nv).sum()) * OPS_ALIGN_POINT + float(iters.sum()) * OPS_ALIGN_SOLVE
    sampled = min(nbytes(maps[1]), 48 * int(nv.max()))
    rows["align_level"] = dict(
        max_abs_err=err3, ms=cuda_ms(lambda: pa.align_level_cuda(*args1)),
        plain_ms=cuda_ms(lambda: pa.align_level_plain(*args1), reps=5),
        **bound(nbytes(*lp[1]) + sampled + CHUNK * 13 * 4, ops), library_ms=None)
    log(f"  K3 level 0, 1 hypothesis: kernel {cuda_ms(lambda: pa.align_level_cuda(*args_l0)):.4f} ms,"
        f" plain {cuda_ms(lambda: pa.align_level_plain(*args_l0), reps=5):.4f} ms;"
        f" level 1, {nb - CHUNK} hypotheses: kernel"
        f" {cuda_ms(lambda: pa.align_level_cuda(*args105)):.4f} ms,"
        f" plain {cuda_ms(lambda: pa.align_level_plain(*args105), reps=3):.4f} ms")


def iter_summary(res):
    it = res.iterations
    if it.numel() <= 5:
        return str(it.tolist())
    return f"{int(it.min())}..{int(it.max())} (mean {float(it.double().mean()):.1f})"


def parity_epipolar(seq, tracker, frame, torch, rows, label):
    """K4 — every bank of ``tracker`` against frame ``frame`` (the next one)
    at its ground-truth pose.  The kernel's row of ``rows`` is the standart
    one."""
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.features import pyramid
    from dsopp_tpu_torch.tracker import depth_estimation as de

    maps = pyramid.build_pyramid_maps_cuda(seq.images[frame].contiguous(), 1)
    pose = seq.pose(frame, torch.float32, "cuda")
    win = tracker.window
    k = win.num_slots
    t_inv = pose.inverse()
    t_rel = SE3(t_inv.q.expand(k, 4), t_inv.t.expand(k, 3)).compose(win.poses())
    ratios = torch.ones(k, device="cuda")
    inp, geo = de.sweep_inputs(tracker.immature, tracker.models[0], t_rel.q, t_rel.t,
                               win.affine(), tracker.last_affine, ratios)
    image = maps[0][0]
    res_k = de.epipolar_sweep_cuda(inp, image, tracker.models[0], 20.0)
    res_p = de.epipolar_sweep_plain(inp, image, tracker.models[0], 20.0)
    act = inp.active
    n_act = int(act.sum())
    require(n_act > 0, "K4: no active immature points")
    same_best = float((res_k.best_idx == res_p.best_idx)[act].float().mean())
    up_k = de.update_from_sweep(tracker.immature, geo, res_k, tracker.models[0])
    up_p = de.update_from_sweep(tracker.immature, geo, res_p, tracker.models[0])
    act2 = act.reshape(up_k.status.shape)
    agree = (up_k.status == up_p.status) & act2
    same_status = float(agree.sum()) / n_act
    # the plain sweep once more in f64 on the same inputs, its result through
    # the same f32 update: what of a kernel-to-plain difference is f32 rounding
    inp64 = de.SweepInputs(*(x.double() if x.is_floating_point() else x for x in inp))
    res64 = de.epipolar_sweep_plain(inp64, image.double(), tracker.models[0], 20.0)
    up_64 = de.update_from_sweep(tracker.immature, geo, de.SweepResult(
        *(x.float() if x.is_floating_point() else x for x in res64)), tracker.models[0])
    agree64 = (agree & (up_64.status == up_p.status)
               & (res64.best_idx == res_p.best_idx).reshape(agree.shape))
    # idepth bounds where the statuses agree: each within 1e-4 of its own
    # magnitude or, where that is larger, of the interval's width.  Both
    # bounds move together with the GN offset along the epipolar line, by a
    # share of the width; a wide interval's lower bound sits near zero, where
    # its own magnitude is no scale for that shift
    width = (up_p.idepth_max - up_p.idepth_min).abs()
    err4, rel_k64, rel_p64 = 0.0, 0.0, 0.0
    rel = torch.zeros_like(width)
    for name in ("idepth_min", "idepth_max"):
        val_k, val_p, val_64 = getattr(up_k, name), getattr(up_p, name), getattr(up_64, name)
        scale = torch.maximum(val_p.abs(), width).clamp(min=1e-6)
        diff = torch.where(agree, (val_k - val_p).abs(), torch.zeros_like(val_p))
        err4 = max(err4, float(diff.max()))
        rel = torch.maximum(rel, diff / scale)
        rel_k64 = max(rel_k64, float(((val_k - val_64).abs() / scale)[agree64].max()))
        rel_p64 = max(rel_p64, float(((val_p - val_64).abs() / scale)[agree64].max()))
    rel4, worst = float(rel.max()), int(torch.argmax(rel))
    log(f"  K4 ({label}) worst point {worst}, as kernel / plain / plain in f64: " + "; ".join(
        f"{name} " + " / ".join(f"{float(x.flatten()[worst]):.7e}" for x in triple)
        for name, triple in (
            ("idepth_min", (up_k.idepth_min, up_p.idepth_min, up_64.idepth_min)),
            ("idepth_max", (up_k.idepth_max, up_p.idepth_max, up_64.idepth_max)),
            ("GN offset, px", (res_k.best_delta, res_p.best_delta, res64.best_delta)))))
    log(f"  K4 epipolar_sweep ({label}): {k} banks x {tracker.immature.uv.shape[1]} immature"
        f" points, {n_act} active; best sample equal on {same_best:.5f}"
        f" ({int((res_k.best_idx != res_p.best_idx)[act].sum())} differ), status equal on"
        f" {same_status:.5f} ({n_act - int(agree.sum())} differ), idepth rel {rel4:.2e}"
        f" abs {err4:.2e}; against the f64 sweep on {int(agree64.sum())} points: kernel"
        f" {rel_k64:.2e}, plain f32 {rel_p64:.2e}")
    require(same_best >= 0.999, f"K4 ({label}) best sample agreement {same_best}")
    require(same_status >= 0.995, f"K4 ({label}) status agreement {same_status}")
    if label == "standart":
        # the refinement keeps the Gauss-Newton iterate of least energy: where two
        # iterates' energies are equal to rounding, the kernel and the plain version
        # may keep different ones, a last step apart.  Such a point is passed when
        # the two kept energies agree to 1e-5 of themselves plus 1e-3 (the sum of 8
        # squared differences of intensities up to 255, whose f32 spacing is
        # 1.5e-5, carries about 1e-4 of absolute noise at |r| ~ 1), on at most
        # 0.1 % of the points
        over = agree & (rel > 1e-4)
        e_k, e_p = (r.refined_energy.reshape(rel.shape) for r in (res_k, res_p))
        tie = (e_k - e_p).abs() <= 1e-5 * e_p.abs() + 1e-3
        n_over = int(over.sum())
        if n_over:
            log(f"  K4 ({label}): {n_over} points beyond 1e-4 (worst {rel4:.2e}); kept energies at"
                f" the worst: kernel {float(e_k.flatten()[worst]):.7e}, plain"
                f" {float(e_p.flatten()[worst]):.7e}")
        require(int((over & ~tie).sum()) == 0 and n_over <= 1e-3 * n_act,
                f"K4 ({label}) idepth rel diff {rel4} on {n_over} points, not all of them ties"
                " between two iterates of equal energy")
    else:
        # nine times the points: a low-parallax point's bound may sit further
        # than 1e-4 from the plain f32 version's while both are equally far
        # from the f64 sweep's.  Such a point must agree with the f64 sweep as
        # the plain f32 version does (its distance from it at most twice the
        # plain version's), and at most 0.1 % of the points may be such
        over = agree64 & (rel > 1e-4)
        dist_k = torch.zeros_like(rel)
        dist_p = torch.zeros_like(rel)
        for name in ("idepth_min", "idepth_max"):
            val_64 = getattr(up_64, name)
            dist_k = torch.maximum(dist_k, (getattr(up_k, name) - val_64).abs())
            dist_p = torch.maximum(dist_p, (getattr(up_p, name) - val_64).abs())
        n_over = int(over.sum())
        worst_ratio = float((dist_k / dist_p.clamp(min=1e-30))[over].max()) if n_over else 0.0
        log(f"  K4 ({label}): {n_over} points beyond 1e-4 of the plain f32 bounds; their distance"
            f" from the f64 sweep is at most {worst_ratio:.3f} x the plain f32 version's")
        require(int(((rel > 1e-4) & ~agree64).sum()) == 0,
                f"K4 ({label}) idepth rel diff {rel4} where the f64 sweep picks another sample")
        require(n_over <= 1e-3 * n_act and worst_ratio <= 2.0,
                f"K4 ({label}) {n_over} points beyond 1e-4, up to {worst_ratio:.3f} x as far from"
                " the f64 sweep as the plain f32 version")
    sampled = min(nbytes(image), n_act * 32 * 8 * 16)
    row = dict(
        max_abs_err=err4,
        ms=cuda_ms(lambda: de.epipolar_sweep_cuda(inp, image, tracker.models[0], 20.0)),
        plain_ms=cuda_ms(lambda: de.epipolar_sweep_plain(inp, image, tracker.models[0], 20.0)),
        **bound(nbytes(*inp) + sampled + nbytes(*res_k), OPS_EPIPOLAR_POINT * n_act),
        library_ms=None)
    if label == "standart":
        rows["epipolar_sweep"] = row
    else:
        log(f"  K4 epipolar_sweep ({label}): kernel {row['ms']:.4f} ms, plain"
            f" {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']})")


def parity_flow(seq, tracker, frame, torch, rows, label):
    """K5 — the flow set of ``tracker`` at the pose of frame ``frame`` (the
    next one).  The kernel's row of ``rows`` is the standart one."""
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.testing import parity as par
    from dsopp_tpu_torch.tracker import depth_map as dm

    t_t_kf = seq.pose(frame, torch.float32, "cuda").inverse() @ tracker._kf_pose()
    args = (tracker.flow_points, tracker.models[0],
            SE3(t_t_kf.q.contiguous(), t_t_kf.t.contiguous()))
    out_k, out_p = dm.mean_square_flows_cuda(*args), dm.mean_square_flows_plain(*args)
    pts = tracker.flow_points
    n_valid = int((pts.valid & (pts.idepth > 1e-6)).sum())
    err = [par.rel_max(a, b) for a, b in zip(out_k, out_p)]
    log(f"  K5 flow_statistic ({label}): {n_valid} valid of {pts.uv.shape[0]} points, flow"
        f" {float(out_p[0]):.6f} / {float(out_p[1]):.6f} (without rotation), rel diff"
        f" {err[0]:.2e} / {err[1]:.2e}")
    require(n_valid > 100 and float(out_p[0]) > 0 and float(out_p[1]) > 0,
            f"K5 ({label}): the flow set is empty or does not move")
    require(max(err) <= 1e-5, f"K5 ({label}): relative error {max(err):.3g} above 1e-5")
    if label != "standart":
        return
    rows["flow_statistic"] = dict(
        max_abs_err=max(float((a - b).abs()) for a, b in zip(out_k, out_p)),
        ms=cuda_ms(lambda: dm.mean_square_flows_cuda(*args)),
        plain_ms=cuda_ms(lambda: dm.mean_square_flows_plain(*args)),
        **bound(nbytes(pts.uv, pts.idepth, pts.valid) + 36, OPS_FLOW_POINT * n_valid),
        library_ms=None)


def parity_keyframe(seq, tracker, frame, torch, rows, label):
    """K12–K14 and K16 on the window of ``tracker`` with frame ``frame`` (the
    next one) pushed as its newest keyframe at its ground-truth pose, each
    wrapper with host synchronisation an error.  The kernels' rows of ``rows``
    are the standart ones; the dense times are printed."""
    from dsopp_tpu_torch.features import extractor
    from dsopp_tpu_torch.testing import parity as par
    from dsopp_tpu_torch.testing.paths import path_mask
    from dsopp_tpu_torch.tracker import activation as act
    from dsopp_tpu_torch.tracker import depth_map as dm

    def row(name, **fields):
        fields["library_ms"] = fields.get("library_ms")
        if label == "standart":
            rows[name] = fields
        else:
            log(f"  {name} ({label}): kernel {fields['ms']:.4f} ms, plain {fields['plain_ms']:.4f}"
                f" ms, bound {fields['bound_ms']:.5f} ms ({fields['bound_by']})")

    cfg, model = tracker.config, tracker.models[0]
    win, imm, maps = par.keyframe_case(tracker, seq.images[frame],
                                       seq.pose(frame, torch.float32, "cuda"), frame)
    k, n, m = win.num_slots, win.num_landmark_slots, cfg.immature_per_frame
    h, w = tracker.image_shape

    # K12 — the new keyframe's candidates, without and with the masked path's mask
    err12 = 0.0
    for mask in (None, path_mask("masked")):
        out_k = no_host_reads(torch, extractor.select_candidates_cuda, maps[0], m, mask)
        out_p = extractor.select_candidates_plain(maps[0], m, mask)
        err = par.candidates_errors(out_k, out_p)
        log(f"  K12 select_candidates ({label}, {m} slots, mask {mask is not None}): {err}")
        require(err["valid"] > m // 4, f"K12 ({label}): only {err['valid']} valid candidates")
        require(err["uv_differ"] == 0 and err["valid_differ"] == 0 and err["grad2"] == 0.0,
                f"K12 ({label}): slots differ from the plain version: {err}")
        err12 = max(err12, err["grad2"])
    mask = path_mask("masked")
    row("select_candidates", max_abs_err=err12,
        ms=cuda_ms(lambda: extractor.select_candidates_cuda(maps[0], m, mask)),
        plain_ms=cuda_ms(lambda: extractor.select_candidates_plain(maps[0], m, mask)),
        **bound(2 * nbytes(maps[0]) // 3 + nbytes(mask) + nbytes(*out_k),
                OPS_CANDIDATE_PIXEL * h * w))

    # K13 — at the spacing the tracker stands at and at the controller's start
    # (3 px), a device scalar
    terms = act._activation_terms_plain(win, model, imm)
    walkers = int((terms[0] & terms[1]).sum())
    for spacing in (3.0, tracker.min_distance):
        min_distance = torch.tensor(spacing, device="cuda")
        res_k = no_host_reads(torch, act._activation_cuda, win, model, imm, min_distance)
        res_p = act._activation_plain(win, model, imm, min_distance)
        err = par.activation_errors(res_k, res_p, terms, min_distance, model)
        log(f"  K13 activation ({label}): {k} x {n} landmarks, {k} x {m} candidates, {walkers}"
            f" ready and valid, min_distance {spacing:.3f}: {err}")
        require(err["n_active"] > 100 and err["activate"] > 20,
                f"K13 ({label}): too little to compare: {err}")
        require(err["n_active_differ"] == 0, f"K13 ({label}): n_active differs: {err}")
        require(err["agree"] >= 0.999 and err["unexplained"] == 0,
                f"K13 ({label}): masks differ beyond rounding ties: {err}")
    imm_in = (imm.uv, imm.idepth_min, imm.idepth_max, imm.status, imm.traced, imm.uniqueness,
              imm.search_interval, imm.valid)
    lib = None
    if label == "standart":
        cand = terms[4].reshape(-1, 2).contiguous()
        lm = torch.rand((err["n_active"], 2), device="cuda") * 600.0
        lib = cuda_ms(lambda: torch.cdist(cand, lm).min(dim=1))
        log(f"  K13 yardstick ({label}): torch.cdist + min over {cand.shape[0]} x {lm.shape[0]}"
            f" points {lib:.4f} ms (the distance part only)")
    row("activation", max_abs_err=float(err["differ"]),
        ms=cuda_ms(lambda: act._activation_cuda(win, model, imm, min_distance)),
        plain_ms=cuda_ms(lambda: act._activation_plain(win, model, imm, min_distance),
                         reps=5),
        **bound(nbytes(win.lm_uv, win.lm_idepth, win.lm_valid, *imm_in) + nbytes(*res_k[:2]),
                OPS_ACTIVATION_PAIR * walkers * err["n_active"] + OPS_REPROJECT * k * (n + m)),
        library_ms=lib)

    # K14 — the refinement of what the plain version activates ...
    activate, delete = res_p[0], res_p[1]
    trace_k, trace_p = [], []
    ref_k = no_host_reads(torch, act._refine_idepth_cuda, win, model, imm, activate, cfg.huber_sigma,
                          act.REFINE_CAP, trace_k)
    ref_p = act._refine_idepth_plain(win, model, imm, activate, cfg.huber_sigma,
                                     act.REFINE_CAP, trace_p)
    err = par.refine_errors(ref_k, ref_p, trace_k[0], trace_p[0])
    log(f"  K14 refine_idepth ({label}): {int(activate.sum())} activating, {err}")
    require(err["selected_differ"] == 0 and err["selected"] > 20,
            f"K14 ({label}): the refined set differs or is too small: {err}")
    require(err["kept_outside_selected"] == 0, f"K14 ({label}): kept outside the cap: {err}")
    require(err["keep_agree"] >= 0.995, f"K14 ({label}): keep agrees on {err['keep_agree']:.4f}")
    require(err["idepth"] <= 1e-4, f"K14 ({label}): idepth differs by {err['idepth']:.3g}")
    require(err["parted_others"] <= 0.005 * err["selected"],
            f"K14 ({label}): accept sequences part beyond rounding ties: {err}")
    frames = int(win.frame_valid.sum())
    points = err["selected"] * (frames - 1) * 8 * 4
    sampled = min(nbytes(win.maps) // 3, 48 * points)
    row("refine_idepth", max_abs_err=err["idepth_abs"],
        ms=cuda_ms(lambda: act._refine_idepth_cuda(win, model, imm, activate,
                                                          cfg.huber_sigma)),
        plain_ms=cuda_ms(lambda: act._refine_idepth_plain(win, model, imm, activate,
                                                                 cfg.huber_sigma), reps=5),
        **bound(nbytes(activate) + err["selected"] * 48 + sampled + 3 * nbytes(activate)
                + nbytes(ref_k[0]), OPS_REFINE_POINT * points))

    # ... and the pairing with free landmark slots, on the plain refinement
    idepth, keep, selected = ref_p
    delete = delete | (selected & ~keep)
    imm2 = imm._replace(idepth_min=torch.where(keep, idepth, imm.idepth_min),
                        idepth_max=torch.where(keep, idepth, imm.idepth_max))
    sc_k = no_host_reads(torch, act._activation_scatter_cuda, win, imm2, keep, delete)
    sc_p = act._activation_scatter_plain(win, imm2, keep, delete)
    err = par.scatter_errors(sc_k, sc_p)
    log(f"  K14 activation_scatter ({label}): {err}")
    require(err.pop("n_activated") > 20, f"K14 ({label}): hardly a point was paired")
    require(not any(err.values()), f"K14 ({label}): the pairing differs: {err}")
    moved = (win.lm_uv, win.lm_patch, win.lm_idepth, win.lm_valid, win.res_status)
    row("activation_scatter", max_abs_err=0.0,
        ms=cuda_ms(lambda: act._activation_scatter_cuda(win, imm2, keep, delete)),
        plain_ms=cuda_ms(lambda: act._activation_scatter_plain(win, imm2, keep, delete)),
        **bound(2 * nbytes(*moved) + nbytes(keep, delete, imm2.valid, imm2.valid)
                + int(sc_p[2]) * 48, 4 * k * (n + m)))

    # K16 — the frontend's state from the window after the pairing; landmarks
    # whose reprojection sits within 1e-3 px of a pixel boundary or of the image
    # border are left out of both versions: there the last bit of the
    # reprojection (the two round differently) decides the pixel
    win2 = sc_p[0]
    boundary = par.pixel_boundary_landmarks(win2, model)
    win2 = win2.replace(lm_valid=win2.lm_valid & ~boundary)
    args = (win2, model, tuple(maps), h, w, cfg.pyramid_levels, cfg.frontend_points)
    out_k = no_host_reads(torch, dm.build_frontend_state_cuda, *args)
    out_p = dm.build_frontend_state_plain(*args)
    err = par.frontend_errors(out_k, out_p)
    log(f"  K16 depth_maps ({label}): {int(boundary.sum())} landmarks on a pixel boundary left"
        f" out, {err}")
    require(err["positive"][0] > 1000, f"K16 ({label}): {err['positive'][0]} pixels hold weight")
    require(err["weight_differ"] == 0 and err["uv_differ"] == 0 and err["valid_differ"] == 0,
            f"K16 ({label}): weights or selected pixels differ: {err}")
    require(err["idepth_map"] <= 1e-6 and err["idepth"] <= 1e-6 and err["intensity"] == 0.0,
            f"K16 ({label}): idepth differs by {max(err['idepth_map'], err['idepth']):.3g}")
    again = dm.build_frontend_state_cuda(*args)
    require(all(torch.equal(a, b) for a, b in zip(out_k[0], again[0])),
            f"K16 ({label}): two runs on the same window differ")
    cells = sum(x.numel() for x in out_k[0])
    lib = None
    if label == "standart":
        flat = out_p[1][0].reshape(-1)
        lib = cuda_ms(lambda: torch.topk(flat, dm.FLOW_CAP))
        log(f"  K16 yardstick ({label}): torch.topk of {dm.FLOW_CAP} over level 0's"
            f" {flat.numel()} weights {lib:.4f} ms (one selection of six, no tie order)")
    row("depth_maps", max_abs_err=float(max((a - b).abs().max()
                                            for a, b in zip(out_k[0], out_p[0]))),
        ms=cuda_ms(lambda: dm.build_frontend_state_cuda(*args)),
        plain_ms=cuda_ms(lambda: dm.build_frontend_state_plain(*args), reps=10),
        **bound(nbytes(win2.lm_uv, win2.lm_idepth, win2.lm_valid) + nbytes(*out_k[0], *out_k[1])
                + sum(nbytes(*pts) + 4 * pts.uv.shape[0] for pts in (*out_k[2], out_k[3])),
                OPS_REPROJECT * k * n + OPS_DEPTH_CELL * cells),
        library_ms=lib)


def parity_ba(seq, tracker, torch, rows, label, every, min_frames, timed):
    """K6–K11 on the window of ``tracker`` after ``BA_FRAMES`` further
    known-pose frames (every ``every``-th one a keyframe), moved off its
    linearization point.
    The kernels named in ``timed`` get their row of ``rows`` here."""
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing import parity as par
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES

    for i in range(INIT_FRAMES, INIT_FRAMES + BA_FRAMES):
        tracker.tick(i, float(seq.timestamps[i]), seq.images[i],
                     known_pose=seq.pose(i, torch.float32), force_keyframe=(i % every == every - 1))
    win, model, opts = tracker.window, tracker.models[0], tracker.pba_opts
    k, n = win.num_slots, win.num_landmark_slots
    kb = 8 * k
    residuals = k * k * n * 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = torch.tensor([1e-3] * 6 + [5e-3, 0.3], device="cuda")
    eps = torch.randn((k, 8), generator=gen, device="cuda") * step
    eps = torch.where((win.frame_valid & ~win.frame_fixed)[:, None], eps,
                      torch.zeros_like(eps)).contiguous()
    idepth = (win.lm_idepth
              * (1.0 + 0.01 * torch.randn((k, n), generator=gen, device="cuda"))).contiguous()
    lm_mask = pba.active_lm_mask(win)
    live = pba._pair_mask(win)[:, :, None] & lm_mask[:, None, :]
    frames = int(win.frame_valid.sum())
    log(f"  BA window ({label}): {frames} of {k} frames, {int(lm_mask.sum())} of {k * n}"
        f" landmarks, {int(live.sum())} live (anchor, target, landmark) groups of"
        f" {k * k * n}, ledger max |H_m| {float(win.h_marg.abs().max()):.3g}")
    require(frames >= min_frames, f"the {label} parity window holds fewer than {min_frames} frames")

    def row(name, **fields):
        rows[name] = dict(library_ms=None, **fields)

    # K6
    fej_k, fej_p = pba._fej_cache_cuda(win, model), pba._fej_cache_plain(win, model)
    err = par.fej_errors(fej_k, fej_p)
    log(f"  K6 ba_fej ({label}): {err}")
    require(err.pop("geom_valid_differ") == 0, f"K6 ({label}): geom_valid differs")
    require(max(err.values()) <= 1e-5, f"K6 ({label}): relative error above 1e-5: {err}")
    win_in = (win.t_lin_q, win.t_lin_t, win.affine0, win.exposure, win.lm_uv, win.lm_idepth,
              win.lm_patch)
    if "ba_fej" in timed:
        row("ba_fej",
            max_abs_err=max(float((a - b).abs().max()) for a, b in zip(fej_k[:5], fej_p[:5])),
            ms=cuda_ms(lambda: pba._fej_cache_cuda(win, model)),
            plain_ms=cuda_ms(lambda: pba._fej_cache_plain(win, model)),
            **bound(nbytes(*win_in) + nbytes(*fej_k), OPS_FEJ_RESIDUAL * residuals))

    # K7
    ev_args = (win, model, eps, idepth, lm_mask, opts)
    ev_k, ev_p = pba._evaluate_cuda(*ev_args), pba._evaluate_plain(*ev_args)
    err = par.evaluation_errors(ev_k, ev_p, live)
    log(f"  K7 ba_evaluate ({label}): {err}")
    require(err["ok"] > 1000, f"K7 ({label}): only {err['ok']} ok groups")
    require(err["agree"] >= 0.999,
            f"K7 ({label}): ok/status agree on {err['agree']:.5f} of live groups")
    worst = max(err[name] for name in ("residuals", "gx", "gy", "energy_patch", "weight"))
    require(worst <= 1e-4, f"K7 ({label}): relative error {worst:.3g} above 1e-4")
    if "ba_evaluate" in timed:
        both = (ev_k.ok & ev_p.ok)[..., None]
        # only a live group's 8 residuals need a sample of the target's image
        sampled = min(nbytes(win.maps) // 3, 48 * 8 * int(live.sum()))
        row("ba_evaluate",
            max_abs_err=float(torch.where(both, ev_k.residuals - ev_p.residuals,
                                          torch.zeros_like(ev_p.residuals)).abs().max()),
            ms=cuda_ms(lambda: pba._evaluate_cuda(*ev_args)),
            plain_ms=cuda_ms(lambda: pba._evaluate_plain(*ev_args)),
            **bound(nbytes(*win_in, eps, idepth, lm_mask, win.frame_valid, win.res_status)
                    + sampled + nbytes(*ev_k), OPS_EVALUATE_RESIDUAL * 8 * int(live.sum())))

    # K8, on the plain versions' cache and evaluation; also the marginalization pass
    err8 = 0.0
    for marg_pass in (False, True):
        sys_k = pba._linearize_from_ev_cuda(win, fej_p, ev_p, eps, opts, marg_pass)
        sys_p = pba._linearize_from_ev_plain(win, fej_p, ev_p, eps, opts, marg_pass)
        err = par.linear_system_errors(sys_k, sys_p)
        log(f"  K8 ba_linearize_schur ({label}) marg_pass={marg_pass}: {err}")
        require(float(sys_p.h_schur.abs().max()) > 0, f"K8 ({label}): empty Schur complement")
        require(max(err.values()) <= 1e-4, f"K8 ({label}): relative error above 1e-4: {err}")
        err8 = max(err8, float((sys_k.h_pose - sys_p.h_pose).abs().max()))
    tiles, lm_blocks = -(-n // 64), -(-(k * n) // 32)
    log(f"  K8 scratch ({label}): pair_part {k * k * tiles * 272 * 8 / 1e6:.2f} MB, lm_part"
        f" {k * k * n * 18 * 4 / 1e6:.2f} MB, schur_part {lm_blocks} x {kb * kb + kb} f64 ="
        f" {lm_blocks * (kb * kb + kb) * 8 / 1e6:.2f} MB")
    if "ba_linearize_schur" in timed:
        row("ba_linearize_schur", max_abs_err=err8,
            ms=cuda_ms(lambda: pba._linearize_from_ev_cuda(win, fej_p, ev_p, eps, opts)),
            plain_ms=cuda_ms(lambda: pba._linearize_from_ev_plain(win, fej_p, ev_p, eps, opts)),
            **bound(nbytes(*fej_p, ev_p.residuals, ev_p.weight, ev_p.gx, ev_p.gy, ev_p.ok, eps,
                           win.affine0, win.frame_valid, win.frame_fixed, win.frame_marg)
                    + nbytes(*sys_k),
                    OPS_LINEARIZE_RESIDUAL * 8 * int(ev_p.ok.sum())
                    + 3 * int(lm_mask.sum()) * (kb * kb + kb)))
    sys_p = par.contiguous(pba._linearize_from_ev_plain(win, fej_p, ev_p, eps, opts))

    # a filled ledger: the window's own where a frame was marginalized, else a
    # tenth of its own reduced system
    moved = win.replace(eps=eps, lm_idepth=idepth)
    filled = moved if float(win.h_marg.abs().max()) > 0 else par.scaled_ledger(moved, sys_p)
    empty = moved.replace(h_marg=torch.zeros_like(win.h_marg),
                          b_marg=torch.zeros_like(win.b_marg),
                          energy_marg=torch.zeros_like(win.energy_marg))

    # K9 — against the plain version in f64 arithmetic on the same f32 inputs
    # (the gate: the kernel factors in f64), and against the plain version as
    # it runs (an f32 library solve): how far that sits from the f64 result is
    # its own rounding
    lam0 = opts.initial_regularizer
    err9, abs9 = 0.0, 0.0
    for lam in (lam0, lam0 * 1e3):
        out_k = pba._solve_step_cuda(filled, sys_p, eps, idepth, lam, opts)
        out_p = pba._solve_step_plain(filled, sys_p, eps, idepth, lam, opts)
        out_64 = pba._solve_step_plain(par.to_f64(filled), par.to_f64(sys_p), eps.double(),
                                       idepth.double(), lam, opts)
        e64 = par.solve_step_errors(out_k, out_64, eps, idepth)
        e32 = par.solve_step_errors(out_k, out_p, eps, idepth)
        plain = par.solve_step_errors(out_p, out_64, eps, idepth)
        err9 = max(err9, e64["step"], e64["d_step"])
        abs9 = max(abs9, float((out_k[0].double() - out_64[0]).abs().max()))
        log(f"  K9 ba_solve_step ({label}) lam={lam:.0e}, step / idepth step relative to the"
            f" step's norm: kernel vs plain f64 {e64['step']:.2e} / {e64['d_step']:.2e}, kernel"
            f" vs plain f32 {e32['step']:.2e} / {e32['d_step']:.2e}, plain f32 vs plain f64"
            f" {plain['step']:.2e} / {plain['d_step']:.2e}; squared norms {e64['pose_sq']:.2e}"
            f" / {e64['d_sq']:.2e}")
        require(float((out_64[0] - eps.double()).abs().max()) > 0, f"K9 ({label}): zero step")
    require(err9 <= 1e-4, f"K9 ({label}): step differs by {err9:.3g} of its norm from the plain"
            " version in f64 arithmetic")
    if "ba_solve_step" in timed:
        h_full, b_full, _ = pba._assemble_step_system(filled, sys_p, eps, lam0)
        yard = cuda_ms(lambda: torch.linalg.solve_ex(h_full, b_full[:, None]))
        log(f"  K9 yardstick ({label}): torch.linalg.solve_ex on the assembled {kb}x{kb}"
            f" system {yard:.4f} ms (the solve only)")
        row("ba_solve_step", max_abs_err=abs9,
            ms=cuda_ms(lambda: pba._solve_step_cuda(filled, sys_p, eps, idepth, lam0, opts)),
            plain_ms=cuda_ms(lambda: pba._solve_step_plain(filled, sys_p, eps, idepth, lam0, opts)),
            **bound(nbytes(sys_p.h_pose, sys_p.b_pose, sys_p.h_schur, sys_p.b_schur, sys_p.hpd,
                           sys_p.inv_hdd, sys_p.b_d, filled.h_marg, filled.b_marg, eps, idepth,
                           win.frame_valid) + nbytes(eps, idepth) + 8,
                    2 * kb ** 3 // 3 + 2 * kb * kb + 2 * k * n * kb))

    # K10 — the device-resident loop against the host-driven one (same parts,
    # kernels K6-K9 and K11 in both), with an empty and with a filled ledger
    err10 = 0.0
    for case, start in (("empty ledger", empty), ("filled ledger", filled)):
        log_k, log_p = [], []
        res_k = pba._solve_loop_cuda(start, model, opts, log=log_k)
        res_p = pba._solve_loop_plain(start, model, opts, log=log_p)
        err = par.solve_loop_errors(res_k, res_p, log_k, log_p)
        log(f"  K10 ba_lm ({label}, {case}): {err}")
        require(err["same_flags"], f"K10 ({label}, {case}): accept/done sequences differ:"
                f" {log_k} vs {log_p}")
        require((err["relins"] > 0) == (case == "empty ledger"),
                f"K10 ({label}, {case}): {err['relins']} relinearizations")
        require(err["accepts"] >= 1, f"K10 ({label}, {case}): no step accepted")
        require(err["energy"] <= 1e-4 and err["log_energy"] <= 1e-4,
                f"K10 ({label}, {case}): energy differs by {err['energy']:.3g}")
        require(err["rotation"] <= 1e-4 and err["translation"] <= 1e-4,
                f"K10 ({label}, {case}): poses differ by {err['rotation']:.3g} rad,"
                f" {err['translation']:.3g} m")
        require(err["status_agree"] >= 0.999,
                f"K10 ({label}, {case}): statuses agree on {err['status_agree']:.5f}")
        err10 = max(err10, err["translation"], err["rotation"])
    if "ba_lm" in timed:
        control, plain_control, moved_bytes = lm_control(pba, torch, filled, model, opts)
        row("ba_lm", max_abs_err=err10, ms=cuda_ms(control),
            plain_ms=cuda_ms(plain_control), **bound(moved_bytes, 4 * k * k * n))
        log(f"  K10 whole solve ({label}, filled ledger): device-resident loop"
            f" {cuda_ms(lambda: pba._solve_loop_cuda(filled, model, opts), reps=10):.3f}"
            f" ms, host-driven loop"
            f" {cuda_ms(lambda: pba._solve_loop_plain(filled, model, opts), reps=10):.3f} ms")

    # K11 — on K7's evaluation of the moved window
    ps_k = pba._point_status_from_ev_cuda(moved, ev_k, lm_mask, opts)
    ps_p = pba._point_status_from_ev_plain(moved, ev_k, lm_mask, opts)
    err = par.point_status_errors(ps_k, ps_p, ev_k)
    log(f"  K11 ba_point_status ({label}): threshold {float(ps_p.threshold):.4f},"
        f" {int((ps_p.res_status == pba.RES_OUTLIER).sum())} outlier groups, {err}")
    require(err["threshold"] <= 1e-6, f"K11 ({label}): threshold differs by {err['threshold']:.3g}")
    require(err["status_differ"] == 0 and err["inliers_differ"] == 0 and err["flags_differ"] == 0,
            f"K11 ({label}): statuses or counts differ outside the threshold band: {err}")
    require(err["baseline"] <= 1e-6, f"K11 ({label}): baseline differs by {err['baseline']:.3g}")
    if "ba_point_status" in timed:
        flat = torch.where(ev_k.ok, ev_k.energy_patch,
                           torch.full_like(ev_k.energy_patch, float("nan"))).reshape(-1)
        log(f"  K11 yardstick ({label}): torch.nanquantile over {flat.numel()} values"
            f" {cuda_ms(lambda: torch.nanquantile(flat, 0.75)):.4f} ms (the threshold only)")
        row("ba_point_status", max_abs_err=float((ps_k.threshold - ps_p.threshold).abs()),
            ms=cuda_ms(lambda: pba._point_status_from_ev_cuda(moved, ev_k, lm_mask, opts)),
            plain_ms=cuda_ms(lambda: pba._point_status_from_ev_plain(moved, ev_k, lm_mask, opts)),
            **bound(nbytes(ev_k.energy_patch, ev_k.ok, ev_k.status_candidate, moved.t_lin_q,
                           moved.t_lin_t, moved.eps, moved.lm_idepth, lm_mask, moved.lm_baseline,
                           moved.lm_outlier, moved.lm_opt_count) + nbytes(*ps_k),
                    OPS_STATUS_GROUP * k * k * n))

    parity_marg(tracker, {"empty ledger": empty, "filled ledger": filled}, torch, rows, label)


def parity_marg(tracker, windows, torch, rows, label):
    """K15p on the filled-ledger window of ``windows`` at the tracker's window
    sizes and with the window one frame too large; K15 on both windows in the
    flagging cases of ``parity.MARG_CASES``.  The kernels' rows of ``rows``
    are the standart ones; the dense times are printed."""
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing import parity as par
    from dsopp_tpu_torch.tracker import marginalization as marg

    cfg, model, opts = tracker.config, tracker.models[0], tracker.pba_opts
    win = windows["filled ledger"]
    k, n = win.num_slots, win.num_landmark_slots
    kb = k * pba.BLOCK
    frames = int(win.frame_valid.sum())
    imm_counts = torch.sum(tracker.immature.valid, dim=1)

    # K15p
    flagged = 0
    for lo, hi in ((cfg.window_min, cfg.window_max), (min(cfg.window_min, frames - 2), frames - 1)):
        args = (win, imm_counts, lo, hi, cfg.max_marginalized_fraction)
        out_k = no_host_reads(torch, marg.flags_device_cuda, *args)
        out_p = marg.flags_device_plain(*args)
        err = par.policy_errors(out_k, out_p, win, lo, hi)
        log(f"  K15p marg_policy ({label}, window {lo}..{hi}, {frames} of {k} frames): {err}")
        require(err["explained"],
                f"K15p ({label}): outputs differ from the plain version beyond a score tie: {err}")
        flagged += err["frames_flagged"]
        policy_args, policy_out = args, out_k
    require(flagged > 0, f"K15p ({label}): no frame was flagged")

    # K15
    gen = torch.Generator(device="cuda").manual_seed(1)
    timed_case = None
    for ledger, start in windows.items():
        for case, slots in par.marg_cases(start).items():
            w, perm = par.marg_case(start, case, slots, gen)
            lm = w.lm_marg_flag
            h_pts, b_pts, e_land = pba._marg_system_kernel(w, model, opts)
            fold = (w, h_pts.contiguous(), b_pts.contiguous(), e_land, perm, opts)
            sweeps = torch.zeros(1, dtype=torch.int32, device="cuda")
            out_k = no_host_reads(torch, pba._marginalize_cuda, *fold, sweeps)
            again = pba._marginalize_cuda(*fold)
            err = par.ledger_check(out_k, fold)
            win_k = no_host_reads(torch, pba._marginalize_device, w, model, perm, opts)
            win_p = pba._marginalize_with(pba._marginalize_plain, w, model, perm, opts)
            same = all(torch.equal(getattr(win_k, f), getattr(win_p, f))
                       for f in ("frame_valid", "frame_id", "lm_valid"))
            log(f"  K15 marg_fold ({label}, {ledger}, {case}: slots {slots}, {int(lm.sum())}"
                f" landmarks): H {err['H']:.2e} b {err['b']:.2e} E {err['E']:.2e} of the largest"
                f" entry; {err['eigenvalues']} eigenvalues in {int(sweeps)} Jacobi sweeps, cutoff"
                f" {err['cutoff']:.4g}, {err['dropped']} dropped, {err['ties']} within"
                f" {par.CUTOFF_TIE} of it")
            require(err["within"], f"K15 ({label}, {ledger}, {case}): the ledger differs from the"
                    f" plain version's, with the cutoff at either edge of its tie band: {err}")
            require(int(sweeps) < pba.MARG_MAX_SWEEPS,
                    f"K15 ({label}, {ledger}, {case}): the Jacobi solver did not converge")
            require(all(torch.equal(a, b) for a, b in zip(out_k, again)),
                    f"K15 ({label}, {ledger}, {case}): two runs differ")
            require(same, f"K15 ({label}, {ledger}, {case}): frame validity, ids or landmark"
                    " validity differ")
            if ledger == "filled ledger" and case == "one free frame":
                timed_case = (fold, out_k, err["eigenvalues"])
    def row(name, **fields):
        if label == "standart":
            rows[name] = fields
        else:
            log(f"  {name} ({label}): kernel {fields['ms']:.4f} ms, plain {fields['plain_ms']:.4f}"
                f" ms, bound {fields['bound_ms']:.5f} ms ({fields['bound_by']})")

    args = policy_args
    poses_t = win.poses().t
    row("marg_policy", **dict(
        max_abs_err=max(float((a.long() - b.long()).abs().max())
                        for a, b in zip(policy_out, marg.flags_device_plain(*args))),
        ms=cuda_ms(lambda: marg.flags_device_cuda(*args)),
        plain_ms=cuda_ms(lambda: marg.flags_device_plain(*args)),
        **bound(nbytes(win.lm_valid, win.lm_outlier, win.lm_inliers, win.lm_opt_count,
                       win.frame_valid, win.frame_id, imm_counts, poses_t) + 4 * k * n
                + nbytes(*policy_out), OPS_POLICY_LANDMARK * k * n + OPS_POLICY_PAIR * k * k),
        library_ms=None))
    fold, out_k, m_rows = timed_case
    w = fold[0]
    # the library's pseudo-inverse of the padded block, as the plain version calls it
    from dsopp_tpu_torch.solvers.linear import pinv_hermitian
    hm, mrow = par.folded_ledger(w, fold[1], opts)
    h_ee = torch.where(mrow[:, None] & mrow[None, :], hm,
                       torch.eye(kb, dtype=hm.dtype, device=hm.device))
    lib = cuda_ms(lambda: pinv_hermitian(h_ee, w.eps.dtype), reps=10)
    log(f"  K15 yardstick ({label}): torch.linalg.pinv(hermitian=True) of the padded {kb}x{kb}"
        f" block {lib:.4f} ms (the pseudo-inverse only)")
    ops = (6 * kb * kb + OPS_EIGEN * m_rows ** 3 + 6 * m_rows ** 3 + 2 * kb * m_rows ** 2
           + 4 * kb * kb * m_rows + 2 * kb * m_rows)
    row("marg_fold", **dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(out_k, pba._marginalize_plain(*fold))),
        ms=cuda_ms(lambda: pba._marginalize_cuda(*fold)),
        plain_ms=cuda_ms(lambda: pba._marginalize_plain(*fold), reps=10),
        **bound(nbytes(*fold[1:4], w.eps, w.affine0, w.frame_valid, w.frame_fixed, w.frame_marg,
                       fold[4], w.h_marg, w.b_marg, w.energy_marg) + nbytes(*out_k), ops,
              PEAK_FLOPS_F64),
        library_ms=lib))


def parity_gather(torch, rows):
    """The row gather at the probe's shapes, f32 (its row) and bf16, equal to
    ``table[idx]`` to the bit; ``torch.index_select`` as the yardstick."""
    from dsopp_tpu_torch.testing import gather_probe as gp

    table, table_bf, idx = gp.probe_inputs("cuda")
    for name, tab in (("f32", table), ("bf16", table_bf)):
        gp.row_gather(tab, idx)       # the range check reads the device once
        out_k = no_host_reads(torch, gp.row_gather_cuda, tab, idx)
        out_p = gp.row_gather_plain(tab, idx)
        require(torch.equal(out_k, out_p), f"row gather ({name}): differs from table[idx]")
        fields = dict(
            max_abs_err=float((out_k.float() - out_p.float()).abs().max()), ms=cuda_ms(lambda: gp.row_gather_cuda(tab, idx)),
            plain_ms=cuda_ms(lambda: gp.row_gather_plain(tab, idx)),
            bound_ms=gp.bound_ms(tab, idx, PEAK_BYTES), bound_by="bytes",
            library_ms=cuda_ms(lambda: torch.index_select(tab, 0, idx)))
        log(f"  row_gather ({name}): {idx.numel()} rows of {tab.shape[1]} from a {tab.shape[0]}-row"
            f" table, equal to table[idx]; kernel {fields['ms']:.4f} ms, plain"
            f" {fields['plain_ms']:.4f} ms, torch.index_select {fields['library_ms']:.4f} ms, bound"
            f" {fields['bound_ms']:.5f} ms")
        if name == "f32":
            rows["row_gather"] = fields


def parity_photometric(torch, rows, card):
    """K18 against its plain version, equal to the bit, on u8 and f32 frames
    (the f32 ones reach past both ends of [0, 255]), with and without the
    sensor path's vignette, at VGA and at 479x637 (a width that is not a
    multiple of 4); timed on a VGA u8 frame with the vignette, the sensor
    path's call.  No PyTorch call computes this function: no library time."""
    from dsopp_tpu_torch.sensors import photometric as ph
    from dsopp_tpu_torch.testing import paths
    from dsopp_tpu_torch.testing.gather_probe import device_us

    gen = torch.Generator(device="cuda").manual_seed(18)
    lut = torch.as_tensor(paths.inverse_response(), device="cuda")
    err, cases = 0.0, 0
    for h, w in ((paths.HEIGHT, paths.WIDTH), (479, 637)):
        vignette = torch.as_tensor(paths.sensor_vignette(h, w), device="cuda")
        raw_u8 = torch.randint(0, 256, (h, w), generator=gen, device="cuda", dtype=torch.uint8)
        raw_f32 = torch.rand((h, w), generator=gen, device="cuda") * 275.0 - 10.0
        for raw in (raw_u8, raw_f32):
            for vig in (None, vignette):
                out_k = no_host_reads(torch, ph.correct_image_cuda, raw, lut, vig)
                out_p = ph.correct_image_plain(raw, lut, vig)
                require(out_k.dtype == torch.float32 and out_k.shape == (h, w),
                        f"K18: output {out_k.dtype} {tuple(out_k.shape)}")
                require(torch.equal(out_k, out_p),
                        f"K18 ({h}x{w}, {raw.dtype}, vignette {vig is not None}): differs from"
                        f" the plain version by {float((out_k - out_p).abs().max())}")
                err = max(err, float((out_k - out_p).abs().max()))
                cases += 1
    raw = torch.randint(0, 256, (paths.HEIGHT, paths.WIDTH), generator=gen, device="cuda",
                        dtype=torch.uint8)
    vignette = torch.as_tensor(paths.sensor_vignette(paths.HEIGHT, paths.WIDTH), device="cuda")
    out = ph.correct_image_cuda(raw, lut, vignette)
    fields = dict(
        max_abs_err=err, ms=cuda_ms(lambda: ph.correct_image_cuda(raw, lut, vignette)),
        plain_ms=cuda_ms(lambda: ph.correct_image_plain(raw, lut, vignette)),
        **bound(nbytes(raw, lut, vignette, out), OPS_PHOTOMETRIC_PIXEL * raw.numel()),
        library_ms=None,
        device_us=device_us(lambda: ph.correct_image_cuda(raw, lut, vignette), reps=200))
    log(f"  K18 photometric_correct: {cases} cases equal to the plain version to the bit;"
        f" VGA u8 with the vignette: kernel {fields['ms']:.4f} ms a wrapper call,"
        f" {fields['device_us']:.3f} device us, plain {fields['plain_ms']:.4f} ms, bound"
        f" {1e3 * fields['bound_ms']:.3f} us ({fields['bound_by']}), no library call | {card}")
    rows["photometric_correct"] = fields


def lm_control(pba, torch, window, model, opts):
    """K10's control alone, on the first iteration's trial as the device loop
    prepares it → (the kernel's init + step phases, the host-driven loop's
    energy + decision on the same trial, the bytes the two phases must move)."""
    lm_mask = pba.active_lm_mask(window)
    state = torch.zeros(pba.LM_FIELDS, dtype=torch.int32, device="cuda")
    lm_log = torch.zeros((2, pba.LM_FIELDS), dtype=torch.int32, device="cuda")
    carried, win = pba._carried_state(window)
    eps, idepth, status = carried[3], carried[4], carried[6]
    ev = pba._evaluate_cuda(win, model, eps, idepth, lm_mask, opts)
    fej = pba._fej_cache_cuda(win, model)
    sys = pba._linearize_from_ev_cuda(win, fej, ev, eps, opts)
    eps_new, idepth_new, step_sq = pba._solve_step_launch(win, sys, eps, idepth,
                                                          opts.initial_regularizer, None)
    ev_new = pba._evaluate_cuda(win, model, eps_new, idepth_new, lm_mask, opts)

    def control():
        pba._lm_phase(0, 0, win, opts, eps, idepth, None, ev, carried, ev, state, lm_log)
        pba._lm_phase(1, 1, win, opts, eps_new, idepth_new, step_sq, ev_new, carried, ev, state,
                      lm_log)

    def plain_control():
        e, _ = pba._energy_from_ev(win, ev, eps, opts)
        pba._lm_decide_plain(win, ev_new, eps_new, step_sq[0], step_sq[1], e, 0, opts)

    # both phases read the patch energies, the ledger and eps; an accepted
    # step copies the trial (evaluation, statuses, eps, idepth) over the carried
    reads = nbytes(ev.energy_patch, window.h_marg, window.b_marg, eps)
    commit = nbytes(*ev_new, status, eps_new, idepth_new)
    return control, plain_control, 2 * reads + 2 * commit


def trajectory_rmse(tracker, seq):
    """RMSE of the track's full-rate trajectory (marginalized and window
    keyframes with their attached frames) against ground truth, unaligned, and
    its entry count (tests/tracker/test_ledger_drift_tracker.py's measure)."""
    gt = {round(float(t), 6): seq.poses_t[i] for i, t in enumerate(seq.timestamps)}
    traj = tracker.track.trajectory(tracker.window)
    errs = np.asarray([np.linalg.norm(m[:3, 3] - gt[round(t, 6)]) for t, m in traj
                       if round(t, 6) in gt])
    return float(np.sqrt(np.mean(errs ** 2))), len(errs)


def semantic_check(tracker):
    """The sensor path's semantics at the end of its run → (valid immature
    points and window landmarks on the filtered rows, marginalized landmarks
    on them, marginalized landmarks whose class is not the class of their
    keyframe's pixel, marginalized landmarks checked)."""
    from dsopp_tpu_torch.testing import paths

    first = paths.SEMANTIC_FIRST_ROW
    win, imm = tracker.window, tracker.immature
    in_window = int((imm.valid & (imm.uv[..., 1] >= first - 0.5)).sum()) + int(
        (win.lm_valid & win.frame_valid[:, None] & (win.lm_uv[..., 1] >= first - 0.5)).sum())
    on_rows = wrong = checked = 0
    for kf in tracker.track.marginalized:
        require(kf.lm_semantic is not None, f"keyframe {kf.frame_id} has no lm_semantic")
        valid = np.asarray(kf.lm_valid)
        uv = np.asarray(kf.lm_uv)[valid]
        h, w = tracker.image_shape
        expected = paths.semantic_classes(h, w)[np.clip(np.rint(uv[:, 1]).astype(int), 0, h - 1),
                                                np.clip(np.rint(uv[:, 0]).astype(int), 0, w - 1)]
        on_rows += int((uv[:, 1] >= first - 0.5).sum())
        wrong += int((np.asarray(kf.lm_semantic)[valid] != expected).sum())
        checked += int(valid.sum())
    return in_window, on_rows, wrong, checked


def track(seq, name, torch, kernels, camera=None):
    """Path ``name``: the known-pose bootstrap, then PipelinedTracker over the
    frames after it, with the launch counts set to 0 just before those
    frames and read just after (the bootstrap's launches do not count).
    ``camera``: the sensor path's camera, whose frames (with their exposures
    and class-id images) take the place of the rendered ones."""
    from dsopp_tpu_torch.testing.paths import (INIT_FRAMES, MASK_FIRST_INVALID_ROW, bootstrap,
                                               closed_gate, path_config, path_frames,
                                               path_mask, sensor_bootstrap)
    from dsopp_tpu_torch.tracker import device_loop, fused_keyframe
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker, device_tick

    last = path_frames(name)
    cfg = path_config(name)
    torch.cuda.reset_peak_memory_stats()
    k18_before = kernels.PHOTOMETRIC.launches
    if camera is None:
        tracker = bootstrap(seq, cfg, path_mask(name))
    else:
        tracker = sensor_bootstrap(camera, seq, cfg)
    k18_bootstrap = kernels.PHOTOMETRIC.launches - k18_before
    kf_boot = tracker.num_keyframes
    pipe = PipelinedTracker(tracker, flush_every=16)
    poses, gate_ratios, escalations, solves, keyframes = [], [], 0, [0], []
    folds = [0]
    solve_loop = fused_keyframe._solve_loop_device
    flags, marginalize = device_loop.flags_device, device_loop._marginalize_device

    def solve_without_host_reads(window, model, opts):
        """The keyframe's BA solve with every host synchronisation an error."""
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = solve_loop(window, model, opts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        solves[0] += 1
        return out

    def flags_without_host_reads(*args):
        """The policy opens the span that the ledger fold closes: from the
        policy through the fold, every host synchronisation is an error."""
        torch.cuda.set_sync_debug_mode("error")
        return flags(*args)

    def marginalize_without_host_reads(*args):
        try:
            out = marginalize(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        folds[0] += 1
        return out

    torch.cuda.synchronize()
    kernels.reset_counts()
    fused_keyframe._solve_loop_device = solve_without_host_reads
    device_loop.flags_device = flags_without_host_reads
    device_loop._marginalize_device = marginalize_without_host_reads
    try:
        t0 = time.perf_counter()
        for i in range(INIT_FRAMES, last):
            state_before = pipe.state
            if camera is None:
                diag = pipe.tick(i, float(seq.timestamps[i]), seq.images[i])
            else:
                frame = camera.next_frame()
                require(frame is not None and frame.frame_id == i,
                        f"the camera gave {frame and frame.frame_id} for frame {i}")
                diag = pipe.tick(i, frame.timestamp, frame.image, semantics=frame.semantics,
                                 exposure=frame.exposure)
            poses.append(diag.pose_t)
            # the re-track gate tests chunk 0's rmse against 2.5 x the last
            # reliable one
            gate_ratios.append(diag.rmse_chunk0 / state_before.rmse_last0)
            escalations += int(diag.escalated)
            if diag.is_keyframe:
                keyframes.append((i, diag.n_active, diag.n_activated, diag.min_distance))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
        fused_keyframe._solve_loop_device = solve_loop
        device_loop.flags_device, device_loop._marginalize_device = flags, marginalize
    pipe.finalize()
    counts = kernels.counts()
    win = tracker.window
    est = torch.stack(poses).double().cpu().numpy()
    require(np.all(np.isfinite(est)), "non-finite tracked poses")
    gt = seq.poses_t[INIT_FRAMES:last]
    errs = np.linalg.norm(est - gt, axis=-1)
    aligned, scale = sim3_aligned_errors(est, gt)
    stats = dict(ate_rmse=float(np.sqrt(np.mean(aligned ** 2))), ate_max=float(aligned.max()),
                 scale=scale, frames=last - INIT_FRAMES, seconds=elapsed,
                 fps=(last - INIT_FRAMES) / elapsed,
                 keyframes=tracker.num_keyframes - kf_boot, escalations=escalations,
                 marginalized=len(tracker.track.marginalized),
                 # a frame escalates at chunk 0's rmse >= 2.5 x the last reliable
                 # rmse; the first tracked frame has no reliable rmse before it yet;
                 # a path without the re-track has no gate
                 gate_ratio=(float(torch.stack(gate_ratios[1:]).max())
                             if cfg.use_rotation_perturbations else None),
                 rmse=float(np.sqrt(np.mean(errs ** 2))), max_err=float(errs.max()),
                 counts=counts, ba_solves=solves[0], marg_spans=folds[0],
                 window_frames=int(win.frame_valid.sum()),
                 active_landmarks=int((win.lm_valid & ~win.lm_outlier
                                       & win.frame_valid[:, None]).sum()),
                 peak_memory_mb=torch.cuda.max_memory_allocated() / 1e6,
                 per_keyframe=[(i, int(a), int(b), round(float(c), 3))
                               for i, a, b, c in keyframes])
    stats["trajectory_rmse"], stats["trajectory_entries"] = trajectory_rmse(tracker, seq)
    stats["k18_bootstrap"] = k18_bootstrap
    if camera is not None:
        stats["semantics"] = semantic_check(tracker)
    if name == "masked":
        # tests/tracker/test_mask.py: no point is ever born in the masked region
        imm, lm_valid = tracker.immature, win.lm_valid & win.frame_valid[:, None]
        stats["masked_points"] = (
            int(imm.valid.sum()), int(lm_valid.sum()),
            int((imm.valid & (imm.uv[..., 1] >= MASK_FIRST_INVALID_ROW)).sum()),
            int((lm_valid & (win.lm_uv[..., 1] >= MASK_FIRST_INVALID_ROW)).sum()))

    def force_escalation():
        """The last frame again from the state before it, with the re-track
        gate closed: chunk 0 fails it and chunks 1..21 run.  → distance of
        the escalated pose from the tracked one."""
        before = kernels.ALIGN_LEVEL.launches
        _, diag = device_tick(closed_gate(state_before), seq.images[last - 1], last - 1, False,
                              pipe.models, pipe.cfg, mask=pipe.mask)
        require(diag.escalated, "the forced frame did not escalate")
        require(kernels.ALIGN_LEVEL.launches - before == 10,
                f"an escalated frame launches K3 10 times, got {kernels.ALIGN_LEVEL.launches - before}")
        require(bool(torch.isfinite(diag.pose_t).all()), "non-finite escalated pose")
        return float((diag.pose_t - poses[-1]).norm())

    return stats, force_escalation


def track_reference(seq, name, torch):
    """Path ``name`` in float64 on the CPU (the plain versions): the bootstrap,
    then PipelinedTracker over the frames after it → the per-frame tracked
    positions' error and the trajectory's against ground truth, marginalized
    keyframes, seconds."""
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES, bootstrap, path_config, path_frames
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker

    last = path_frames(name)
    # a fixed thread count: the CPU's reductions split by it, and this run
    # is chaotic in its last bits (tests/tracker/test_ledger_drift_tracker.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(LEDGER_CPU_THREADS)
    t0 = time.perf_counter()
    try:
        tracker = bootstrap(seq, path_config(name), dtype=torch.float64, device="cpu")
        kf_boot = tracker.num_keyframes
        pipe = PipelinedTracker(tracker, flush_every=16)
        poses = [pipe.tick(i, float(seq.timestamps[i]), seq.images[i]).pose_t
                 for i in range(INIT_FRAMES, last)]
        pipe.finalize()
        traj_rmse, traj_entries = trajectory_rmse(tracker, seq)
    finally:
        torch.set_num_threads(threads)
    est = torch.stack(poses).numpy()
    require(np.all(np.isfinite(est)), "non-finite tracked poses (f64 on the CPU)")
    errs = np.linalg.norm(est - seq.poses_t[INIT_FRAMES:last], axis=-1)
    return dict(rmse=float(np.sqrt(np.mean(errs ** 2))), max_err=float(errs.max()),
                trajectory_rmse=traj_rmse, trajectory_entries=traj_entries,
                keyframes=tracker.num_keyframes - kf_boot,
                marginalized=len(tracker.track.marginalized), seconds=time.perf_counter() - t0)


def e2e(torch, card, exposure):
    """tests/tracker/test_monocular_e2e.py's run on the card in f32 (240x320,
    40 frames, 8-frame known-pose bootstrap, then PipelinedTracker), plain or
    under the exposure oscillation, with that test's gates; the exposure run
    also replays each tick from the card's state by the plain versions on
    the CPU."""
    from dsopp_tpu_torch.testing import paths
    from dsopp_tpu_torch.testing.parity import moved
    from dsopp_tpu_torch.tracker.device_loop import device_tick

    label = "e2e-exposure" if exposure else "e2e"
    records, replay_seconds = [], [0.0]

    def replay(pipe, state, image, frame_id, e, diag):
        t = time.perf_counter()
        _, plain = device_tick(moved(state, "cpu"), image.cpu(), frame_id, False, pipe.models,
                               pipe.cfg, exposure=e)
        gap = float((diag.pose_t.double().cpu() - plain.pose_t.double()).abs().max())
        records.append((frame_id, bool(diag.is_keyframe), bool(plain.is_keyframe), gap))
        replay_seconds[0] += time.perf_counter() - t

    t0 = time.perf_counter()
    seq, tracker, diags = paths.e2e_run(torch.float32, "cuda", exposure=exposure,
                                        replay=replay if exposure else None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 - replay_seconds[0]
    est = torch.stack([d.pose_t for d in diags]).double().cpu().numpy()
    require(np.all(np.isfinite(est)), f"[{label}] non-finite tracked poses")
    errs = np.linalg.norm(est - seq.poses_t[paths.E2E_INIT_FRAMES:paths.E2E_FRAMES], axis=-1)
    rmse, max_err = float(np.sqrt(np.mean(errs ** 2))), float(errs.max())
    win = tracker.window
    n_active = int((win.lm_valid & ~win.lm_outlier).sum())
    traj = tracker.track.trajectory(win)
    times = [t for t, _ in traj]
    traj_rmse, _ = trajectory_rmse(tracker, seq)
    log(f"[{label}] {tracker.num_keyframes} keyframes, {int(win.frame_valid.sum())} in the"
        f" window, {n_active} active landmarks, {len(tracker.track.marginalized)} marginalized"
        f" (|h_marg| max {float(win.h_marg.abs().max()):.4g}), unaligned per-frame RMSE"
        f" {rmse:.5f} m max {max_err:.5f} m, trajectory {len(traj)} entries (RMSE"
        f" {traj_rmse:.5f} m), f32 on the card in {seconds:.2f} s | {card}")
    if exposure:
        parted = [r[0] for r in records if r[1] != r[2]]
        worst = max(records, key=lambda r: r[3])
        log(f"[{label}] replay: {len(records)} ticks from the card's state by the plain versions"
            f" on the CPU (f32) in {replay_seconds[0]:.2f} s, keyframe decisions parted on"
            f" {parted or 'none'}, largest pose gap {worst[3]:.3e} m (frame {worst[0]}), gate"
            f" {E2E_REPLAY_POSE_TOL} m")
        require(not parted, f"[{label}] the replay's keyframe decisions part at frames {parted}")
        require(worst[3] < E2E_REPLAY_POSE_TOL,
                f"[{label}] replayed pose {worst[3]:.3e} m from the card's at frame {worst[0]}")
        require(rmse < E2E_EXPOSURE_RMSE_GATE,
                f"[{label}] RMSE {rmse:.5f} m >= {E2E_EXPOSURE_RMSE_GATE}")
        return
    require(tracker.num_keyframes >= E2E_MIN_KEYFRAMES,
            f"[{label}] {tracker.num_keyframes} keyframes < {E2E_MIN_KEYFRAMES}")
    require(int(win.frame_valid.sum()) >= 2, f"[{label}] the window ends with < 2 frames")
    require(n_active > E2E_MIN_ACTIVE, f"[{label}] only {n_active} active landmarks")
    require(rmse < RMSE_GATE, f"[{label}] RMSE {rmse:.5f} m >= {RMSE_GATE}")
    require(max_err < MAX_GATE, f"[{label}] max error {max_err:.5f} m >= {MAX_GATE}")
    require(len(traj) >= E2E_MIN_TRAJECTORY and times == sorted(times),
            f"[{label}] trajectory of {len(traj)} entries, sorted {times == sorted(times)}")
    require(len(tracker.track.marginalized) >= 1 and float(win.h_marg.abs().max()) > 0,
            f"[{label}] the window was never marginalized")


def sensor(seq, torch, kernels, card):
    """The camera sensor path: the corridor written as a camera's files (raw
    u8 frames, times with exposures, G^-1, a pinhole calibration, class-id
    images), read through NpyFolderProvider -> Camera (upload, K18) into the
    known-pose bootstrap and PipelinedTracker at the standart point; then
    the file read, the upload and K18 timed per frame."""
    import tempfile

    from dsopp_tpu_torch.sensors.photometric import correct_image_cuda
    from dsopp_tpu_torch.sensors.providers import NpyFolderProvider
    from dsopp_tpu_torch.testing import paths

    with tempfile.TemporaryDirectory(prefix="dsopp_sensor_") as folder:
        t0 = time.perf_counter()
        params, clipped = paths.write_sensor_folder(seq, folder)
        n_px = seq.images.numel()
        log(f"[sensor] {seq.images.shape[0]} raw u8 frames written (gamma {paths.GAMMA},"
            f" vignette down to {paths.VIGNETTE_MIN}, exposure 1 + 0.12 sin(0.35 i)):"
            f" {clipped} of {n_px} pixels clipped ({100.0 * clipped / n_px:.4f} %)"
            f" ({time.perf_counter() - t0:.2f} s)")
        require(clipped < 0.01 * n_px, f"[sensor] {clipped} of {n_px} pixels clipped")
        t0 = time.perf_counter()
        camera = paths.sensor_camera(folder, params)
        st, _ = track(seq, "sensor", torch, kernels, camera=camera)
        report("sensor", st, card, time.perf_counter() - t0)
        in_window, on_rows, wrong, checked = st["semantics"]
        log(f"[sensor] K18 launched {st['counts']['photometric_correct']} times over"
            f" {st['frames']} tracked frames and {st['k18_bootstrap']} times over"
            f" {paths.INIT_FRAMES} bootstrap frames; class {paths.SEMANTIC_FILTERED} filtered: {in_window}"
            f" immature points and window landmarks and {on_rows} marginalized landmarks on rows"
            f" >= {paths.SEMANTIC_FIRST_ROW}; {checked} marginalized landmarks labelled,"
            f" {wrong} with a class other than their keyframe's pixel")
        require(st["counts"]["photometric_correct"] == st["frames"],
                f"[sensor] K18 launched {st['counts']['photometric_correct']} times for"
                f" {st['frames']} frames")
        require(st["k18_bootstrap"] == paths.INIT_FRAMES,
                f"[sensor] K18 launched {st['k18_bootstrap']} times in the bootstrap")
        require(st["marginalized"] >= 1 and checked > 0, "[sensor] no marginalized landmark")
        require(in_window == 0 and on_rows == 0,
                f"[sensor] {in_window} points in the window and {on_rows} marginalized"
                " landmarks on the filtered rows")
        require(wrong == 0, f"[sensor] {wrong} landmarks labelled with another class")
        # per frame: the file read, the upload and K18, each on its own
        provider = NpyFolderProvider(os.path.join(folder, "images"))
        lut = torch.as_tensor(paths.inverse_response(), device="cuda")
        vignette = torch.as_tensor(paths.sensor_vignette(paths.HEIGHT, paths.WIDTH), device="cuda")
        read_s, upload_s, k18_ms = [], [], []
        while True:
            t0 = time.perf_counter()
            frame = provider.next_frame()
            if frame is None:
                break
            read_s.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw = torch.as_tensor(frame.image).to("cuda")
            torch.cuda.synchronize()
            upload_s.append(time.perf_counter() - t0)
            if len(k18_ms) < 10:
                k18_ms.append(cuda_ms(lambda: correct_image_cuda(raw, lut, vignette), reps=20))
    st["read_ms"] = 1e3 * float(np.mean(read_s))
    st["upload_ms"] = 1e3 * float(np.mean(upload_s))
    st["k18_ms"] = float(np.mean(k18_ms))
    log(f"[sensor] {st['fps']:.3f} frames/s; per frame: file read {st['read_ms']:.4f} ms,"
        f" upload {st['upload_ms']:.4f} ms ({raw.numel()} B), K18 {st['k18_ms']:.4f} ms a"
        f" wrapper call | {card}")
    return st


def undistort(seq, torch, card):
    """The remap tables of a SimpleRadial VGA calibration built on the card
    in f64 against the CPU's, and one frame remapped on the card against the
    CPU's remap."""
    from dsopp_tpu_torch.core.camera import SimpleRadial
    from dsopp_tpu_torch.sensors.undistorter import build_remaps
    from dsopp_tpu_torch.testing import paths

    source = SimpleRadial.create((float(paths.WIDTH), float(paths.HEIGHT)), 500.0,
                                 (319.5, 239.5), -0.12, 0.02)
    t0 = time.perf_counter()
    on_card = build_remaps(source, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    on_cpu = build_remaps(source, "cpu")
    err_tab = max(float((on_card.map_x.cpu() - on_cpu.map_x).abs().max()),
                  float((on_card.map_y.cpu() - on_cpu.map_y).abs().max()))
    frame = seq.images[10]
    out_card = on_card.undistort(frame)
    out_cpu = on_cpu.undistort(frame.cpu())
    err_img = float((out_card.cpu() - out_cpu).abs().max())
    remap_ms = cuda_ms(lambda: on_card.undistort(frame))
    log(f"[undistort] SimpleRadial {paths.WIDTH}x{paths.HEIGHT}: tables built on the card in"
        f" {build_s:.3f} s, f64, {err_tab:.3g} px from the CPU's; the remap {err_img:.3g} from"
        f" the CPU's, {remap_ms:.4f} ms a frame | {card}")
    require(on_card.map_x.dtype == torch.float64, "[undistort] tables not f64")
    require(err_tab <= REMAP_TABLE_TOL, f"[undistort] tables {err_tab} px > {REMAP_TABLE_TOL}")
    require(err_img <= REMAP_TOL, f"[undistort] remap {err_img} > {REMAP_TOL}")


def report(label, st, card, seconds):
    log(f"[{label}] per keyframe (frame, n_active, n_activated, min_distance after it): "
        + " ".join(f"({i}, {a}, {b}, {c})" for i, a, b, c in st["per_keyframe"]))
    gate = ("gate off" if st["gate_ratio"] is None else
            f"largest rmse ratio of chunk 0 {st['gate_ratio']:.3f} of the gate's 2.5")
    log(f"[{label}] {st['frames']} frames in {st['seconds']:.2f} s = {st['fps']:.3f} frames/s,"
        f" {st['keyframes']} keyframes, {st['escalations']} escalations ({gate}),"
        f" {st['marginalized']} marginalized, aligned ATE RMSE {st['ate_rmse']:.5f} m"
        f" max {st['ate_max']:.5f} m (scale {st['scale']:.4f}), unaligned RMSE"
        f" {st['rmse']:.5f} m max {st['max_err']:.5f} m, trajectory RMSE"
        f" {st['trajectory_rmse']:.5f} m over {st['trajectory_entries']} entries,"
        f" {st['ba_solves']} BA solves and"
        f" {st['marg_spans']} policy-to-fold spans without a host read, window at the last frame {st['window_frames']} frames and"
        f" {st['active_landmarks']} active landmarks, peak device memory"
        f" {st['peak_memory_mb']:.1f} MB, launches {st['counts']} | {card}"
        f" ({seconds:.2f} s with bootstrap)")
    missing = [name for name in PATH_KERNELS if st["counts"][name] == 0]
    require(not missing, f"[{label}] kernels of the path never launched: {missing}")
    rare = [name for name in KEYFRAME_KERNELS if st["counts"][name] < st["keyframes"]]
    require(not rare, f"[{label}] launched less than once per keyframe: {rare}")
    require(st["keyframes"] >= 3, f"[{label}] only {st['keyframes']} keyframes after bootstrap")
    require(st["ba_solves"] == st["keyframes"],
            f"[{label}] {st['ba_solves']} BA solves for {st['keyframes']} keyframes")
    once = [name for name in ONCE_PER_KEYFRAME if st["counts"][name] != st["keyframes"]]
    require(not once, f"[{label}] not launched once per keyframe: {once}")
    require(st["marg_spans"] == st["keyframes"],
            f"[{label}] {st['marg_spans']} policy-to-fold spans without a host read for"
            f" {st['keyframes']} keyframes")


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    try:
        import dsopp_tpu_torch
    except ImportError:
        print("chip_smoke: dsopp_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(dsopp_tpu_torch.__file__))) != here:
        print("chip_smoke: dsopp_tpu_torch must come from this checkout", file=sys.stderr)
        return 2
    from dsopp_tpu_torch import kernels
    from dsopp_tpu_torch.testing import paths

    try:
        t0 = time.perf_counter()
        card = paths.card_line()
        log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
            f"({time.perf_counter() - t0:.2f} s)")

        t0 = time.perf_counter()
        lib = kernels.build()
        kernels.library()
        log(f"[build] {lib.name} ({time.perf_counter() - t0:.2f} s)")

        t0 = time.perf_counter()
        seq = paths.render_path("standart")
        torch.cuda.synchronize()
        require(bool(torch.isfinite(seq.images).all()), "render produced non-finite pixels")
        log(f"[render] {paths.SEQUENCES['standart']}, {paths.HEIGHT}x{paths.WIDTH}"
            f" ({time.perf_counter() - t0:.2f} s)")

        cfg = paths.standart_config()
        t0 = time.perf_counter()
        rows = parity(seq, cfg, torch, card)
        require(set(rows) == set(SOURCES), f"parity rows {sorted(rows)}")
        log(f"[parity] {len(rows)} kernels within tolerance ({time.perf_counter() - t0:.2f} s)")

        t0 = time.perf_counter()
        st, _ = track(seq, "standart", torch, kernels)
        report("track", st, card, time.perf_counter() - t0)
        require(st["marginalized"] >= 1, "no frame was marginalized")
        require(st["ate_rmse"] < RMSE_GATE, f"ATE RMSE {st['ate_rmse']:.5f} m >= {RMSE_GATE}")
        require(st["ate_max"] < MAX_GATE, f"ATE max {st['ate_max']:.5f} m >= {MAX_GATE}")
        require(abs(st["scale"] - 1.0) < SCALE_GATE, f"alignment scale {st['scale']:.4f}")

        t0 = time.perf_counter()
        fast = paths.render_path("fast")
        torch.cuda.synchronize()
        log(f"[render-fast] {paths.SEQUENCES['fast']} ({time.perf_counter() - t0:.2f} s)")
        t0 = time.perf_counter()
        sf, force_escalation = track(fast, "fast", torch, kernels)
        report("track-fast", sf, card, time.perf_counter() - t0)
        if sf["escalations"] == 0:
            moved = force_escalation()
            log(f"[track-fast] no frame escalated by itself; the last frame, escalated through"
                f" device_tick, lands {moved:.5f} m from its tracked pose")
            require(moved < FAST_RMSE_GATE, f"the escalated pose is {moved:.5f} m off")
        require(sf["ate_rmse"] < FAST_RMSE_GATE,
                f"fast ATE RMSE {sf['ate_rmse']:.5f} m >= {FAST_RMSE_GATE}")
        require(abs(sf["scale"] - 1.0) < SCALE_GATE, f"fast alignment scale {sf['scale']:.4f}")
        del fast

        # the dense path runs the sequence of phase 5 (bench.py does the same)
        require(paths.PATHS["dense"][0] == "standart", "the dense path's sequence changed")
        t0 = time.perf_counter()
        dense_cfg = paths.path_config("dense")
        sd, _ = track(seq, "dense", torch, kernels)
        report("track-dense", sd, card, time.perf_counter() - t0)
        require(sd["marginalized"] >= 1,
                f"the dense window ({dense_cfg.window_max} frames) never overflowed")
        require(sd["ate_rmse"] < RMSE_GATE,
                f"dense ATE RMSE {sd['ate_rmse']:.5f} m >= {RMSE_GATE}")
        require(sd["ate_max"] < MAX_GATE, f"dense ATE max {sd['ate_max']:.5f} m >= {MAX_GATE}")
        require(abs(sd["scale"] - 1.0) < SCALE_GATE, f"dense alignment scale {sd['scale']:.4f}")

        # the masked path runs the first frames of the same sequence
        require(paths.PATHS["masked"][0] == "standart", "the masked path's sequence changed")
        t0 = time.perf_counter()
        sm, _ = track(seq, "masked", torch, kernels)
        report("track-masked", sm, card, time.perf_counter() - t0)
        n_imm, n_lm, imm_in_mask, lm_in_mask = sm["masked_points"]
        log(f"[track-masked] rows >= {paths.MASK_FIRST_INVALID_ROW} masked: {n_imm} valid immature"
            f" points ({imm_in_mask} in the masked rows), {n_lm} valid landmarks ({lm_in_mask}"
            " in the masked rows)")
        require(n_imm > 0 and n_lm > 0, "the masked path ends with no points")
        require(imm_in_mask == 0 and lm_in_mask == 0,
                f"{imm_in_mask} immature points and {lm_in_mask} landmarks in the masked rows")
        require(sm["ate_rmse"] < RMSE_GATE,
                f"masked ATE RMSE {sm['ate_rmse']:.5f} m >= {RMSE_GATE}")
        require(sm["ate_max"] < MAX_GATE, f"masked ATE max {sm['ate_max']:.5f} m >= {MAX_GATE}")
        require(abs(sm["scale"] - 1.0) < SCALE_GATE, f"masked alignment scale {sm['scale']:.4f}")

        # the ledger path: one rendering in f64, the card's f32 run and the
        # plain versions' f64 run on the CPU on the same frames
        t0 = time.perf_counter()
        seq64 = paths.render_path("ledger", torch.float64, "cpu")
        seq_card = dataclasses.replace(seq64, images=seq64.images.to("cuda", torch.float32))
        log(f"[render-ledger] {paths.SEQUENCES['ledger']}, {paths.SIZES['ledger']}"
            f" ({time.perf_counter() - t0:.2f} s)")
        t0 = time.perf_counter()
        sl, _ = track(seq_card, "ledger", torch, kernels)
        report("track-ledger", sl, card, time.perf_counter() - t0)
        ref = track_reference(seq64, "ledger", torch)
        log(f"[track-ledger] float64 on the CPU (plain versions, {LEDGER_CPU_THREADS}"
            f" threads): {ref['keyframes']} keyframes, {ref['marginalized']} marginalized,"
            f" trajectory RMSE {ref['trajectory_rmse']:.5f} m over"
            f" {ref['trajectory_entries']} entries (per-frame poses {ref['rmse']:.5f} m) in"
            f" {ref['seconds']:.2f} s; the card in f32: {sl['marginalized']} marginalized,"
            f" trajectory RMSE {sl['trajectory_rmse']:.5f} m over {sl['trajectory_entries']}"
            f" entries (per-frame poses {sl['rmse']:.5f} m)")
        frames = paths.path_frames("ledger")
        for run, st_run in (("card f32", sl), ("CPU f64", ref)):
            require(st_run["marginalized"] >= LEDGER_MIN_FOLDS,
                    f"ledger ({run}): only {st_run['marginalized']} marginalized keyframes")
            require(st_run["trajectory_entries"] >= frames - paths.INIT_FRAMES - 2,
                    f"ledger ({run}): {st_run['trajectory_entries']} trajectory entries")
        # the gates read the BA-refined trajectory, as the drift test does; the
        # f64 run's own RMSE is printed, not gated: it moves by ~0.15 m with the
        # host's CPU and BLAS (PERF.md), with no code of the port changed
        require(sl["trajectory_rmse"] < LEDGER_RMSE_GATE,
                f"ledger (card f32): trajectory RMSE {sl['trajectory_rmse']:.5f} m >="
                f" {LEDGER_RMSE_GATE}")
        require(sl["trajectory_rmse"] < ref["trajectory_rmse"] + LEDGER_MARGIN,
                f"ledger: card trajectory RMSE {sl['trajectory_rmse']:.5f} m >= f64"
                f" {ref['trajectory_rmse']:.5f} + {LEDGER_MARGIN}")
        for label, st_run in (("track", st), ("track-fast", sf), ("track-dense", sd),
                              ("track-masked", sm), ("track-ledger", sl)):
            require(st_run["counts"]["photometric_correct"] == 0,
                    f"[{label}] K18 launched on a path with no camera")

        ss = sensor(seq, torch, kernels, card)
        require(ss["ate_rmse"] < RMSE_GATE, f"sensor ATE RMSE {ss['ate_rmse']:.5f} m >= {RMSE_GATE}")
        require(ss["ate_max"] < MAX_GATE, f"sensor ATE max {ss['ate_max']:.5f} m >= {MAX_GATE}")
        require(abs(ss["scale"] - 1.0) < SCALE_GATE, f"sensor alignment scale {ss['scale']:.4f}")
        undistort(seq, torch, card)
        e2e(torch, card, exposure=False)
        e2e(torch, card, exposure=True)
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    result = {"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
             launches=sum(run["counts"][name] for run in (st, sf, sd, sm, sl, ss)),
             launches_track=st["counts"][name], launches_track_fast=sf["counts"][name],
             launches_track_dense=sd["counts"][name], launches_track_masked=sm["counts"][name],
             launches_track_ledger=sl["counts"][name], launches_track_sensor=ss["counts"][name],
             **rows[name]) for name in SOURCES]}
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
