#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dsopp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each with its time:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — compile the hand-written kernels of ``dsopp_tpu_torch/csrc``
   (into ``build/dsopp_tpu_torch``, ignored by git), one ``nvcc`` per source,
   all started together;
3. render — the bench's corridor sequence: 120 frames, 480×640, focal 520;
4. parity — each of the seven kernels against its plain PyTorch version, f32
   on the card, at the shapes the main path gives it (inputs from a
   bootstrapped tracker), with its time, the plain version's time and the
   least time the card could take (bytes over 3.35 TB/s or f32 operations
   over 67 TFLOP/s, whichever is larger, counted from this run's inputs);
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
   that.

Then a JSON line of per-kernel results, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without that
line; so does a machine without a CUDA card.
"""

import json
import os
import sys
import time

import numpy as np

RMSE_GATE, MAX_GATE, SCALE_GATE, FAST_RMSE_GATE = 2.2e-2, 3.5e-2, 0.1, 3.0e-2
# published peaks of one H100 SXM: HBM bytes/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
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
    "ba_fej": ("dsopp_tpu_torch/csrc/ba_fej.cu", "dsopp_tpu/solvers/pba.py:257"),
    "ba_evaluate": ("dsopp_tpu_torch/csrc/ba_evaluate.cu", "dsopp_tpu/solvers/pba.py:315"),
    "ba_linearize_schur": ("dsopp_tpu_torch/csrc/ba_linearize.cu",
                           "dsopp_tpu/solvers/pba.py:431"),
}
# K2's own entry point is held in the parity phase only: on the main path its
# body runs inside K3 (align_level)
PATH_KERNELS = tuple(name for name in SOURCES if name != "align_residual_system")
# f32 operations per unit of work, counted from the kernels' arithmetic
OPS_ALIGN_POINT = 230       # K2/K3: one valid point of one hypothesis, one pass
OPS_ALIGN_SOLVE = 600       # K3: damped 8x8 LU solve + exp + compose, one iteration
OPS_EPIPOLAR_POINT = 6500   # K4: 32 samples x 8 pattern points + 4 GN steps
OPS_FEJ_RESIDUAL = 150      # K6
OPS_EVALUATE_RESIDUAL = 120  # K7
OPS_LINEARIZE_RESIDUAL = 910  # K8: 16 Jacobian columns, 272 + 18 multiply-adds


class SmokeError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps=50):
    """Mean device time of ``fn`` per call over ``reps`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(num_bytes, num_ops):
    """Least time of the work on the card → (ms, what bounds it)."""
    t_bytes, t_ops = num_bytes / PEAK_BYTES, num_ops / PEAK_FLOPS
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
        max_abs_err=err1, ms=cuda_ms(torch, lambda: pyramid.build_pyramid_maps_cuda(img, 5)),
        plain_ms=cuda_ms(torch, lambda: pyramid.build_pyramid_maps_plain(img, 5)),
        **bound(nbytes(img, *maps_k), 12 * sum(m[0].numel() for m in maps_k)),
        library_ms=None)
    log(f"  K1 pyramid_maps: 5 levels of {img.shape[0]}x{img.shape[1]}, max abs diff {err1:.3g}")

    parity_align(tracker, maps_k, torch, rows)
    parity_epipolar(seq, tracker, maps_k, torch, rows)
    parity_ba(seq, tracker, torch, rows)
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
        max_abs_err=err2, ms=cuda_ms(torch, lambda: pa.residual_system_cuda(*args0)),
        plain_ms=cuda_ms(torch, lambda: pa.residual_system_plain(*args0)),
        **bound(nbytes(*lp[0]) + sampled + CHUNK * 74 * 4, OPS_ALIGN_POINT * int(nv0.sum())),
        library_ms=None)

    # K3 — the base chunk down the levels (both versions start each level from
    # the plain version's result), then level 0 for the coarse winner
    def check_k3(label, res_k, res_p):
        err = par.align_level_errors(res_k, res_p)
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
        max_abs_err=err3, ms=cuda_ms(torch, lambda: pa.align_level_cuda(*args1)),
        plain_ms=cuda_ms(torch, lambda: pa.align_level_plain(*args1), reps=5),
        **bound(nbytes(*lp[1]) + sampled + CHUNK * 13 * 4, ops), library_ms=None)
    log(f"  K3 level 0, 1 hypothesis: kernel {cuda_ms(torch, lambda: pa.align_level_cuda(*args_l0)):.4f} ms,"
        f" plain {cuda_ms(torch, lambda: pa.align_level_plain(*args_l0), reps=5):.4f} ms;"
        f" level 1, {nb - CHUNK} hypotheses: kernel"
        f" {cuda_ms(torch, lambda: pa.align_level_cuda(*args105)):.4f} ms,"
        f" plain {cuda_ms(torch, lambda: pa.align_level_plain(*args105), reps=3):.4f} ms")


def iter_summary(res):
    it = res.iterations
    if it.numel() <= 5:
        return str(it.tolist())
    return f"{int(it.min())}..{int(it.max())} (mean {float(it.double().mean()):.1f})"


def parity_epipolar(seq, tracker, maps, torch, rows):
    """K4 — every bank against the next frame at its ground-truth pose."""
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES
    from dsopp_tpu_torch.tracker import depth_estimation as de

    pose = seq.pose(INIT_FRAMES, torch.float32, "cuda")
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
    log(f"  K4 worst point {worst}, as kernel / plain / plain in f64: " + "; ".join(
        f"{name} " + " / ".join(f"{float(x.flatten()[worst]):.7e}" for x in triple)
        for name, triple in (
            ("idepth_min", (up_k.idepth_min, up_p.idepth_min, up_64.idepth_min)),
            ("idepth_max", (up_k.idepth_max, up_p.idepth_max, up_64.idepth_max)),
            ("GN offset, px", (res_k.best_delta, res_p.best_delta, res64.best_delta)))))
    log(f"  K4 epipolar_sweep: {n_act} active; best sample equal on {same_best:.5f}"
        f" ({int((res_k.best_idx != res_p.best_idx)[act].sum())} differ), status equal on"
        f" {same_status:.5f} ({n_act - int(agree.sum())} differ), idepth rel {rel4:.2e}"
        f" abs {err4:.2e}; against the f64 sweep on {int(agree64.sum())} points: kernel"
        f" {rel_k64:.2e}, plain f32 {rel_p64:.2e}")
    require(same_best >= 0.999, f"K4 best sample agreement {same_best}")
    require(same_status >= 0.995, f"K4 status agreement {same_status}")
    require(rel4 <= 1e-4, f"K4 idepth rel diff {rel4}")
    sampled = min(nbytes(image), n_act * 32 * 8 * 16)
    rows["epipolar_sweep"] = dict(
        max_abs_err=err4,
        ms=cuda_ms(torch, lambda: de.epipolar_sweep_cuda(inp, image, tracker.models[0], 20.0)),
        plain_ms=cuda_ms(torch, lambda: de.epipolar_sweep_plain(inp, image, tracker.models[0], 20.0)),
        **bound(nbytes(*inp) + sampled + nbytes(*res_k), OPS_EPIPOLAR_POINT * n_act),
        library_ms=None)


def parity_ba(seq, tracker, torch, rows):
    """K6, K7, K8 on the window of the tracker after further known-pose
    keyframes (every second frame), moved off its linearization point."""
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing import parity as par
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES

    for i in range(INIT_FRAMES, INIT_FRAMES + 14):
        tracker.tick(i, float(seq.timestamps[i]), seq.images[i],
                     known_pose=seq.pose(i, torch.float32), force_keyframe=(i % 2 == 1))
    win, model, opts = tracker.window, tracker.models[0], tracker.pba_opts
    k, n = win.num_slots, win.num_landmark_slots
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
    log(f"  BA window: {int(win.frame_valid.sum())} of {k} frames, {int(lm_mask.sum())} landmarks,"
        f" {int(live.sum())} live (anchor, target, landmark) groups")
    require(int(win.frame_valid.sum()) >= 5, "the parity window holds fewer than 5 frames")

    # K6
    fej_k, fej_p = pba._fej_cache_cuda(win, model), pba._fej_cache_plain(win, model)
    err = par.fej_errors(fej_k, fej_p)
    log(f"  K6 ba_fej: {err}")
    require(err.pop("geom_valid_differ") == 0, "K6: geom_valid differs")
    require(max(err.values()) <= 1e-5, f"K6: relative error above 1e-5: {err}")
    win_in = (win.t_lin_q, win.t_lin_t, win.affine0, win.exposure, win.lm_uv, win.lm_idepth,
              win.lm_patch)
    rows["ba_fej"] = dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(fej_k[:5], fej_p[:5])),
        ms=cuda_ms(torch, lambda: pba._fej_cache_cuda(win, model)),
        plain_ms=cuda_ms(torch, lambda: pba._fej_cache_plain(win, model)),
        **bound(nbytes(*win_in) + nbytes(*fej_k), OPS_FEJ_RESIDUAL * residuals),
        library_ms=None)

    # K7
    ev_args = (win, model, eps, idepth, lm_mask, opts)
    ev_k, ev_p = pba._evaluate_cuda(*ev_args), pba._evaluate_plain(*ev_args)
    err = par.evaluation_errors(ev_k, ev_p, live)
    log(f"  K7 ba_evaluate: {err}")
    require(err["ok"] > 1000, f"K7: only {err['ok']} ok groups")
    require(err["agree"] >= 0.999, f"K7: ok/status agree on {err['agree']:.5f} of live groups")
    worst = max(err[name] for name in ("residuals", "gx", "gy", "energy_patch", "weight"))
    require(worst <= 1e-4, f"K7: relative error {worst:.3g} above 1e-4")
    both = (ev_k.ok & ev_p.ok)[..., None]
    # only a live group's 8 residuals need a sample of the target's image
    sampled = min(nbytes(win.maps) // 3, 48 * 8 * int(live.sum()))
    rows["ba_evaluate"] = dict(
        max_abs_err=float(torch.where(both, ev_k.residuals - ev_p.residuals,
                                      torch.zeros_like(ev_p.residuals)).abs().max()),
        ms=cuda_ms(torch, lambda: pba._evaluate_cuda(*ev_args)),
        plain_ms=cuda_ms(torch, lambda: pba._evaluate_plain(*ev_args)),
        **bound(nbytes(*win_in, eps, idepth, lm_mask, win.frame_valid, win.res_status)
                + sampled + nbytes(*ev_k), OPS_EVALUATE_RESIDUAL * 8 * int(live.sum())),
        library_ms=None)

    # K8, on the plain versions' cache and evaluation; also the marginalization pass
    err8 = 0.0
    for marg_pass in (False, True):
        sys_k = pba._linearize_from_ev_cuda(win, fej_p, ev_p, eps, opts, marg_pass)
        sys_p = pba._linearize_from_ev_plain(win, fej_p, ev_p, eps, opts, marg_pass)
        err = par.linear_system_errors(sys_k, sys_p)
        log(f"  K8 ba_linearize_schur marg_pass={marg_pass}: {err}")
        require(float(sys_p.h_schur.abs().max()) > 0, "K8: empty Schur complement")
        require(max(err.values()) <= 1e-4, f"K8: relative error above 1e-4: {err}")
        err8 = max(err8, float((sys_k.h_pose - sys_p.h_pose).abs().max()))
    kb = 8 * k
    rows["ba_linearize_schur"] = dict(
        max_abs_err=err8,
        ms=cuda_ms(torch, lambda: pba._linearize_from_ev_cuda(win, fej_p, ev_p, eps, opts)),
        plain_ms=cuda_ms(torch, lambda: pba._linearize_from_ev_plain(win, fej_p, ev_p, eps, opts)),
        **bound(nbytes(*fej_p, ev_p.residuals, ev_p.weight, ev_p.gx, ev_p.gy, ev_p.ok,
                       win.frame_fixed) + nbytes(*sys_k),
                OPS_LINEARIZE_RESIDUAL * 8 * int(ev_p.ok.sum())
                + 3 * int(lm_mask.sum()) * (kb * kb + kb)),
        library_ms=None)


def track(seq, cfg, torch, kernels):
    """One path: the known-pose bootstrap, then PipelinedTracker over the
    frames after it, with the launch counts set to 0 just before those
    frames and read just after (the bootstrap's launches do not count)."""
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES, bootstrap, closed_gate
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker, device_tick

    last = seq.images.shape[0]
    tracker = bootstrap(seq, cfg)
    kf_boot = tracker.num_keyframes
    pipe = PipelinedTracker(tracker, flush_every=16)
    poses, gate_ratios, escalations = [], [], 0
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    for i in range(INIT_FRAMES, last):
        state_before = pipe.state
        diag = pipe.tick(i, float(seq.timestamps[i]), seq.images[i])
        poses.append(diag.pose_t)
        gate_ratios.append(diag.rmse / state_before.rmse_last0)
        escalations += int(diag.escalated)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    pipe.finalize()
    counts = kernels.counts()
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
                 # a frame escalates at rmse >= 2.5 x the last reliable rmse; the first
                 # tracked frame has no reliable rmse before it yet
                 gate_ratio=float(torch.stack(gate_ratios[1:]).max()),
                 rmse=float(np.sqrt(np.mean(errs ** 2))), max_err=float(errs.max()),
                 counts=counts)

    def force_escalation():
        """The last frame again from the state before it, with the re-track
        gate closed: chunk 0 fails it and chunks 1..21 run.  → distance of
        the escalated pose from the tracked one."""
        before = kernels.ALIGN_LEVEL.launches
        _, diag = device_tick(closed_gate(state_before), seq.images[last - 1], last - 1, False, pipe.models, pipe.cfg)
        require(diag.escalated, "the forced frame did not escalate")
        require(kernels.ALIGN_LEVEL.launches - before == 10,
                f"an escalated frame launches K3 10 times, got {kernels.ALIGN_LEVEL.launches - before}")
        require(bool(torch.isfinite(diag.pose_t).all()), "non-finite escalated pose")
        return float((diag.pose_t - poses[-1]).norm())

    return stats, force_escalation


def report(label, st, card, seconds):
    log(f"[{label}] {st['frames']} frames in {st['seconds']:.2f} s = {st['fps']:.3f} frames/s,"
        f" {st['keyframes']} keyframes, {st['escalations']} escalations (largest rmse ratio"
        f" {st['gate_ratio']:.3f} of the gate's 2.5),"
        f" {st['marginalized']} marginalized, aligned ATE RMSE {st['ate_rmse']:.5f} m"
        f" max {st['ate_max']:.5f} m (scale {st['scale']:.4f}), unaligned RMSE"
        f" {st['rmse']:.5f} m max {st['max_err']:.5f} m, launches {st['counts']} | {card}"
        f" ({seconds:.2f} s with bootstrap)")
    missing = [name for name in PATH_KERNELS if st["counts"][name] == 0]
    require(not missing, f"[{label}] kernels of the path never launched: {missing}")
    require(st["keyframes"] >= 3, f"[{label}] only {st['keyframes']} keyframes after bootstrap")


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
        log(f"[render] {paths.PATHS['standart']}, {paths.HEIGHT}x{paths.WIDTH}"
            f" ({time.perf_counter() - t0:.2f} s)")

        cfg = paths.standart_config()
        t0 = time.perf_counter()
        rows = parity(seq, cfg, torch, card)
        require(set(rows) == set(SOURCES), f"parity rows {sorted(rows)}")
        log(f"[parity] {len(rows)} kernels within tolerance ({time.perf_counter() - t0:.2f} s)")

        t0 = time.perf_counter()
        st, _ = track(seq, cfg, torch, kernels)
        report("track", st, card, time.perf_counter() - t0)
        require(st["marginalized"] >= 1, "no frame was marginalized")
        require(st["ate_rmse"] < RMSE_GATE, f"ATE RMSE {st['ate_rmse']:.5f} m >= {RMSE_GATE}")
        require(st["ate_max"] < MAX_GATE, f"ATE max {st['ate_max']:.5f} m >= {MAX_GATE}")
        require(abs(st["scale"] - 1.0) < SCALE_GATE, f"alignment scale {st['scale']:.4f}")
        del seq

        t0 = time.perf_counter()
        fast = paths.render_path("fast")
        torch.cuda.synchronize()
        log(f"[render-fast] {paths.PATHS['fast']} ({time.perf_counter() - t0:.2f} s)")
        t0 = time.perf_counter()
        sf, force_escalation = track(fast, cfg, torch, kernels)
        report("track-fast", sf, card, time.perf_counter() - t0)
        if sf["escalations"] == 0:
            moved = force_escalation()
            log(f"[track-fast] no frame escalated by itself; the last frame, escalated through"
                f" device_tick, lands {moved:.5f} m from its tracked pose")
            require(moved < FAST_RMSE_GATE, f"the escalated pose is {moved:.5f} m off")
        require(sf["ate_rmse"] < FAST_RMSE_GATE,
                f"fast ATE RMSE {sf['ate_rmse']:.5f} m >= {FAST_RMSE_GATE}")
        require(abs(sf["scale"] - 1.0) < SCALE_GATE, f"fast alignment scale {sf['scale']:.4f}")
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    result = {"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
             launches=st["counts"][name] + sf["counts"][name],
             launches_track=st["counts"][name], launches_track_fast=sf["counts"][name],
             **rows[name]) for name in SOURCES]}
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
