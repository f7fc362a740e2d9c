#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dsopp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each with its time:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — compile the hand-written kernels of ``dsopp_tpu_torch/csrc``
   (into ``build/dsopp_tpu_torch``, ignored by git);
3. render — the bench's corridor sequence: 120 frames, 480×640, focal 520;
4. parity — each kernel against its plain PyTorch version, f32 on the card,
   at the shapes the main path gives it (inputs from a bootstrapped tracker);
5. track — the main path: a 6-frame known-pose bootstrap, then
   ``PipelinedTracker`` over frames 6..119 at the bench's standart.yaml
   operating point; every kernel must have launched, ≥3 keyframes and ≥1
   marginalization must happen, and the per-frame translation error
   against ground truth after a similarity alignment (the monocular ATE of
   ``dsopp_tpu/output/ate.py``) must stay within the JAX package's
   end-to-end gates, RMSE < 2.2e-2 m and max < 3.5e-2 m, with the
   alignment's scale within 10 % of 1 (the known-pose bootstrap anchors
   it).  The error without alignment is printed beside it: monocular scale
   drifts by a few percent over the run, in the JAX package as in the port.

Then a JSON line of per-kernel results, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without that
line; so does a machine without a CUDA card.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HEIGHT, WIDTH, FOCAL = 480, 640, 520.0
NUM_FRAMES, INIT_FRAMES = 120, 6
RMSE_GATE, MAX_GATE, SCALE_GATE = 2.2e-2, 3.5e-2, 0.1
SOURCES = {
    "pyramid_maps": ("dsopp_tpu_torch/csrc/pyramid.cu",
                     "dsopp_tpu/features/pyramid.py:50"),
    "align_residual_system": ("dsopp_tpu_torch/csrc/align.cu",
                              "dsopp_tpu/solvers/pose_alignment.py:88"),
    "epipolar_sweep": ("dsopp_tpu_torch/csrc/epipolar.cu",
                       "dsopp_tpu/tracker/depth_estimation.py:107"),
}


class SmokeError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def standart_config(tracker_config):
    """bench.py::standart_config: standart.yaml at VGA."""
    return tracker_config(
        num_frame_slots=10, landmarks_per_frame=250, immature_per_frame=800,
        desired_points=2000, frontend_points=2000, keyframe_factor=1.25,
        window_min=5, window_max=8, use_rotation_perturbations=True)


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


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False, timeout=60)
    require(out.returncode == 0 and out.stdout.strip(), "nvidia-smi failed")
    return out.stdout.strip().splitlines()[0].strip()


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


def bootstrap(seq, cfg, torch, mono):
    tracker = mono.MonocularTracker(seq.camera, cfg, dtype=torch.float32, device="cuda")
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i],
                         seq.pose(i, torch.float32, "cuda")) for i in range(INIT_FRAMES)])
    return tracker


def parity(seq, cfg, torch, card):
    """Each kernel against its plain version on main-path inputs."""
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.features import pyramid
    from dsopp_tpu_torch.solvers import pose_alignment as pa
    from dsopp_tpu_torch.tracker import depth_estimation as de
    from dsopp_tpu_torch.tracker import monocular as mono
    from dsopp_tpu_torch.tracker.fused_tick import _initialization_hypotheses

    tracker = bootstrap(seq, cfg, torch, mono)
    img = seq.images[INIT_FRAMES].contiguous()
    rows = {}

    # K1 — pyramid of one VGA frame, 5 levels
    maps_k = pyramid.build_pyramid_maps_cuda(img, 5)
    maps_p = pyramid.build_pyramid_maps_plain(img, 5)
    err1 = max(float((a - b).abs().max()) for a, b in zip(maps_k, maps_p))
    require(err1 <= 1e-3, f"K1 max abs diff {err1} > 1e-3")
    rows["pyramid_maps"] = dict(
        max_abs_err=err1, ms=cuda_ms(torch, lambda: pyramid.build_pyramid_maps_cuda(img, 5)),
        plain_ms=cuda_ms(torch, lambda: pyramid.build_pyramid_maps_plain(img, 5)))
    log(f"  K1 pyramid_maps: 5 levels of 480x640, max abs diff {err1:.3g}")

    # K2 — the 5 base hypotheses against every level's frontend points
    kf = tracker._kf_pose()
    hyps = _initialization_hypotheses(tracker.t_w_last, tracker.t_prev_rel, kf, False)
    t = hyps.inverse().compose(SE3(kf.q.expand(5, 4), kf.t.expand(5, 3)))
    aff = tracker.last_affine.expand(5, 2).contiguous()
    ratio = torch.tensor(1.0, device="cuda")
    err2 = 0.0
    for lvl in range(5):
        args = (tracker.level_points[lvl], maps_k[lvl], tracker.models[lvl], t, aff,
                tracker.last_affine, ratio, 20.0)
        hk, bk, ek, nk = pa.residual_system_cuda(*args)
        hp, bp, ep, np_ = pa.residual_system_plain(*args)
        require(torch.equal(nk, np_), f"K2 level {lvl}: num_valid {nk.tolist()} vs {np_.tolist()}")
        rel_h = float(((hk - hp).norm(dim=(1, 2)) / hp.norm(dim=(1, 2)).clamp(min=1e-30)).max())
        rel_b = float(((bk - bp).norm(dim=1) / bp.norm(dim=1).clamp(min=1e-30)).max())
        rel_e = float(((ek - ep).abs() / ep.abs().clamp(min=1e-30)).max())
        require(rel_h <= 1e-4 and rel_b <= 1e-4 and rel_e <= 1e-5,
                f"K2 level {lvl}: rel H {rel_h:.3g} b {rel_b:.3g} energy {rel_e:.3g}")
        err2 = max(err2, float((hk - hp).abs().max()))
        log(f"  K2 level {lvl}: {int(nk.max())} valid of {tracker.level_points[lvl].uv.shape[0]},"
            f" rel H {rel_h:.2e} b {rel_b:.2e} energy {rel_e:.2e}")
    args0 = (tracker.level_points[0], maps_k[0], tracker.models[0], t, aff,
             tracker.last_affine, ratio, 20.0)
    rows["align_residual_system"] = dict(
        max_abs_err=err2, ms=cuda_ms(torch, lambda: pa.residual_system_cuda(*args0)),
        plain_ms=cuda_ms(torch, lambda: pa.residual_system_plain(*args0)))

    # K4 — every bank against the next frame at its ground-truth pose
    pose = seq.pose(INIT_FRAMES, torch.float32, "cuda")
    win = tracker.window
    k = win.num_slots
    t_inv = pose.inverse()
    t_rel = SE3(t_inv.q.expand(k, 4), t_inv.t.expand(k, 3)).compose(win.poses())
    ratios = torch.ones(k, device="cuda")
    inp, geo = de.sweep_inputs(tracker.immature, tracker.models[0], t_rel.q, t_rel.t,
                               win.affine(), tracker.last_affine, ratios)
    res_k = de.epipolar_sweep_cuda(inp, maps_k[0][0], tracker.models[0], 20.0)
    res_p = de.epipolar_sweep_plain(inp, maps_k[0][0], tracker.models[0], 20.0)
    act = inp.active
    n_act = int(act.sum())
    require(n_act > 0, "K4: no active immature points")
    same_best = float((res_k.best_idx == res_p.best_idx)[act].float().mean())
    up_k = de.update_from_sweep(tracker.immature, geo, res_k, tracker.models[0])
    up_p = de.update_from_sweep(tracker.immature, geo, res_p, tracker.models[0])
    act2 = act.reshape(up_k.status.shape)
    agree = (up_k.status == up_p.status) & act2
    same_status = float(agree.sum()) / n_act
    err4, rel4 = 0.0, 0.0
    for name in ("idepth_min", "idepth_max"):
        a, b = getattr(up_k, name)[agree], getattr(up_p, name)[agree]
        err4 = max(err4, float((a - b).abs().max()))
        rel4 = max(rel4, float(((a - b).abs() / b.abs().clamp(min=1e-6)).max()))
    log(f"  K4 epipolar_sweep: {n_act} active; best sample equal on {same_best:.5f}"
        f" ({int((res_k.best_idx != res_p.best_idx)[act].sum())} differ), status equal on"
        f" {same_status:.5f} ({n_act - int(agree.sum())} differ), idepth rel {rel4:.2e}")
    require(same_best >= 0.999, f"K4 best sample agreement {same_best}")
    require(same_status >= 0.995, f"K4 status agreement {same_status}")
    require(rel4 <= 1e-4, f"K4 idepth rel diff {rel4}")
    rows["epipolar_sweep"] = dict(
        max_abs_err=err4,
        ms=cuda_ms(torch, lambda: de.epipolar_sweep_cuda(inp, maps_k[0][0], tracker.models[0], 20.0)),
        plain_ms=cuda_ms(torch, lambda: de.epipolar_sweep_plain(inp, maps_k[0][0], tracker.models[0], 20.0)))
    for name, row in rows.items():
        log(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms | {card}")
    return rows


def track(seq, cfg, torch, kernels):
    """The main path: bootstrap + PipelinedTracker over the sequence."""
    from dsopp_tpu_torch.tracker import monocular as mono
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker

    kernels.reset_counts()
    tracker = bootstrap(seq, cfg, torch, mono)
    kf_boot = tracker.num_keyframes
    pipe = PipelinedTracker(tracker, flush_every=16)
    poses, escalations = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(INIT_FRAMES, NUM_FRAMES):
        diag = pipe.tick(i, float(seq.timestamps[i]), seq.images[i])
        poses.append(diag.pose_t)
        escalations += int(diag.escalated)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    pipe.finalize()
    counts = kernels.counts()
    est = torch.stack(poses).double().cpu().numpy()
    require(np.all(np.isfinite(est)), "non-finite tracked poses")
    gt = seq.poses_t[INIT_FRAMES:NUM_FRAMES]
    errs = np.linalg.norm(est - gt, axis=-1)
    aligned, scale = sim3_aligned_errors(est, gt)
    stats = dict(ate_rmse=float(np.sqrt(np.mean(aligned ** 2))), ate_max=float(aligned.max()),
                 scale=scale, frames=NUM_FRAMES - INIT_FRAMES, seconds=elapsed,
                 fps=(NUM_FRAMES - INIT_FRAMES) / elapsed,
                 keyframes=tracker.num_keyframes - kf_boot, escalations=escalations,
                 marginalized=len(tracker.track.marginalized),
                 rmse=float(np.sqrt(np.mean(errs ** 2))), max_err=float(errs.max()),
                 counts=counts)
    return stats


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
    from dsopp_tpu_torch.testing import render_sequence
    from dsopp_tpu_torch.tracker.monocular import TrackerConfig

    try:
        t0 = time.perf_counter()
        card = card_line()
        log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
            f"({time.perf_counter() - t0:.2f} s)")

        t0 = time.perf_counter()
        lib = kernels.build()
        kernels.library()
        log(f"[build] {lib.name} ({time.perf_counter() - t0:.2f} s)")

        t0 = time.perf_counter()
        seq = render_sequence(num_frames=NUM_FRAMES, height=HEIGHT, width=WIDTH, focal=FOCAL,
                              advance=0.08, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        require(bool(torch.isfinite(seq.images).all()), "render produced non-finite pixels")
        log(f"[render] {NUM_FRAMES} frames {HEIGHT}x{WIDTH} ({time.perf_counter() - t0:.2f} s)")

        cfg = standart_config(TrackerConfig)
        t0 = time.perf_counter()
        rows = parity(seq, cfg, torch, card)
        log(f"[parity] 3 kernels within tolerance ({time.perf_counter() - t0:.2f} s)")

        t0 = time.perf_counter()
        st = track(seq, cfg, torch, kernels)
        log(f"[track] {st['frames']} frames in {st['seconds']:.2f} s = {st['fps']:.3f} frames/s,"
            f" {st['keyframes']} keyframes, {st['escalations']} escalations,"
            f" {st['marginalized']} marginalized, aligned ATE RMSE {st['ate_rmse']:.5f} m"
            f" max {st['ate_max']:.5f} m (scale {st['scale']:.4f}), unaligned RMSE"
            f" {st['rmse']:.5f} m max {st['max_err']:.5f} m, launches {st['counts']} | {card}"
            f" ({time.perf_counter() - t0:.2f} s with bootstrap)")
        require(all(n > 0 for n in st["counts"].values()),
                f"a kernel of the path never launched: {st['counts']}")
        require(st["keyframes"] >= 3, f"only {st['keyframes']} keyframes after bootstrap")
        require(st["marginalized"] >= 1, "no frame was marginalized")
        require(st["ate_rmse"] < RMSE_GATE, f"ATE RMSE {st['ate_rmse']:.5f} m >= {RMSE_GATE}")
        require(st["ate_max"] < MAX_GATE, f"ATE max {st['ate_max']:.5f} m >= {MAX_GATE}")
        require(abs(st["scale"] - 1.0) < SCALE_GATE, f"alignment scale {st['scale']:.4f}")
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    result = {"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
             launches=st["counts"][name], **rows[name]) for name in SOURCES]}
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
