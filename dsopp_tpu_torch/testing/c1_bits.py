"""The single-channel (C = 1) outputs of the kernels that the channel axis
reaches, and the tracks of the card's paths, to compare two trees of the
port bit for bit on one card.

    python -m dsopp_tpu_torch.testing.c1_bits out.pt [--paths]
    python -m dsopp_tpu_torch.testing.c1_bits --compare a.pt b.pt

The kernel outputs (:func:`kernel_outputs`): K1's pyramid of frame 6 of the
standart corridor; K3 on the 5 base hypotheses of frame 6 down the levels
(each level from the kernel's result at the level above); then, on
``chip_smoke.py``'s two BA parity windows (``linearize_bits.make_inputs``:
the standart and the dense point after the bootstrap and 14 known-pose
frames, moved off their linearization point as ``chip_smoke.py`` moves them),
K7's evaluation, K8's system with and without the marginalization pass
(``linearize_bits.linearize``), K10's solve with an empty ledger and with
the window's own, and K11's statuses.  The windows come from the tracker's
own keyframe pushes, so K4, K5 and K12–K16 have shaped them too.  With
``--paths`` the file also holds, for every path of ``testing/paths.py`` but
the embedder's, the tracked positions of its frames after the bootstrap and
which of them became keyframes (the sensor path through the camera's files).

The kernel outputs' sha256 digests (:func:`digests`) go to
``out.digests.json``; ``chip_smoke.py`` holds a run to ``PARENT_DIGESTS``.
``--compare`` prints the entries whose values differ (-1: another count) and
exits non-zero when any does.
Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import tempfile

import torch

TRACKED_PATHS = ("standart", "fast", "dense", "masked", "ledger", "sensor")

# sha256 of kernel_outputs() in the tree before the channel axis (d43a5d3), on
# an NVIDIA H100 80GB HBM3; chip_smoke.py requires the same
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "c1_parent_digests.json")) as _f:
    PARENT_DIGESTS: dict = json.load(_f)


def kernel_outputs() -> dict:
    """{name: tensor} of the kernels' C = 1 outputs on fixed inputs."""
    from dsopp_tpu_torch.core.camera import Pinhole
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.features.pyramid import build_pyramid_maps_cuda
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.solvers import pose_alignment as pa
    from dsopp_tpu_torch.testing import linearize_bits
    from dsopp_tpu_torch.testing.paths import (INIT_FRAMES, bootstrap, path_config,
                                               render_path)
    from dsopp_tpu_torch.tracker.fused_tick import CHUNK, _initialization_hypotheses

    seq = render_path("standart")
    tracker = bootstrap(seq, path_config("standart"))
    maps = build_pyramid_maps_cuda(seq.images[INIT_FRAMES].contiguous(), 5)
    out = {f"K1/level{lvl}": m for lvl, m in enumerate(maps)}
    kf = tracker._kf_pose()
    hyps = _initialization_hypotheses(tracker.t_w_last, tracker.t_prev_rel, kf, True)
    hyps = SE3(hyps.q[:CHUNK], hyps.t[:CHUNK])
    t = hyps.inverse().compose(SE3(kf.q.expand(CHUNK, 4), kf.t.expand(CHUNK, 3)))
    aff = tracker.last_affine.expand(CHUNK, 2).contiguous()
    ratio = torch.tensor(1.0, device="cuda")
    for lvl in range(4, -1, -1):
        res = pa.align_level_cuda(tracker.level_points[lvl], maps[lvl], tracker.models[lvl],
                                  SE3(t.q.contiguous(), t.t.contiguous()), aff.contiguous(),
                                  tracker.last_affine, ratio, tracker.align_opts)
        for field, v in res._asdict().items():
            for i, x in enumerate((v.q, v.t) if field == "t_t_r" else (v,)):
                out[f"K3/level{lvl}/{field}{i}"] = x
        t, aff = res.t_t_r, res.affine
    # chip_smoke's BA parity windows, moved, with K7's evaluation of them
    for name, case in linearize_bits.make_inputs().items():
        win, model = pba.Window(**case["window"]), Pinhole(**case["model"])
        opts, eps, idepth = pba.PBAOptions(**case["opts"]), case["eps"], case["idepth"]
        lm_mask = pba.active_lm_mask(win)
        for field in ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "res_status", "t_lin_q",
                      "t_lin_t", "affine0", "h_marg"):
            out[f"{name}/window/{field}"] = getattr(win, field)
        for field, v in case["ev"].items():
            out[f"{name}/K7/{field}"] = v
        for run, sys_k in linearize_bits.linearize(case).items():
            for field, v in sys_k.items():
                out[f"{name}/K8/{run}/{field}"] = v
        moved = win.replace(eps=eps, lm_idepth=idepth)
        empty = moved.replace(h_marg=torch.zeros_like(win.h_marg),
                              b_marg=torch.zeros_like(win.b_marg),
                              energy_marg=torch.zeros_like(win.energy_marg))
        for ledger, start in (("empty", empty), ("own", moved)):
            res, energy, count = pba._solve_loop_cuda(start, model, opts)
            for field in ("t_lin_q", "t_lin_t", "affine0", "eps", "lm_idepth", "res_status",
                          "lm_outlier", "lm_inliers", "lm_baseline"):
                out[f"{name}/K10/{ledger}/{field}"] = getattr(res, field)
            out[f"{name}/K10/{ledger}/energy"] = energy.reshape(1)
            out[f"{name}/K10/{ledger}/count"] = count.reshape(1)
        ps = pba._point_status_from_ev_cuda(moved, pba.Evaluation(**case["ev"]), lm_mask, opts)
        for field, v in ps._asdict().items():
            out[f"{name}/K11/{field}"] = v
    torch.cuda.synchronize()
    return {key: v.detach().clone() for key, v in out.items()}


def path_tracks() -> dict:
    """{path/positions, path/keyframes} of every path but the embedder's."""
    from dsopp_tpu_torch.testing import paths
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker

    out = {}
    seqs = {}
    for name in TRACKED_PATHS:
        seq_name = paths.PATHS[name][0]
        if seq_name == "ledger" and seq_name not in seqs:
            # chip_smoke.py renders the ledger path in f64 on the CPU
            s64 = paths.render_path(name, torch.float64, "cpu")
            seqs[seq_name] = dataclasses.replace(s64, images=s64.images.to("cuda", torch.float32))
        elif seq_name not in seqs:
            seqs[seq_name] = paths.render_path(name)
        seq = seqs[seq_name]
        cfg = paths.path_config(name)
        with tempfile.TemporaryDirectory() as folder:
            camera = None
            if name == "sensor":
                params, _ = paths.write_sensor_folder(seq, folder)
                camera = paths.sensor_camera(folder, params)
                tracker = paths.sensor_bootstrap(camera, seq, cfg)
            else:
                tracker = paths.bootstrap(seq, cfg, paths.path_mask(name))
            pipe = PipelinedTracker(tracker, flush_every=16)
            poses, kfs = [], []
            for i in range(paths.INIT_FRAMES, paths.path_frames(name)):
                if camera is None:
                    diag = pipe.tick(i, float(seq.timestamps[i]), seq.images[i])
                else:
                    frame = camera.next_frame()
                    diag = pipe.tick(i, frame.timestamp, frame.image,
                                     semantics=frame.semantics, exposure=frame.exposure)
                poses.append(diag.pose_t)
                kfs.append(bool(diag.is_keyframe))
            pipe.finalize()
        out[f"{name}/positions"] = torch.stack(poses).clone()
        out[f"{name}/keyframes"] = torch.tensor(kfs)
    torch.cuda.synchronize()
    return out


def digests(outputs: dict) -> dict:
    """{name: sha256 of the flattened tensor's bytes}."""
    return {key: hashlib.sha256(v.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
                                .numpy().tobytes()).hexdigest()
            for key, v in sorted(outputs.items())}


def compare(a: dict, b: dict) -> dict:
    """{entry: values that differ} over the entries of ``a`` (-1: another
    count of values or an entry missing from ``b``); tensors compare flat, so
    a channel axis of size 1 does not count."""
    report = {}
    for key, x in a.items():
        y = b.get(key)
        if y is None or x.numel() != y.numel():
            report[key] = -1
            continue
        x, y = x.reshape(-1), y.reshape(-1)
        if x.is_floating_point():
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
        else:
            same = x == y
        report[key] = int((~same).sum())
    return report


def main(argv) -> int:
    if argv[1:2] == ["--compare"]:
        report = compare(torch.load(argv[2]), torch.load(argv[3]))
        differ = {key: v for key, v in report.items() if v}
        print(json.dumps(dict(entries=len(report), differ=differ)))
        return 1 if differ else 0
    if not torch.cuda.is_available():
        print("c1_bits: no CUDA device", file=sys.stderr)
        return 2
    out = kernel_outputs()
    os.makedirs(os.path.dirname(os.path.abspath(argv[1])), exist_ok=True)
    with open(os.path.splitext(argv[1])[0] + ".digests.json", "w") as f:
        json.dump(digests(out), f, indent=1)
    if "--paths" in argv[2:]:
        out.update(path_tracks())
    torch.save({key: v.cpu() for key, v in out.items()}, argv[1])
    print(f"c1_bits: {len(out)} entries -> {argv[1]}, kernel digests beside it")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
