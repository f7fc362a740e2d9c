"""Kernel K4's outputs on fixed inputs, to compare two trees of the port bit
for bit on one card, and ``chip_smoke.py``'s hold on them.

    python -m dsopp_tpu_torch.testing.epipolar_bits inputs.pt out.pt
    python -m dsopp_tpu_torch.testing.epipolar_bits --compare a.pt b.pt

The inputs are the immature banks of ``linearize_bits``' two windows (the
standart point after the bootstrap and 14 known-pose frames, every second
one a keyframe; the dense point with every one a keyframe) and the next
frame at its ground-truth pose.  The first run, with no ``inputs.pt`` yet,
makes and saves them.  A tree whose K4 is the whole update
(``estimate_depths_cuda``) runs it and adds the relative poses its kernel
composed to ``inputs.pt``; a tree before that runs its chain: the relative
poses composed by torch as its regular tick did, the geometry in torch, the
sweep kernel and the update in torch; and, when ``inputs.pt`` holds a
kernel's relative poses, the same chain once more from those
("kernel_poses").  ``--compare a.pt b.pt`` prints, per window, the outputs
whose entries differ and in how many, and how many of those are pose ties:
equal to ``b``'s chain from the kernel's poses.  It exits non-zero when an
entry differs that is no pose tie.  ``out.digests.json`` beside ``out.pt``
holds the outputs' sha256 digests, which ``chip_smoke.py`` holds to
``epipolar_parent_digests.json``.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from dsopp_tpu_torch.testing.c1_bits import digests

BA_FRAMES = 14          # chip_smoke.py's known-pose frames after the bootstrap
WINDOWS = {"standart": 2, "dense": 1}   # path -> every how many frames a keyframe
OUTPUTS = ("idepth_min", "idepth_max", "status", "traced", "uniqueness", "search_interval")


def parent_digests() -> dict:
    """sha256 of :func:`run`'s outputs in the tree before K4 was the whole
    update (daee7e5: the relative poses and the geometry in torch, then the
    sweep kernel, then the update in torch), on an NVIDIA H100 80GB HBM3,
    from this file's inputs; ``<window>/kernel_poses/<output>`` from the
    relative poses this tree's kernel composes."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "epipolar_parent_digests.json")) as f:
        return json.load(f)


def check_against_parent(outputs: dict) -> dict:
    """{window/output: "equal" | "pose tie"} of this tree's outputs against
    :func:`parent_digests`; raises on an output equal to neither."""
    parent, verdict = parent_digests(), {}
    for key, digest in flat_digests(outputs).items():
        window, output = key.split("/")
        if digest == parent[key]:
            verdict[key] = "equal"
        elif digest == parent.get(f"{window}/kernel_poses/{output}"):
            verdict[key] = "pose tie"
        else:
            raise AssertionError(f"K4 {key}: differs from the parent chain's, also from its"
                                 " chain on this kernel's relative poses")
    return verdict


def make_inputs() -> dict:
    """{window: the banks, the next frame's level-0 map and pose, the
    window's poses, affines and exposures, the frame's affine, the camera}."""
    from dsopp_tpu_torch.features.pyramid import build_pyramid_maps
    from dsopp_tpu_torch.testing.paths import (INIT_FRAMES, bootstrap, path_config,
                                               render_path)
    seq = render_path("standart")
    out = {}
    frame = INIT_FRAMES + BA_FRAMES
    for name, every in WINDOWS.items():
        tracker = bootstrap(seq, path_config(name))
        for i in range(INIT_FRAMES, frame):
            tracker.tick(i, float(seq.timestamps[i]), seq.images[i],
                         known_pose=seq.pose(i, torch.float32),
                         force_keyframe=(i % every == every - 1))
        win = tracker.window
        poses = win.poses()
        pose = seq.pose(frame, torch.float32, "cuda")
        out[name] = dict(
            points=tracker.immature._asdict(),
            target_map=build_pyramid_maps(seq.images[frame].contiguous(), 1)[0],
            model=tracker.models[0]._asdict(), pose_q=pose.q.contiguous(),
            pose_t=pose.t.contiguous(), window_poses_q=poses.q, window_poses_t=poses.t,
            window_affines=win.affine(), affine_tgt=tracker.last_affine,
            exposure=torch.ones((), device="cuda"), window_exposures=win.exposure)
    torch.cuda.synchronize()
    return out


def _args(case: dict):
    from dsopp_tpu_torch.core.camera import Pinhole
    from dsopp_tpu_torch.tracker import depth_estimation as de
    return (de.ImmaturePoints(**case["points"]), case["target_map"], Pinhole(**case["model"]))


def run(inputs: dict) -> dict:
    """{window: {output: tensor}} of this tree's K4, and of its chain from a
    kernel's poses where ``inputs`` holds them and this tree has no such
    kernel.  In a tree with the one-call kernel the relative poses it
    composed go into ``inputs`` (``rel_pose``)."""
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.tracker import depth_estimation as de

    out = {}
    for name, case in inputs.items():
        points, target_map, model = _args(case)
        frame = (case["pose_q"], case["pose_t"], case["window_poses_q"],
                 case["window_poses_t"], case["window_affines"], case["affine_tgt"],
                 case["exposure"], case["window_exposures"])
        if hasattr(de, "estimate_depths_cuda"):
            k, n = points.valid.shape
            dbg = de.debug_buffers(k, n, "cuda")
            res = de.estimate_depths_cuda(points, target_map, model, *frame, 20.0, debug=dbg)
            out[name] = {key: getattr(res, key).clone() for key in OUTPUTS}
            case["rel_pose"] = dbg.rel_pose.clone()
            continue
        # a tree before: the regular tick's composition, then its estimate_depths
        q, t, wq, wt, aff, aff_tgt, exposure, wexp = frame
        ratio = exposure / torch.clamp(wexp, min=1e-12)
        k = wq.shape[0]
        t_inv = SE3(q, t).inverse()
        rel = SE3(t_inv.q.expand(k, 4), t_inv.t.expand(k, 3)).compose(SE3(wq, wt))
        runs = {name: (rel.q, rel.t)}
        if "rel_pose" in case:
            runs[f"{name}/kernel_poses"] = (case["rel_pose"][:, :4].contiguous(),
                                            case["rel_pose"][:, 4:].contiguous())
        for key, (rq, rt) in runs.items():
            res = de.estimate_depths(points, target_map, model, rq, rt, aff, aff_tgt, ratio, 20.0)
            out[key] = {field: getattr(res, field).clone() for field in OUTPUTS}
    torch.cuda.synchronize()
    return out


def flat_digests(outputs: dict) -> dict:
    """{window/output: sha256}."""
    return digests({f"{name}/{key}": v for name, d in outputs.items() for key, v in d.items()})


def compare(a: dict, b: dict) -> dict:
    """{window: {output: [entries that differ, of which pose ties]}} of ``a``
    against ``b`` (-1: another shape); a pose tie equals ``b``'s chain from
    the kernel's poses."""
    report = {}
    for name in a:
        if "/" in name:
            continue
        diff = {}
        for key, x in a[name].items():
            y = b[name][key]
            if x.shape != y.shape:
                diff[key] = [-1, 0]
                continue
            differ = ~((x == y) | (torch.isnan(x) & torch.isnan(y))
                       if x.is_floating_point() else x == y)
            ties = 0
            alt = b.get(f"{name}/kernel_poses", {}).get(key)
            if alt is not None and int(differ.sum()):
                same_alt = (x == alt) | (torch.isnan(x) & torch.isnan(alt)) \
                    if x.is_floating_point() else x == alt
                ties = int((differ & same_alt).sum())
            diff[key] = [int(differ.sum()), ties]
        report[name] = diff
    return report


def main(argv) -> int:
    if argv[1:2] == ["--compare"]:
        report = compare(torch.load(argv[2]), torch.load(argv[3]))
        print(json.dumps(report))
        return 1 if any(n != t for d in report.values() for n, t in d.values()) else 0
    if not torch.cuda.is_available():
        print("epipolar_bits: no CUDA device", file=sys.stderr)
        return 2
    inputs_path, out_path = argv[1], argv[2]
    if not os.path.exists(inputs_path):
        torch.save(make_inputs(), inputs_path)
    inputs = torch.load(inputs_path)
    out = run(inputs)
    if any("rel_pose" in case for case in inputs.values()):
        torch.save(inputs, inputs_path)
    torch.save({name: {k: v.cpu() for k, v in d.items()} for name, d in out.items()}, out_path)
    with open(os.path.splitext(out_path)[0] + ".digests.json", "w") as f:
        json.dump(flat_digests(out), f, indent=1)
    print(f"epipolar_bits: K4 on {', '.join(out)} -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
