"""Kernel K8's outputs on fixed inputs, to compare two trees of the port bit
for bit on one card.

    python -m dsopp_tpu_torch.testing.linearize_bits inputs.pt out.pt
    python -m dsopp_tpu_torch.testing.linearize_bits --compare a.pt b.pt

The inputs are ``chip_smoke.py``'s two BA parity windows (the standart point
after the bootstrap and 14 known-pose frames, every second one a keyframe;
the dense point with every one a keyframe), moved off their linearization
point as ``chip_smoke.py`` moves them, and kernel K7's evaluation of each.
The first run, with no ``inputs.pt`` yet, makes and saves them; every run
then writes K8's outputs with and without the marginalization pass on each
window to ``out.pt``.  In a tree whose K8 reads a cache of the FEJ Jacobians
(kernel K6, before K8 formed them itself), K6 makes the cache first: the
K6 → K8 chain.  ``--compare`` prints, per window and pass, the outputs that
differ and in how many entries, and exits non-zero when any does.  Needs a
CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

from dsopp_tpu_torch.core.camera import Pinhole
from dsopp_tpu_torch.solvers import pba

BA_FRAMES = 14          # chip_smoke.py's known-pose frames after the bootstrap
WINDOWS = {"standart": 2, "dense": 1}   # path -> every how many frames a keyframe


def make_inputs() -> dict:
    """{window: its fields, the camera, eps, idepth, K7's evaluation}, as
    ``chip_smoke.py::parity_ba`` builds them."""
    from dsopp_tpu_torch.testing.paths import (INIT_FRAMES, bootstrap, path_config,
                                               render_path)
    seq = render_path("standart")
    out = {}
    for name, every in WINDOWS.items():
        tracker = bootstrap(seq, path_config(name))
        for i in range(INIT_FRAMES, INIT_FRAMES + BA_FRAMES):
            tracker.tick(i, float(seq.timestamps[i]), seq.images[i],
                         known_pose=seq.pose(i, torch.float32),
                         force_keyframe=(i % every == every - 1))
        win, model, opts = tracker.window, tracker.models[0], tracker.pba_opts
        k, n = win.num_slots, win.num_landmark_slots
        gen = torch.Generator(device="cuda").manual_seed(0)
        step = torch.tensor([1e-3] * 6 + [5e-3, 0.3], device="cuda")
        eps = torch.randn((k, 8), generator=gen, device="cuda") * step
        eps = torch.where((win.frame_valid & ~win.frame_fixed)[:, None], eps,
                          torch.zeros_like(eps)).contiguous()
        idepth = (win.lm_idepth
                  * (1.0 + 0.01 * torch.randn((k, n), generator=gen, device="cuda"))).contiguous()
        ev = pba._evaluate_cuda(win, model, eps, idepth, pba.active_lm_mask(win), opts)
        out[name] = dict(window={f.name: getattr(win, f.name) for f in dataclasses.fields(win)},
                         model=model._asdict(), eps=eps, idepth=idepth, ev=ev._asdict(),
                         opts=opts._asdict())
    return out


def linearize(case: dict) -> dict:
    """K8's outputs on one window, with and without the marginalization pass."""
    win = pba.Window(**case["window"])
    model = Pinhole(**case["model"])
    ev = pba.Evaluation(**case["ev"])
    opts = pba.PBAOptions(**case["opts"])
    out = {}
    for marg_pass in (False, True):
        if hasattr(pba, "_fej_cache_cuda"):        # a tree with kernel K6's cache
            fej = pba._fej_cache_cuda(win, model)
            sys_k = pba._linearize_from_ev_cuda(win, fej, ev, case["eps"], opts, marg_pass)
        else:
            sys_k = pba._linearize_from_ev_cuda(win, model, ev, case["eps"], opts, marg_pass)
        out[f"marg_pass={marg_pass}"] = {name: t.clone() for name, t in sys_k._asdict().items()}
    torch.cuda.synchronize()
    return out


def compare(a: dict, b: dict) -> dict:
    """{window / pass: {output: entries that differ}} (-1: another shape)."""
    report = {}
    for name in a:
        for run in a[name]:
            diff = {}
            for out, x in a[name][run].items():
                y = b[name][run][out]
                if x.shape != y.shape:
                    diff[out] = -1
                else:
                    same = (x == y) | (torch.isnan(x) & torch.isnan(y))
                    diff[out] = int((~same).sum())
            report[f"{name} {run}"] = diff
    return report


def main(argv) -> int:
    if argv[1:2] == ["--compare"]:
        report = compare(torch.load(argv[2]), torch.load(argv[3]))
        print(json.dumps(report))
        return 1 if any(v for d in report.values() for v in d.values()) else 0
    if not torch.cuda.is_available():
        print("linearize_bits: no CUDA device", file=sys.stderr)
        return 2
    inputs_path, out_path = argv[1], argv[2]
    if not os.path.exists(inputs_path):
        torch.save(make_inputs(), inputs_path)
    inputs = torch.load(inputs_path)
    torch.save({name: linearize(case) for name, case in inputs.items()}, out_path)
    print(f"linearize_bits: K8 on {', '.join(inputs)} -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
