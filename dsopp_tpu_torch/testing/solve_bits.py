"""The windowed BA's whole solve (``pba._solve_loop_cuda``) on fixed inputs,
to compare two trees of the port bit for bit on one card, and
``chip_smoke.py``'s hold on them.

    python -m dsopp_tpu_torch.testing.solve_bits out.json

The inputs (:func:`make_inputs`) are the BA parity windows of
``chip_smoke.py``: the standart and the dense point (C = 1) and the embedder
point (C = 3), each after the 6-frame bootstrap and 14 known-pose frames
(every second one a keyframe; every one at the dense point), moved off their
linearization point as ``chip_smoke.py`` moves them.  Each is solved with an
empty ledger and with its own (``own``), or, where the window never
marginalized a frame, with a tenth of its own Schur-reduced system as K8
gives it (``scaled``, ``parity.scaled_ledger``).  The outputs
(:func:`run`) are every tensor field of the window the solve returns, its
energy and count, and the decoded iteration log (``log=``) as an f64 table of
(energy, λ, count, iteration, accept, done, relinearize) rows.

``out.json`` gets the sha256 digests of the inputs (``inputs/...``) and of
the outputs; :func:`check_against_parent` holds this tree's to
``solve_parent_digests.json``, the digests of the tree before the solve was
one C call (5f501a8: the loop launched from Python, the trial evaluation
copied over the carried one on accept), made on an NVIDIA H100 80GB HBM3.
Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

from dsopp_tpu_torch.testing.c1_bits import digests

BA_FRAMES = 14          # chip_smoke.py's known-pose frames after the bootstrap
# window -> (path, every how many frames a keyframe)
WINDOWS = {"standart": ("standart", 2), "dense": ("dense", 1), "embedder": ("embedder", 2)}
LOG_FIELDS = ("energy", "lam", "count", "it", "accept", "done", "relin")


def parent_digests() -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "solve_parent_digests.json")) as f:
        return json.load(f)


def make_inputs() -> dict:
    """{window/ledger: (the window to solve, the camera, the options)}."""
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing import parity
    from dsopp_tpu_torch.testing.paths import (INIT_FRAMES, bootstrap, path_config,
                                               render_path)
    seq = render_path("standart")
    out = {}
    for name, (path, every) in WINDOWS.items():
        tracker = bootstrap(seq, path_config(path))
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
        moved = win.replace(eps=eps, lm_idepth=idepth)
        out[f"{name}/empty"] = (moved.replace(h_marg=torch.zeros_like(win.h_marg),
                                              b_marg=torch.zeros_like(win.b_marg),
                                              energy_marg=torch.zeros_like(win.energy_marg)),
                                model, opts)
        if float(win.h_marg.abs().max()) > 0:
            out[f"{name}/own"] = (moved, model, opts)
        else:
            ev = pba._evaluate_cuda(moved, model, eps, idepth, pba.active_lm_mask(moved), opts)
            sys_k = pba._linearize_from_ev_cuda(moved, model, ev, eps, opts)
            out[f"{name}/scaled"] = (parity.scaled_ledger(moved, sys_k), model, opts)
    torch.cuda.synchronize()
    return out


def _fields(window) -> dict:
    return {f.name: getattr(window, f.name) for f in dataclasses.fields(window)
            if getattr(window, f.name) is not None}


def run(inputs: dict) -> dict:
    """{case/inputs/field, case/field, case/energy, case/count, case/log}: the
    inputs' fields and this tree's solve of each case."""
    from dsopp_tpu_torch.solvers import pba

    out = {}
    for case, (window, model, opts) in inputs.items():
        for field, v in _fields(window).items():
            out[f"{case}/inputs/{field}"] = v
        log = []
        res, energy, count = pba._solve_loop_cuda(window, model, opts, log=log)
        for field, v in _fields(res).items():
            out[f"{case}/{field}"] = v.clone()
        out[f"{case}/energy"] = energy.reshape(1).clone()
        out[f"{case}/count"] = count.reshape(1).clone()
        out[f"{case}/log"] = torch.tensor([[float(row[f]) for f in LOG_FIELDS] for row in log],
                                          dtype=torch.float64)
    torch.cuda.synchronize()
    return out


def check_against_parent(outputs: dict) -> list:
    """The keys whose digests differ from :func:`parent_digests` (or that one
    of the two lacks); empty when every output has the parent's bits."""
    got, parent = digests(outputs), parent_digests()
    return sorted(key for key in set(got) | set(parent) if got.get(key) != parent.get(key))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("solve_bits: no CUDA device", file=sys.stderr)
        return 2
    out = run(make_inputs())
    with open(argv[1], "w") as f:
        json.dump(digests(out), f, indent=1)
    cases = sorted({key.rsplit("/", 1)[0] for key in out if "/inputs/" not in key})
    print(f"solve_bits: {len(out)} digests of {', '.join(cases)} -> {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
