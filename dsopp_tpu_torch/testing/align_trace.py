"""Where K3's LM loop and its plain version decide differently, pass by pass.

    python -m dsopp_tpu_torch.testing.align_trace out.json

Runs both on the small scene of ``tests/test_torch_kernels_gpu.py`` (a
tracker bootstrapped on 6 known-pose frames at 240×320) with their decision
traces on: level 3 with the 5 base hypotheses, level 1 with all 109, level 0
with 5.  Prints every hypothesis whose accept/done sequence differs, with
both rows of the first pass that differs and the row of the plain version
run in f64 on the same inputs (how far f32 arithmetic moves an energy along
the same path), whether that decision was a rounding tie
(``parity.align_level_partings``) and how far apart the two end poses are;
writes the same and the whole traces of those hypotheses to
``out.json``.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys

import torch

from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features import pyramid
from dsopp_tpu_torch.solvers import pose_alignment as pa
from dsopp_tpu_torch.testing import parity
from dsopp_tpu_torch.testing.paths import card_line
from dsopp_tpu_torch.testing.synthetic import render_sequence
from dsopp_tpu_torch.tracker.fused_tick import _initialization_hypotheses
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig

# (level, hypotheses) of the cases; None = all
CASES = ((3, 5), (1, None), (0, 5))


def small_tracker(embedder: str = "identity"):
    """A tracker bootstrapped on 6 known-pose frames at 240×320 (every second
    one a keyframe), with the frame embedder ``embedder`` → (tracker, the next
    frame's pyramid)."""
    seq = render_sequence(num_frames=8, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    cfg = TrackerConfig(num_frame_slots=6, landmarks_per_frame=120, immature_per_frame=300,
                        desired_points=600, frontend_points=800, window_min=3, window_max=4,
                        embedder=embedder)
    tracker = MonocularTracker(seq.camera, cfg, dtype=torch.float32, device="cuda")
    for i in range(6):
        tracker.tick(i, float(seq.timestamps[i]), seq.images[i],
                     known_pose=seq.pose(i, torch.float32), force_keyframe=(i % 2 == 1))
    maps = pyramid.build_pyramid_maps(seq.images[6].contiguous(), cfg.pyramid_levels)
    return tracker, maps


def level_cases(tracker, maps, cases=CASES):
    """The arguments of ``align_level`` for every (level, hypotheses) case of
    ``cases``: the next frame's hypotheses (5 base ones, then the
    perturbations) at that level, the first ``hypotheses`` of them (None: all;
    negative: the last ones)."""
    kf = tracker._kf_pose()
    hyps = _initialization_hypotheses(tracker.t_w_last, tracker.t_prev_rel, kf, True)
    nb = hyps.q.shape[0]
    t = hyps.inverse().compose(SE3(kf.q.expand(nb, 4), kf.t.expand(nb, 3)))
    aff = tracker.last_affine.expand(nb, 2).contiguous()
    ratio = torch.tensor(1.0, device="cuda")
    for level, count in cases:
        take = slice(None) if count is None else (slice(count) if count > 0 else slice(count, None))
        yield level, (tracker.level_points[level], maps[level], tracker.models[level],
                      SE3(t.q[take].contiguous(), t.t[take].contiguous()),
                      aff[take].contiguous(), tracker.last_affine, ratio, tracker.align_opts)


def in_f64(args):
    """The arguments of ``align_level`` with every tensor on the CPU and every
    float tensor in f64 (there the plain loop builds its systems with the plain
    residual system; on the card it builds them with kernel K2)."""
    pts, pixel_map, model, t, aff, aff_ref, ratio, opts = args
    wide = lambda x: x.double().cpu()  # noqa: E731
    return (pa.LevelPoints(wide(pts.uv), wide(pts.idepth), wide(pts.intensity),
                           pts.valid.cpu()), wide(pixel_map), model,
            SE3(wide(t.q), wide(t.t)), wide(aff), wide(aff_ref), wide(ratio), opts)


def compare(args):
    """Both versions with their traces → (kernel's result, plain version's,
    the partings with their end-pose distance and whole traces, and the
    trace of the plain version in f64)."""
    trace_k, trace_p, trace_64 = [], [], []
    res_k = pa.align_level_cuda(*args, trace=trace_k)
    res_p = pa.align_level_plain(*args, trace=trace_p)
    pa.align_level_plain(*in_f64(args), trace=trace_64)
    partings = parity.align_level_partings(trace_k[0], trace_p[0], args[-1].function_tolerance)
    err = parity.align_level_errors(res_k, res_p)
    for p in partings:
        hyp = p["hypothesis"]
        p.update(iterations=[int(res_k.iterations[hyp]), int(res_p.iterations[hyp])],
                 energy=[float(res_k.energy[hyp]), float(res_p.energy[hyp])],
                 translation=float(err["translation"][hyp]),
                 rotation=float(err["rotation"][hyp]),
                 trace_kernel=[r for r in trace_k[0][hyp].tolist() if r[0] == r[0]],
                 trace_plain=[r for r in trace_p[0][hyp].tolist() if r[0] == r[0]],
                 trace_f64=[r for r in trace_64[0][hyp].tolist() if r[0] == r[0]])
    return res_k, res_p, partings


def replay(args, parting):
    """The pass before the parting and the parting pass again, each as one
    LM iteration of the kernel, the plain version and the plain version in
    f64 from one and the same state (the plain version's before that pass,
    with the trace's λ) → per pass the three trial energies: what f32
    arithmetic alone does to an energy within one iteration."""
    hyp, out = parting["hypothesis"], []
    pts, pixel_map, model, t, aff, aff_ref, ratio, opts = args
    start = (SE3(t.q[hyp:hyp + 1].contiguous(), t.t[hyp:hyp + 1].contiguous()),
             aff[hyp:hyp + 1].contiguous())
    for at in (parting["pass"] - 1, parting["pass"]):
        if at < 1 or at >= len(parting["trace_plain"]):
            continue
        head = (pts, pixel_map, model, *start, aff_ref, ratio)
        before = pa.align_level_plain(*head, opts._replace(max_iterations=at - 1))
        one = opts._replace(max_iterations=1, initial_regularizer=parting["trace_plain"][at][2])
        state = (pts, pixel_map, model,
                 SE3(before.t_t_r.q.contiguous(), before.t_t_r.t.contiguous()),
                 before.affine.contiguous(), aff_ref, ratio, one)
        traces = [], [], []
        pa.align_level_cuda(*state, trace=traces[0])
        pa.align_level_plain(*state, trace=traces[1])
        pa.align_level_plain(*in_f64(state), trace=traces[2])
        out.append({"pass": at, "energy_before": [float(tr[0][0, 0, 0]) for tr in traces],
                    "trial_energy": [float(tr[0][0, 1, 1]) for tr in traces]})
    return out


def main(argv):
    out = argv[1] if len(argv) > 1 else None
    card = card_line()
    tracker, maps = small_tracker()
    report = {"card": card, "tie": parity.ALIGN_TIE, "cases": []}
    fields = "energy before, trial energy, lambda before, |step|^2, accept + 2 done"
    for level, args in level_cases(tracker, maps):
        res_k, res_p, partings = compare(args)
        nb = int(res_k.iterations.shape[0])
        print(f"level {level}, {nb} hypotheses, {int(res_p.num_valid.max())} valid points:"
              f" {len(partings)} decide differently, {sum(p['tie'] for p in partings)} of them"
              f" at a rounding tie | {card}")
        for p in partings:
            p["replay"] = replay(args, p)
            f64 = p["trace_f64"][p["pass"]] if p["pass"] < len(p["trace_f64"]) else [float("nan")] * 5
            change = [(r[1] - r[0]) / r[0] for r in (p["kernel"], p["plain"], f64)]
            print(f"  hypothesis {p['hypothesis']} pass {p['pass']} ({fields}):\n"
                  f"    kernel {p['kernel']} relative change {change[0]:+.3e}\n"
                  f"    plain  {p['plain']} relative change {change[1]:+.3e}\n"
                  f"    f64    {f64} relative change {change[2]:+.3e}\n"
                  f"    tie {p['tie']}; replayed from one state (kernel, plain, f64):"
                  f" {p['replay']}\n"
                  f"    iterations {p['iterations']}, end energies"
                  f" {p['energy']}, end poses {p['translation']:.3e} m"
                  f" {p['rotation']:.3e} rad apart")
        trials = [r["trial_energy"] for p in partings for r in p["replay"]]
        if trials:
            far = [max(abs(e[i] - e[2]) / e[2] for e in trials) for i in (0, 1)]
            apart = max(abs(e[0] - e[1]) / e[1] for e in trials)
            print(f"  {len(trials)} single iterations from a common state: a trial energy is at"
                  f" most {far[0]:.3e} (kernel) and {far[1]:.3e} (plain) of itself from the f64"
                  f" one, kernel and plain at most {apart:.3e} apart")
        report["cases"].append({"level": level, "hypotheses": nb, "partings": partings})
    if out:
        with open(out, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
