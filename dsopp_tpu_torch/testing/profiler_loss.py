"""How often a ``torch.profiler`` session loses device records, with and
without :mod:`testing.profiling`'s pause at its start.

    python -m dsopp_tpu_torch.testing.profiler_loss [--tick] [out.json]

Two kinds of session, each ``SESSIONS`` times with no pause and with
``profiling.LEAD_S``: one launch of the row gather (``gather``: a session is
lossy when it holds no device record), and ``SOLVES`` one-call BA solves on
the dense parity window of ``testing/bits.py``'s ``solve`` case (``solve``:
lossy when it holds fewer device records than the largest session of its kind; for
each lossy one, whether what it kept is the head or the tail of that
session's kernel sequence).  With ``--tick``, instead: the batched regular
tick of ``chip_smoke.py``'s ``[batched]`` phase (the standart point on four
offset copies of the corridor) at B = 1 and B = 4, ``SESSIONS["tick"]``
sessions of one tick each, with no pause and with ``profiling.LEAD_S``;
each session's :func:`profiling.launch_records` (host launch calls, device
records, the unmatched ones on either side), and for a session whose device
records are not the most common count, the records it lacks and those it has
beyond that count's.  Prints one JSON object with the card's name and power
limit, and writes it to ``out.json`` when given.  Needs a CUDA card.
"""

from __future__ import annotations

import collections
import json
import sys

import torch

from dsopp_tpu_torch.testing import profiling

SESSIONS = {"gather": 300, "solve": 40, "tick": 40}
SOLVES = 20


def _device_names(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e.name for e in sorted((e for e in prof.events() if e.device_type == cuda),
                                   key=lambda e: e.time_range.start)]


def count_losses(fn, reps, sessions, lead_s):
    """Sessions of ``reps`` calls of ``fn`` → {sessions, lossy, kept}:
    ``kept`` per lossy session (records kept, of the full count, and which
    end of the sequence they are)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    runs = []
    for _ in range(sessions):
        with profiling.profiled(acts, lead_s) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        runs.append(_device_names(prof))
    full = max(runs, key=len)
    kept = [dict(records=len(r), of=len(full), tail=r == full[len(full) - len(r):],
                 head=r == full[:len(r)]) for r in runs if len(r) < len(full) or not r]
    return dict(sessions=sessions, lossy=len(kept), kept=kept)


def count_tick_records(args, sessions, lead_s):
    """``sessions`` profiled calls of ``fused_regular_tick(*args)`` → the
    counts of each :func:`profiling.launch_records` measure over the
    sessions, and the odd sessions' records against the most common."""
    from dsopp_tpu_torch.tracker.fused_tick import fused_regular_tick

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    runs = []
    for _ in range(sessions):
        with profiling.profiled(acts, lead_s) as prof:
            fused_regular_tick(*args)
            torch.cuda.synchronize()
        runs.append(profiling.launch_records(prof))
    tally = {key: collections.Counter(r[key] for r in runs)
             for key in ("host", "device", "unmatched_host", "unmatched_device", "complete")}
    common = tally["device"].most_common(1)[0][0]
    ref = next(r for r in runs if r["device"] == common)
    odd = [dict(host=r["host"], device=r["device"], threads=dict(r["threads"]), unmatched_host=r["unmatched_host"],
                unmatched_device=r["unmatched_device"],
                lacks=dict(ref["names"] - r["names"]), beyond=dict(r["names"] - ref["names"]),
                host_lacks=dict(ref["host_names"] - r["host_names"]),
                host_beyond=dict(r["host_names"] - ref["host_names"]))
           for r in runs if r["device"] != common or not r["complete"]]
    return dict(sessions=sessions, host_names=dict(ref["host_names"]),
                threads=dict(ref["threads"]),
                **{k: {str(v): n for v, n in c.items()} for k, c in tally.items()}, odd=odd)


def tick_case():
    """The batched regular tick's arguments at B = 1 and B = 4 (``[batched]``'s)."""
    from dsopp_tpu_torch.testing import batched, paths
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker

    seq = paths.render_path("standart")
    cfg = paths.standart_config()
    trackers = [batched.offset_bootstrap(seq, cfg, k) for k in range(4)]
    states = [PipelinedTracker(t).state for t in trackers]
    loop, models = trackers[0].loop_config(), trackers[0].models
    return {b: batched.regular_tick_args(
        states[:b], seq.images[paths.INIT_FRAMES:paths.INIT_FRAMES + b], models, loop)
        for b in (1, 4)}


def main(argv):
    if not torch.cuda.is_available():
        print("profiler_loss: no CUDA device", file=sys.stderr)
        return 2
    tick = "--tick" in argv
    argv = [a for a in argv if a != "--tick"]
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing import bits, gather_probe
    from dsopp_tpu_torch.testing.paths import card_line

    out = dict(card=card_line(), lead_s=profiling.LEAD_S)
    if tick:
        from dsopp_tpu_torch.tracker.fused_tick import fused_regular_tick

        for b, args in tick_case().items():
            fused_regular_tick(*args)
            torch.cuda.synchronize()
            for lead in (0.0, profiling.LEAD_S):
                out[f"tick B = {b}, pause {lead} s"] = count_tick_records(
                    args, SESSIONS["tick"], lead)
        cases = {}
    else:
        table, _, idx = gather_probe.probe_inputs("cuda")
        window, model, opts = bits.solve_inputs()["dense/own"]
        cases = {"gather": (lambda: gather_probe.row_gather_cuda(table, idx), 1),
                 "solve": (lambda: pba._solve_loop_cuda(window, model, opts), SOLVES)}
    for name, (fn, reps) in cases.items():
        fn()
        torch.cuda.synchronize()
        for lead in (0.0, profiling.LEAD_S):
            out[f"{name}, pause {lead} s"] = count_losses(fn, reps, SESSIONS[name], lead)
    print(json.dumps(out), flush=True)
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
