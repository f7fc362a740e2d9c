"""How often a ``torch.profiler`` session loses device records, with and
without :mod:`testing.profiling`'s pause at its start.

    python -m dsopp_tpu_torch.testing.profiler_loss [out.json]

Two kinds of session, each ``SESSIONS`` times with no pause and with
``profiling.LEAD_S``: one launch of the row gather (``gather``: a session is
lossy when it holds no device record), and ``SOLVES`` one-call BA solves on
the dense parity window of ``testing/bits.py``'s ``solve`` case (``solve``:
lossy when it holds fewer device records than the largest session of its kind; for
each lossy one, whether what it kept is the head or the tail of that
session's kernel sequence).  Prints one JSON object with the card's name
and power limit, and writes it to ``out.json`` when given.  Needs a CUDA
card.
"""

from __future__ import annotations

import json
import sys

import torch

from dsopp_tpu_torch.testing import profiling

SESSIONS = {"gather": 300, "solve": 40}
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


def main(argv):
    if not torch.cuda.is_available():
        print("profiler_loss: no CUDA device", file=sys.stderr)
        return 2
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing import bits, gather_probe
    from dsopp_tpu_torch.testing.paths import card_line

    table, _, idx = gather_probe.probe_inputs("cuda")
    window, model, opts = bits.solve_inputs()["dense/own"]
    cases = {"gather": (lambda: gather_probe.row_gather_cuda(table, idx), 1),
             "solve": (lambda: pba._solve_loop_cuda(window, model, opts), SOLVES)}
    out = dict(card=card_line(), lead_s=profiling.LEAD_S)
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
