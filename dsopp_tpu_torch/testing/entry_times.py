"""The calls of K5 (the flow statistic with the keyframe decision) and of
K14's pairing (with the refinement's glue) on the inputs of
``testing/bits.py``'s ``frame`` case, timed on the card, in this tree or in a
tree before their one-call entries (copy this file and ``bits.py`` into that
tree's ``dsopp_tpu_torch/testing`` and run it there), so that the two can be
compared inside one card call.

    python -m dsopp_tpu_torch.testing.entry_times [out.json]

Per tracker of ``bits.FRAME_TRACKERS`` (the pairing on the three with a
pushed keyframe, with and without the refinement), each the mean of
``REPS`` calls between CUDA events after warm calls
(``parity.cuda_ms``), and the profiler's device time and device kernels of
one call (``profiling.profiled``):

* ``k5_call``: the kernel's wrapper as the regular tick calls it (this tree:
  ``frame_statistics_cuda``; before: ``mean_square_flows_cuda``);
* ``k5_chain``: the flows with the gate and the decision
  (``bits.statistics``; this tree: the call and a view of its
  output; before: the wrapper, its two views, and the decision's torch
  operators);
* ``pairing``: the pairing after the activation and the refinement (this
  tree: one call; before: the glue's five operators and the wrapper, its
  five clones, memset, kernel and indexing).

Prints one JSON object with the card's name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import json
import sys

import torch

from dsopp_tpu_torch.testing import bits
from dsopp_tpu_torch.testing.parity import cuda_ms
from dsopp_tpu_torch.testing.paths import card_line
from dsopp_tpu_torch.testing.profiling import profiled

REPS = 200


def device_work(fn, reps: int = 20) -> dict:
    """The profiler's device µs of one call of ``fn`` and the names of the
    device kernels (and copies, memsets) it runs."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with profiled(acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = sorted({e.name for e in events})
    return dict(device_us=sum(e.time_range.elapsed_us() for e in events) / reps,
                device_events_per_call=len(events) / reps, device_names=names)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("entry_times: no CUDA device", file=sys.stderr)
        return 2
    from dsopp_tpu_torch.tracker import depth_map as dm
    one_call = bits.one_call_tree()
    f32 = dict(dtype=torch.float32, device="cuda")
    decision = (torch.tensor(1.0, **f32), torch.tensor(50, dtype=torch.int32, device="cuda"),
                torch.tensor(1.0, **f32), torch.tensor(0.5, **f32), 1.25, False)

    def k5_call(pts, model, t, mat):
        if one_call:
            return dm.frame_statistics_cuda(pts, model, t, mat, *decision)
        return dm.mean_square_flows_cuda(pts, model, t)

    def k5_chain(pts, model, t, mat):
        return bits.statistics(pts, model, t, mat, *decision)

    out = dict(tree="one call" if one_call else "before", card=card_line(), trackers={})
    for name, case in bits.frame_inputs().items():
        args = case["flow"]
        row = dict(k5_call_ms=cuda_ms(lambda: k5_call(*args), REPS),
                   k5_chain_ms=cuda_ms(lambda: k5_chain(*args), REPS),
                   k5_call=device_work(lambda: k5_call(*args)),
                   k5_chain=device_work(lambda: k5_chain(*args)))
        if case["keyframe"] is not None:
            win, imm, model, spacing = case["keyframe"]
            for refine in (False, True):
                inputs = bits.pairing_inputs(win, imm, model, spacing, refine)
                label = "refined" if refine else "unrefined"
                row[f"pairing_{label}_ms"] = cuda_ms(
                    lambda: bits.pairing_call(win, imm, *inputs), REPS)
                row[f"pairing_{label}"] = device_work(
                    lambda: bits.pairing_call(win, imm, *inputs))
        out["trackers"][name] = row
    print(json.dumps(out), flush=True)
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
