"""Aggregate frames/s of the batched tracker on the card
(``tracker/batched_loop.py``): B streams of the standart corridor (the
re-track armed), stream k bootstrapped on frames k..k+5 and fed the frames
after them, or with ``--replicated`` B copies of stream 0 (every keyframe on
the same tick), ticked in one ``BatchedPipelinedTracker``: ``--warm``
untimed ticks, then ``--ticks`` timed ones, synchronised at both ends, the
whole ``--repeats`` times in one process (each repeat a tracker bootstrapped
anew, so that the later ones run with the process's caches warm); then one
more tracker, ``--warm`` ticks and ``--ticks`` ticks each synchronised at its
end, with the allocator's peak reset before them → one JSON line: frames/s
and ms a tick of each repeat, the ticks that keyframed and how many sequences
keyframed on each, the synchronised ticks' mean ms by the number of
sequences that keyframed on them (0: a regular tick) and their device
memory peak (``torch.cuda.max_memory_allocated``, MB), the card's name and
power limit.

    python dsopp_tpu_torch/testing/batched_rate.py [--tree DIR] [--batch 4]
        [--warm 10] [--ticks 100] [--repeats 3] [--replicated]

Run it by its path: ``--tree DIR`` imports the package from DIR (for
example a ``git archive`` of a parent commit unpacked under ``build/``), so
that two trees compare on one card in one call (parent, change, change,
parent).  Only names both trees have are used.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None, help="import the package from this tree")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--warm", type=int, default=10)
    parser.add_argument("--ticks", type=int, default=100)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--replicated", action="store_true")
    args = parser.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tree = os.path.abspath(args.tree or here)
    sys.path.insert(0, tree)

    import torch
    if not torch.cuda.is_available():
        print("batched_rate: no CUDA device", file=sys.stderr)
        return 1
    import dsopp_tpu_torch
    from dsopp_tpu_torch.testing import batched as tb
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES, render_path, standart_config
    from dsopp_tpu_torch.tracker.batched_loop import BatchedPipelinedTracker

    if os.path.dirname(os.path.dirname(os.path.abspath(dsopp_tpu_torch.__file__))) != tree:
        print(f"batched_rate: imported {dsopp_tpu_torch.__file__}, not {tree}'s package",
              file=sys.stderr)
        return 1
    seq = render_path("standart")
    offsets = [0] * args.batch if args.replicated else list(range(args.batch))
    if max(offsets) + INIT_FRAMES + args.warm + args.ticks > seq.images.shape[0]:
        print("batched_rate: the corridor has too few frames", file=sys.stderr)
        return 1
    cfg = standart_config()
    fps, ms_per_tick = [], []
    for _ in range(args.repeats):
        pipe = BatchedPipelinedTracker([tb.offset_bootstrap(seq, cfg, k) for k in offsets],
                                       flush_every=16)

        def tick(j):
            fids = [k + INIT_FRAMES + j for k in offsets]
            return pipe.tick(fids, [float(seq.timestamps[f]) for f in fids],
                             torch.stack([seq.images[f] for f in fids]))

        for j in range(args.warm):
            tick(j)
        pipe.drain()
        torch.cuda.synchronize()
        keyframes = []
        t0 = time.perf_counter()
        for j in range(args.warm, args.warm + args.ticks):
            keyframes.append(tick(j).is_keyframe)
        pipe.drain()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fps.append(args.batch * args.ticks / seconds)
        ms_per_tick.append(1e3 * seconds / args.ticks)
    per_tick = collections.Counter(sum(kf) for kf in keyframes if any(kf))

    # each tick timed alone (synchronised), and the memory peak over them
    pipe = BatchedPipelinedTracker([tb.offset_bootstrap(seq, cfg, k) for k in offsets],
                                   flush_every=16)
    for j in range(args.warm):
        tick(j)
    pipe.drain()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    by_size = collections.defaultdict(list)
    for j in range(args.warm, args.warm + args.ticks):
        t0 = time.perf_counter()
        size = sum(tick(j).is_keyframe)
        torch.cuda.synchronize()
        by_size[size].append(1e3 * (time.perf_counter() - t0))
    pipe.drain()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    tick_ms = {size: dict(ticks=len(ms), mean_ms=sum(ms) / len(ms))
               for size, ms in sorted(by_size.items())}
    print(json.dumps(dict(
        tree=os.path.relpath(tree, here), batch=args.batch, replicated=args.replicated,
        warm=args.warm, ticks=args.ticks, fps=fps, ms_per_tick=ms_per_tick,
        keyframe_ticks=sum(per_tick.values()), keyframes=sum(sum(kf) for kf in keyframes),
        sequences_a_keyframe_tick=dict(sorted(per_tick.items())), synced_tick_ms=tick_ms,
        peak_mb=peak_mb, card=card_line())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
