"""Where kernel K15's device time goes, phase by phase, on the card.

    python -m dsopp_tpu_torch.testing.marg_phases [out.json]

``csrc/marg_fold.cu`` built with ``-DMARG_FOLD_STAMPS`` (a library of its
own under ``build/``, never the one the path loads) writes ``clock64()``
after a block barrier at each phase boundary of its one-block kernel, and
``%globaltimer`` at the first and the last stamp, which converts the cycles
to µs, and at four points of each Jacobi round (its start, the rotations
made, the vote, the update done), which split a round's time.  The phases
(:data:`PHASES`; a phase the build does not stamp is absent) are timed on the
filled-ledger windows of ``testing/bits.py``'s
``solve`` case at K = 10 (standart) and K = 17 (dense), in every flagging case
of ``parity.marg_cases`` that flags a frame; beside them the profiler's device
µs of each of K15's kernels in the library the path loads.  Also one
thread's latency of a dependent chain of each f64 operation a rotation makes
(``op_latency_kernel``).  Prints one JSON object with the card's name and
power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.testing import bits, parity
from dsopp_tpu_torch.testing.paths import card_line
from dsopp_tpu_torch.testing.profiling import profiled

# stamp i closes phase i (stamp 0 opens the kernel); csrc/marg_fold.cu kStamps
PHASES = ("fold and priors", "hs and the energy", "compaction", "Jacobi",
          "cutoff, X0 and the Newton step", "correction")
STAMPS = 8
ROUNDS = 512            # csrc/marg_fold.cu kRoundStamps
OPS = ("division", "sqrt", "hypot(1, x)", "reciprocal", "multiply-add (two roundings)")
WINDOWS = ("standart", "dense")
REPS = 20


def build():
    """The stamped library, with K15's entry bound as ``kernels.MARG_FOLD``
    binds it."""
    out_dir = kernels.BUILD_DIR / "marg_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "marg_fold_stamped.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DMARG_FOLD_STAMPS", "-shared",
                    "-I", str(kernels.CSRC), "-o", str(lib_path),
                    str(kernels.CSRC / "marg_fold.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.marg_fold.argtypes = kernels.MARG_FOLD.argtypes
    lib.marg_fold.restype = ctypes.c_int
    for name in ("marg_fold_stamps", "marg_fold_round_stamps", "marg_fold_op_latency"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def read_stamps(lib) -> list:
    raw = (ctypes.c_longlong * (STAMPS + 2))()
    if lib.marg_fold_stamps(raw) != 0:
        raise RuntimeError("marg_phases: reading the stamps failed")
    return list(raw)


def read_rounds(lib) -> list:
    raw = (ctypes.c_longlong * (ROUNDS * 4))()
    if lib.marg_fold_round_stamps(raw) != 0:
        raise RuntimeError("marg_phases: reading the round stamps failed")
    return [raw[4 * i:4 * i + 4] for i in range(ROUNDS)]


def round_split(rounds: list, ns_per_cycle: float) -> dict:
    """{rounds, rotating: count and mean µs of a round with a rotation and of
    one without, and of a rotating round's rotation, vote and update}."""
    rot = [r for r in rounds if r[0] and r[3]]
    idle = [r for r in rounds if r[0] and r[2] and not r[3]]

    def mean(rows, a, b):
        return sum(r[b] - r[a] for r in rows) / len(rows) * ns_per_cycle / 1e3 if rows else None

    return dict(rounds=len(rot) + len(idle), rotating=len(rot),
                rotating_round_us=mean(rot, 0, 3), idle_round_us=mean(idle, 0, 2),
                rotation_us=mean(rot, 0, 1), vote_us=mean(rot, 1, 2), update_us=mean(rot, 2, 3))


def phase_us(lib, fold) -> dict:
    """{phase: mean µs over ``REPS`` stamped launches}, and the Jacobi rounds
    of the last launch (:func:`round_split`)."""
    fold()
    torch.cuda.synchronize()
    read_stamps(lib)
    read_rounds(lib)
    sums: dict = {}
    split = {}
    for _ in range(REPS):
        fold()
        torch.cuda.synchronize()
        rounds = read_rounds(lib)
        raw = read_stamps(lib)
        clocks, (t0, t1) = raw[:STAMPS], raw[STAMPS:]
        set_at = [i for i in range(STAMPS) if clocks[i]]
        if len(set_at) < 2 or clocks[set_at[-1]] <= clocks[0]:
            continue
        ns_per_cycle = (t1 - t0) / (clocks[set_at[-1]] - clocks[0])
        split = round_split(rounds, ns_per_cycle)
        for a, b in zip(set_at, set_at[1:]):
            name = PHASES[b - 1]
            sums[name] = sums.get(name, 0.0) + (clocks[b] - clocks[a]) * ns_per_cycle / 1e3
        sums["stamped"] = sums.get("stamped", 0.0) + (t1 - t0) / 1e3
    out = {name: v / REPS for name, v in sums.items()}
    out["jacobi_rounds"] = split
    return out


def short(key: str) -> str:
    """A profiler key's function name (the key where it has none)."""
    found = re.search(r"(\w+)\(", key)
    return found.group(1) if found else key


def kernel_us(fold) -> dict:
    """{device kernel: mean µs a call} of ``fold`` over ``REPS`` calls."""
    fold()
    torch.cuda.synchronize()
    with profiled([torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fold()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / REPS for e in prof.key_averages()
            if e.self_device_time_total > 0}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("marg_phases: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    raw = (ctypes.c_longlong * len(OPS))()
    if lib.marg_fold_op_latency(raw) != 0:
        raise RuntimeError("marg_phases: the latency probe failed")
    result = {}
    for key, (start, model, opts) in bits.solve_inputs().items():
        name, ledger = key.split("/")
        if name not in WINDOWS or ledger == "empty":
            continue
        gen = torch.Generator(device="cuda").manual_seed(1)
        for case, slots in parity.marg_cases(start).items():
            w, perm = parity.marg_case(start, case, slots, gen)
            if not slots:
                continue
            fold = bits.marg_fold(w, model, perm, opts)
            row = dict(k=w.num_slots, flagged_rows=8 * len(slots), kernels=kernel_us(fold))
            row["kernels"] = {short(name): us for name, us in row["kernels"].items()}
            path_fn = kernels.MARG_FOLD._fn
            kernels.MARG_FOLD._fn = lib.marg_fold
            try:
                row["phases"] = phase_us(lib, fold)
            finally:
                kernels.MARG_FOLD._fn = path_fn
            result[f"{key}/{case}"] = row
    report = dict(card=card_line(), op_latency_cycles=dict(zip(OPS, raw)), cases=result)
    print(json.dumps(report))
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
