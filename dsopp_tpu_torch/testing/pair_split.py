"""Where kernel K8's pair kernel spends its time: the kernel as it is, with
its FEJ arithmetic (``ba_body.cuh::fej_point``) replaced by a few products of
its inputs, and with its f64 tensor-core products removed, each built from
``csrc/ba_linearize.cu`` into a library of its own and timed on the two BA
windows of ``chip_smoke.py`` (``testing/linearize_bits.py``'s inputs).

    python -m dsopp_tpu_torch.testing.pair_split [out.json]

The two stand-ins compute other values (their outputs are not K8's): they
only show what the removed part costs.  Prints one JSON object (device µs a
launch of each of K8's four kernels, by variant and window, and the
differing output entries against the kernel as it is) with the card's name
and power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.camera import Pinhole
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.testing import linearize_bits
from dsopp_tpu_torch.testing.paths import card_line
from dsopp_tpu_torch.testing.profiling import profiled

FEJ_CALL = "    const ba::Fej f = ba::fej_point(cam, rel_s, u, v, d);\n"
FEJ_STAND_IN = """    ba::Fej f;
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      f.ref[c] = u * (float)(c + 1);
      f.tgt[c] = v * (float)(c + 1);
    }
    f.idepth[0] = d;
    f.idepth[1] = patch;
    f.valid = d > 0.0f;
"""
PRODUCTS_FIRST = "#pragma unroll\n      for (int step = 0; step < 2; ++step) {\n"
PRODUCTS_LAST = "        dmma(acc[2], a, b[2]);\n      }\n"
K8_KERNELS = ("pair_kernel", "landmark_kernel", "schur_kernel", "reduce_kernel")


def variants() -> dict:
    """{name: the source of ba_linearize.cu}; raises where the kernel's text
    no longer holds the parts the stand-ins replace."""
    src = (kernels.CSRC / "ba_linearize.cu").read_text()
    first = src.index(PRODUCTS_FIRST)
    last = src.index(PRODUCTS_LAST, first) + len(PRODUCTS_LAST)
    if src.count(FEJ_CALL) != 1:
        raise RuntimeError("pair_split: the FEJ call of pair_kernel changed")
    return {"as_is": src, "no_fej_arithmetic": src.replace(FEJ_CALL, FEJ_STAND_IN),
            "no_f64_products": src[:first] + src[last:]}


def build(name: str, src: str):
    """The variant's library with K8's entry bound as ``kernels.BA_LINEARIZE``
    binds it."""
    out_dir = kernels.BUILD_DIR / "pair_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.cu"
    path.write_text(src)
    lib_path = out_dir / f"{name}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC),
                    "-o", str(lib_path), str(path)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.ba_linearize_schur.argtypes = kernels.BA_LINEARIZE.argtypes
    lib.ba_linearize_schur.restype = ctypes.c_int
    return lib


def device_us(call, reps: int = 20) -> dict:
    """Device µs a launch of each of K8's kernels over ``reps`` calls."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profiled([torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = next((k for k in K8_KERNELS if k in e.key), None)
        if name:
            out[name] = e.self_device_time_total / e.count
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("pair_split: no CUDA device", file=sys.stderr)
        return 2
    inputs = linearize_bits.make_inputs()
    libs = {name: build(name, src) for name, src in variants().items()}
    library = kernels.library
    result, reference = {}, {}
    try:
        for name, lib in libs.items():
            kernels.library = lambda lib=lib: lib
            for window, case in inputs.items():
                out = linearize_bits.linearize(case)
                reference.setdefault(window, out)
                differ = linearize_bits.compare({window: out}, {window: reference[window]})
                win = pba.Window(**case["window"])
                args = (win, Pinhole(**case["model"]), pba.Evaluation(**case["ev"]), case["eps"],
                        pba.PBAOptions(**case["opts"]))
                result[f"{name} {window}"] = dict(
                    device_us=device_us(lambda: pba._linearize_from_ev_cuda(*args)),
                    entries_differ=sum(n for d in differ.values() for n in d.values()))
    finally:
        kernels.library = library
    report = dict(card=card_line(), variants=result)
    print(json.dumps(report))
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
