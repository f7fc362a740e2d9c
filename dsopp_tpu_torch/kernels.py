"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library name carries a hash of the sources, so an edited source rebuilds and
an unchanged one is reused.  The build directory is ``build/dsopp_tpu_torch``
beside the package (listed in ``.gitignore``).

Launch rules shared by every kernel: launch on
``torch.cuda.current_stream()``, allocate nothing in C (callers pass
``torch.empty`` outputs), and return ``cudaGetLastError()``, which
:class:`Kernel` turns into an exception.  Each :class:`Kernel` counts its
launches in ``launches``; nothing else touches the count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "dsopp_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # keep a*b+c as two roundings, as the plain PyTorch versions compute it
    "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build():
    """Compile ``csrc/*.cu`` (if not already built) → path of the library.

    One ``nvcc -c`` per source, all started together, then one link."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libdsopp_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{tag}.{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    log, failed = [], []
    for src, proc in zip(sources, procs):
        out = proc.communicate()[0]
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True, check=False)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link:\n{link.stderr}")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib_path)
    return lib_path


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for kernel in ALL:
            fn = getattr(lib, kernel.symbol)
            fn.argtypes = kernel.argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(t: torch.Tensor, name: str, shape, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = [*argtypes, _P]     # the stream comes last
        self.launches = 0

    def __call__(self, *args):
        fn = getattr(library(), self.symbol)
        stream = torch.cuda.current_stream().cuda_stream
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = fn(*conv, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        self.launches += 1


PYRAMID = Kernel("pyramid_maps", "pyramid_level", [_P, _I, _I, _P, _I, _I, _I])
ALIGN = Kernel("align_residual_system", "align_residual_system",
               [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I,
                _F, _F, _F, _F, _F, _F, _F, _P, _P, _P, _P])
EPIPOLAR = Kernel("epipolar_sweep", "epipolar_sweep",
                  [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                   _F, _F, _F, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P])
ALIGN_LEVEL = Kernel("align_level", "align_level",
                     [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I,
                      _F, _F, _F, _F, _F, _F, _F, _I, _F, _F, _F, _F, _F, _F, _F,
                      _P, _P, _P, _P, _P, _P, _P, _P])
FLOW = Kernel("flow_statistic", "flow_statistic",
              [_P, _P, _P, _I, _P, _P] + [_F] * 7 + [_P])
# K6-K9 take the LM loop's state (or None) before their outputs
BA_FEJ = Kernel("ba_fej", "ba_fej",
                [_P] * 7 + [_I, _I] + [_F] * 6 + [_P] * 7)
BA_EVALUATE = Kernel("ba_evaluate", "ba_evaluate",
                     [_P] * 12 + [_I] * 5 + [_F] * 7 + [_P] * 8)
BA_LINEARIZE = Kernel("ba_linearize_schur", "ba_linearize_schur",
                      [_P] * 16 + [_I, _I, _I] + [_F] * 5 + [_I, _I] + [_P] * 11)
BA_SOLVE = Kernel("ba_solve_step", "ba_solve_step",
                  [_P] * 12 + [_I, _I, _F, _I] + [_P] * 6)
BA_LM = Kernel("ba_lm", "ba_lm", [_I] * 6 + [_F] * 7 + [_P] * 30)
BA_STATUS = Kernel("ba_point_status", "ba_point_status",
                   [_P] * 11 + [_I, _I, _F, _F, _I] + [_P] * 6)
# K12-K14 and K16, the keyframe backend around the BA solve; K14 has two entry
# points (the refinement, and the pairing with free landmark slots)
SELECT_CANDIDATES = Kernel("select_candidates", "select_candidates",
                           [_P, _P] + [_I] * 5 + [_F] + [_P] * 6)
ACTIVATION = Kernel("activation", "activation",
                    [_P] * 6 + [_I] * 3 + [_F] * 6 + [_P] * 8 + [_F, _F] + [_P] * 5)
REFINE = Kernel("refine_idepth", "refine_idepth",
                [_P] * 11 + [_I] * 6 + [_F] * 7 + [_P] * 5)
ACTIVATION_SCATTER = Kernel("activation_scatter", "activation_scatter",
                            [_P] * 7 + [_I] * 3 + [_P] * 8)
DEPTH_MAPS = Kernel("depth_maps", "depth_maps",
                    [_P] * 5 + [_I, _I] + [_F] * 6 + [_I] * 5 + [_P] * 15)
# K15: the marginalization policy and the ledger fold, once per keyframe each
MARG_POLICY = Kernel("marg_policy", "marg_policy",
                     [_P] * 9 + [_I] * 4 + [_F] + [_P] * 4)
MARG_FOLD = Kernel("marg_fold", "marg_fold",
                   [_P] * 12 + [_I, _D, _F, _F, _F] + [_P] * 5)
# the row gather of the Pallas design probe (off the tracker's paths)
ROW_GATHER = Kernel("row_gather", "row_gather", [_P, _P, _I, _I, _I, _P])
# K18: the camera's photometric correction, once per frame the camera reads
PHOTOMETRIC = Kernel("photometric_correct", "photometric_correct", [_P, _I, _P, _P, _I, _P])
ALL = (PYRAMID, ALIGN, ALIGN_LEVEL, EPIPOLAR, FLOW, BA_FEJ, BA_EVALUATE, BA_LINEARIZE,
       BA_SOLVE, BA_LM, BA_STATUS, SELECT_CANDIDATES, ACTIVATION, REFINE, ACTIVATION_SCATTER,
       DEPTH_MAPS, MARG_POLICY, MARG_FOLD, ROW_GATHER, PHOTOMETRIC)


def reset_counts():
    for kernel in ALL:
        kernel.launches = 0


def counts():
    return {kernel.name: kernel.launches for kernel in ALL}
