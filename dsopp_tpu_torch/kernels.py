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
launches in ``launches``; nothing else touches the count, but for the one
entry that calls other entries from C (``BA_SOLVE_LOOP``, the windowed BA's
whole solve): it counts their successful calls into a host array, and its
wrapper adds those to their counts.  Three entries (K5, K11 and K14's
pairing) find their last block with a ticket in a small :func:`workspace` of
their stream; K12 and K16 keep their internal buffers in a :func:`scratch`
buffer of their stream.
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
_workspaces: dict = {}
_scratches: dict = {}


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


def workspace(kernel: "Kernel", nbytes: int, device: torch.device) -> torch.Tensor:
    """``kernel``'s block-counting buffer on the current stream of ``device``:
    at least ``nbytes`` zero bytes, made at its first launch on that stream
    (or anew, zero, when a launch needs more) and kept.  Each launch leaves
    it zero again, so the launches of one stream share it in stream order and
    launches on two streams never meet in it."""
    key = (kernel.name, device.index, torch._C._cuda_getCurrentRawStream(device.index))
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _workspaces[key] = torch.zeros((nbytes,), dtype=torch.uint8, device=device)
    return buf


def scratch(kernel: "Kernel", nbytes: int, device: torch.device) -> torch.Tensor:
    """``kernel``'s scratch buffer on the current stream of ``device``: at
    least ``nbytes`` bytes, made at its first launch on that stream (or anew
    when a launch needs more) and kept, keyed as :func:`workspace`.  Nothing
    is promised about its contents: a launch writes every entry it reads
    first, and leaves it as it likes.  Launches of one stream share it in
    stream order; launches on two streams never meet in it."""
    key = (kernel.name, device.index, torch._C._cuda_getCurrentRawStream(device.index))
    buf = _scratches.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _scratches[key] = torch.empty((nbytes,), dtype=torch.uint8, device=device)
    return buf


class Kernel:
    """One C entry point of the library, with its launch count.  An entry
    that runs ``steps`` returns ``(step << 16) | the CUDA error`` when one
    fails, and the exception names the step."""

    def __init__(self, name: str, symbol: str, argtypes, steps=()):
        self.name = name
        self.symbol = symbol
        self.argtypes = [*argtypes, _P]     # the stream comes last
        self.steps = steps
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(library(), self.symbol)
        # the handle torch.cuda.current_stream().cuda_stream gives, without
        # building a Stream object at every launch (or torch.cuda.current_device's
        # lazy-init check: a tensor on the card has initialised CUDA)
        stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
        if err != 0:
            where = f" in {self.steps[err >> 16]}" if self.steps else ""
            raise RuntimeError(f"{self.name}: CUDA error {err & 0xFFFF}{where} at launch")
        self.launches += 1


# K1 builds every pyramid level of one frame, or of B sequences' frames, in
# one launch and, at C > 1, a frame embedder's channel map
PYRAMID = Kernel("pyramid_maps", "pyramid_maps", [_P, _I, _I, _I, _I, _I, _P])
ALIGN = Kernel("align_residual_system", "align_residual_system",
               [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                _F, _F, _F, _F, _F, _F, _F, _P, _P, _P, _P])
# K4: the whole epipolar update of one sequence's banks or of B sequences'
# (a grid axis), its sweep's intermediates optional (null)
EPIPOLAR = Kernel("epipolar_update", "epipolar_update",
                  [_P] * 10 + [_I, _I, _I, _P, _I, _I, _I] + [_P] * 8 + [_F] * 10 + [_P] * 13)
# K3: each hypothesis's sequence index (null: one sequence) and the
# hypotheses a sequence has in the launch (its cluster size's argument)
ALIGN_LEVEL = Kernel("align_level", "align_level",
                     [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                      _F, _F, _F, _F, _F, _F, _F, _I, _F, _F, _F, _F, _F, _F, _F,
                      _P, _P, _P, _P, _P, _P, _P, _P])
# K5: the flows and, unless its decision inputs are null, the reliability
# gate and the keyframe decision, of one sequence or of B; the forced
# keyframes as a host array; its workspace (one FlowWorkspace a sequence)
# before its output
FLOW = Kernel("flow_statistic", "flow_statistic",
              [_P, _P, _P, _I, _I, _P, _P] + [_F] * 7 + [_P] * 4
              + [_I, _P, _I, _F, _P, _P, _I, _P])
FLOW_WORKSPACE_BYTES = 2048      # >= sizeof(FlowWorkspace) in csrc/flow.cu, a sequence
# K7-K16 and K15p take a sequence axis (csrc/seq_axis.cuh): after their
# outputs, the number of sequences S and the [S] int32 list of the stacked
# window's sequences (null: one sequence, or every sequence in order); K7,
# K8, K9 and K11 also take the list their state is read at (null: the
# launch's own state, at each sequence's position)
_SEQ = [_I, _P]
_SEQ_STATE = [_I, _P, _P]
# K7-K9 take the LM loop's state (or None) before their outputs; K7 writes and
# K8 reads one of the loop's two evaluation buffers (buffer 0 without a
# state); K8 forms the first-estimate Jacobians itself (once kernel K6's cache)
BA_EVALUATE = Kernel("ba_evaluate", "ba_evaluate",
                     [_P] * 12 + [_I] * 6 + [_F] * 7 + [_P] * 16 + _SEQ_STATE)
BA_LINEARIZE = Kernel("ba_linearize_schur", "ba_linearize_schur",
                      [_P] * 7 + [_F] * 6 + [_P] * 14 + [_I] * 4 + [_F] * 5 + [_I]
                      + [_P] * 11 + _SEQ_STATE)
BA_SOLVE = Kernel("ba_solve_step", "ba_solve_step",
                  [_P] * 12 + [_I, _I, _F, _I] + [_P] * 7 + _SEQ_STATE)
# K10 takes the trial's landmark sums, reduced over the landmark shards, or a
# null pointer (it sums the trial itself), and the rows of a sequence's log
BA_LM = Kernel("ba_lm", "ba_lm", [_I] * 6 + [_F] * 7 + [_P] * 29 + [_I] + _SEQ)
# K11: its workspace (ticket, counts, histogram, selection: a header a
# sequence) and its candidates before its outputs
BA_STATUS = Kernel("ba_point_status", "ba_point_status",
                   [_P] * 11 + [_I, _I, _F, _F, _I] + [_P, _I, _P] + [_P] * 6 + _SEQ_STATE)
# a sequence's header in K11's workspace: csrc/ba_status.cu kWorkspaceHeader
# (>= its StatusWorkspace); its candidates, 4 bytes a (anchor, target,
# landmark) group, lie in a scratch buffer
STATUS_WORKSPACE_BYTES = 32768
# the whole windowed-BA solve in one C call (csrc/ba_lm.cu): K7, K10's init,
# the iterations' K8, K9, K7 and K10, K10's finish, K7 and K11, in the order of
# csrc/ba_lm.cu::SolveStep, for S sequences; its last argument is a host array
# of the calls it made to each entry (csrc/ba_lm.cu::SolveCount)
BA_SOLVE_LOOP = Kernel("ba_solve_loop", "ba_solve_loop",
                       [_P] * 17 + [_I] + [_P] * 3 + [_I] * 5 + [_F] * 6 + [_I] * 3
                       + [_F] * 13 + [_I] + [_P] * 22 + [_I] + [_P] * 10 + [_I] + [_P] * 11
                       + [_I] + [_P] * 7 + _SEQ + [_P],
                       steps=("its arguments", "ba_evaluate (initial)", "ba_lm (init)",
                              "ba_linearize_schur", "ba_solve_step", "ba_evaluate (trial)",
                              "ba_lm (step)", "ba_lm (finish)", "ba_evaluate (final)",
                              "ba_point_status"))
# K12-K14 and K16, the keyframe backend around the BA solve; K14 has two entry
# points (the refinement, and the pairing with free landmark slots).  Each
# takes the sequence axis last (`_SEQ`): S sequences of the stacked window,
# banks and maps, read through the list
SELECT_CANDIDATES = Kernel("select_candidates", "select_candidates",
                           [_P, _P] + [_I] * 5 + [_F] + [_P] * 6 + _SEQ)
ACTIVATION = Kernel("activation", "activation",
                    [_P] * 8 + [_I] * 3 + [_F] * 6 + [_P] * 8 + [_F, _F] + [_P] * 5 + _SEQ)
REFINE = Kernel("refine_idepth", "refine_idepth",
                [_P] * 12 + [_I] * 6 + [_F] * 7 + [_P] * 6 + _SEQ)
# K14's pairing takes the refinement's outputs (or nulls) and writes new
# window tensors and banks
ACTIVATION_SCATTER = Kernel("activation_scatter", "activation_scatter",
                            [_P] * 10 + [_I] * 6 + [_P] * 15 + [_I] + _SEQ)
PAIR_WORKSPACE_BYTES = 512       # >= sizeof(PairWorkspace) in csrc/refine.cu, a sequence
# K16 takes the window's raw tensors (the poses and the landmark mask formed
# inside) and its internal buffers in its scratch
DEPTH_MAPS = Kernel("depth_maps", "depth_maps",
                    [_P] * 8 + [_I, _I] + [_F] * 6 + [_I] * 5 + [_P] * 20 + _SEQ)
# K15: the marginalization policy and the ledger fold, once per keyframe each
MARG_POLICY = Kernel("marg_policy", "marg_policy",
                     [_P] * 11 + [_I] * 5 + [_F] + [_P] * 4 + _SEQ)
# K15 takes K8's marginalization-pass system raw (the priors subtracted inside)
MARG_FOLD = Kernel("marg_fold", "marg_fold",
                   [_P] * 14 + [_I, _D, _F, _F, _F] + [_P] * 5 + _SEQ)
# the row gather of the Pallas design probe (off the tracker's paths)
ROW_GATHER = Kernel("row_gather", "row_gather", [_P, _P, _I, _I, _I, _P])
# K18: the camera's frame intake (the upload from pinned memory, the remap,
# the crop and the photometric correction), once per frame the camera reads
PHOTOMETRIC = Kernel("photometric_correct", "photometric_correct",
                     [_P, _P, _P] + [_I] * 4 + [_P, _P, _I, _P, _P, _I, _I, _P])
ALL = (PYRAMID, ALIGN, ALIGN_LEVEL, EPIPOLAR, FLOW, BA_EVALUATE, BA_LINEARIZE,
       BA_SOLVE, BA_LM, BA_STATUS, BA_SOLVE_LOOP, SELECT_CANDIDATES, ACTIVATION, REFINE,
       ACTIVATION_SCATTER, DEPTH_MAPS, MARG_POLICY, MARG_FOLD, ROW_GATHER, PHOTOMETRIC)


def reset_counts():
    for kernel in ALL:
        kernel.launches = 0


def counts():
    return {kernel.name: kernel.launches for kernel in ALL}
