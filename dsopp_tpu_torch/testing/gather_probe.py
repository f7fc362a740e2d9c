"""The row-gather design probe on the card (counterpart of
``scripts/gather_probe_pallas.py``, the repository's one Pallas kernel).

    python -m dsopp_tpu_torch.testing.gather_probe [out.json]

The probe's inputs, made from its seed: a [480·640, 12] table of standard
normal values in f32 and in bf16, and 204800 row indices in
[0, 480·640 − 640 − 2).  For each type, ``out = table[idx]`` by the
hand-written kernel (``csrc/row_gather.cu``), by its plain version (PyTorch
advanced indexing) and by ``torch.index_select`` (the library's gather), each
timed with CUDA events (the wrapper's host work included) and by the
profiler's device time, with the L2 warm (back to back: the 14.7 MB f32
table stays in the 50 MB L2) and cold (a 256 MB write before each call);
the bound counts the distinct rows the draw names, and beside it the 32-byte
sectors of the table those rows touch.  The wrapper's host time is split
into its parts (:func:`host_split`).  The kernel's output must equal the
plain version's to the bit.  Prints one JSON object with the card's name
and power limit.  Needs a CUDA card.

:func:`row_gather` dispatches as every wrapper of the port does: CPU tensors
take the plain version, CUDA tensors the kernel (after a range check of the
indices, which reads the device: the probe is off every path).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.testing.profiling import profiled

# scripts/gather_probe_pallas.py:35-38
H, W = 480, 640
HW = H * W
M = 204800
ROWW = 12
SEED = 0


def probe_inputs(device, m: int = M):
    """(f32 table [HW, ROWW], bf16 table, idx [m] int32) as the probe makes
    them (numpy's generator, seed 0; the first ``m`` indices of its draw)."""
    rng = np.random.default_rng(SEED)
    table = torch.as_tensor(rng.standard_normal((HW, ROWW)).astype(np.float32), device=device)
    idx = torch.as_tensor(rng.integers(0, HW - W - 2, M).astype(np.int32)[:m], device=device)
    return table, table.to(torch.bfloat16), idx


def row_gather_plain(table, idx):
    """``table[idx]``: rows of ``table`` [R, C] at ``idx`` [M] → [M, C]."""
    return table[idx]


_GATHER_TYPES = (torch.float32, torch.bfloat16)


def _gather_shape(table, idx):
    """Check the row gather's arguments (one test on the common path) →
    (rows, columns, bytes a row)."""
    if not (table.is_cuda and table.dtype in _GATHER_TYPES and table.dim() == 2
            and table.is_contiguous() and idx.dtype == torch.int32 and idx.dim() == 1
            and idx.is_contiguous() and idx.device == table.device):
        if table.dim() != 2 or table.dtype not in _GATHER_TYPES:
            raise ValueError(f"row_gather: a 2-D f32 or bf16 table, got {table.dtype} "
                             f"{tuple(table.shape)}")
        kernels.check(table, "table", tuple(table.shape), table.dtype)
        kernels.check(idx, "idx", (idx.shape[0],), torch.int32)
        raise ValueError(f"row_gather: idx on {idx.device}, the table on {table.device}")
    rows, cols = table.shape
    row_bytes = cols * table.element_size()
    if row_bytes % 8:
        raise ValueError(f"row_gather: rows of {row_bytes} bytes, not a multiple of 8")
    return rows, cols, row_bytes


def row_gather_cuda(table, idx):
    """The kernel: same output as :func:`row_gather_plain`; reads nothing on
    the host (an index outside the table gives a zero row)."""
    rows, cols, row_bytes = _gather_shape(table, idx)
    m = idx.shape[0]
    out = table.new_empty((m, cols))
    kernels.ROW_GATHER(table, idx, rows, m, row_bytes, out)
    return out


def row_gather(table, idx):
    """``table[idx]``: the kernel on CUDA tensors (indices checked against the
    table first), the plain version on CPU ones."""
    if not table.is_cuda:
        return row_gather_plain(table, idx)
    if idx.numel() and not (int(idx.min()) >= 0 and int(idx.max()) < table.shape[0]):
        raise IndexError(f"row_gather: indices outside [0, {table.shape[0]})")
    return row_gather_cuda(table, idx)


def bound_ms(table, idx, peak_bytes: float = 3.35e12) -> float:
    """Least time on an H100 for this draw of indices: the indices read once,
    each distinct row they name read once, the output written once, over the
    memory rate."""
    row = table.shape[1] * table.element_size()
    distinct = torch.unique(idx).numel()
    return 1e3 * (4 * idx.numel() + distinct * row + idx.numel() * row) / peak_bytes


L2_FLUSH_BYTES = 256 << 20   # five times the H100's 50 MB L2


def device_us(fn, reps: int = 20, cold: bool = False) -> float:
    """Device time of ``fn`` per call, µs: the profiler's self device time of
    its kernels over ``reps`` calls after one warm call.  ``cold``: before each
    call a 256 MB buffer is written, so that the L2 holds none of the inputs
    (the writes' own kernels are left out of the sum)."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold else None
    skip = set()
    if cold:
        with profiled([torch.profiler.ProfilerActivity.CUDA]) as prof:
            flush.fill_(1.0)
            torch.cuda.synchronize()
        skip = {e.key for e in prof.key_averages()}
    fn()
    torch.cuda.synchronize()
    with profiled([torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if cold:
                flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages() if e.key not in skip) / reps


def host_split(table, idx, reps: int = 200, rounds: int = 15) -> dict:
    """Host µs a call of each part of :func:`row_gather_cuda`, the median over
    ``rounds`` runs of ``reps`` calls on the host's clock (each run ends in a
    synchronise that is not counted; 200 launches stay inside the card's
    launch queue): the checks, ``new_empty``, ``Kernel.__call__``'s stream
    lookup (and the lookup it replaced, through ``torch.cuda.current_device``)
    and its argument conversion, the ctypes call with its launch, the whole
    wrapper, and ``torch.index_select`` beside it."""
    import time

    rows, cols, row_bytes = _gather_shape(table, idx)
    m = idx.shape[0]
    out = table.new_empty((m, cols))
    long_idx = idx.long()
    fn = getattr(kernels.library(), kernels.ROW_GATHER.symbol)   # with its argtypes
    args = (table, idx, rows, m, row_bytes, out)
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    parts = {
        "checks": lambda: _gather_shape(table, idx),
        "new_empty": lambda: table.new_empty((m, cols)),
        "torch_empty": lambda: torch.empty((m, cols), dtype=table.dtype, device=table.device),
        "stream_lookup": lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()),
        "stream_lookup_before": lambda: torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()),
        "argument_conversion": lambda: [a.data_ptr() if isinstance(a, torch.Tensor) else a
                                        for a in args],
        "ctypes_call_and_launch": lambda: fn(*conv, stream),
        "wrapper": lambda: row_gather_cuda(table, idx),
        "index_select": lambda: torch.index_select(table, 0, long_idx),
    }
    result = {}
    for name, part in parts.items():
        part()
        torch.cuda.synchronize()
        runs = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(reps):
                part()
            runs.append((time.perf_counter() - t0) / reps)
            torch.cuda.synchronize()
        result[name] = 1e6 * float(np.median(runs))
    return result


def sectors(table, idx) -> int:
    """The 32-byte sectors of the table that this draw's distinct rows touch
    (what the card reads, beside the bound's bytes)."""
    row = table.shape[1] * table.element_size()
    start = torch.unique(idx).long() * row
    return int((((start + row - 1) // 32) - start // 32 + 1).sum())


def main(argv):
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 2
    from dsopp_tpu_torch.testing.parity import cuda_ms
    from dsopp_tpu_torch.testing.paths import card_line
    card = card_line()
    table, table_bf, idx = probe_inputs("cuda")
    result = dict(card=card, rows=HW, m=M, row_width=ROWW)
    for name, tab in (("f32", table), ("bf16", table_bf)):
        out_k, out_p = row_gather(tab, idx), row_gather_plain(tab, idx)
        if not torch.equal(out_k, out_p):
            print(f"gather_probe: the kernel differs from table[idx] in {name}", file=sys.stderr)
            return 1
        long_idx = idx.long()
        result[name] = dict(
            ms=cuda_ms(lambda: row_gather_cuda(tab, idx)),
            plain_ms=cuda_ms(lambda: row_gather_plain(tab, idx)),
            index_select_ms=cuda_ms(lambda: torch.index_select(tab, 0, long_idx)),
            device_us=device_us(lambda: row_gather_cuda(tab, idx)),
            plain_device_us=device_us(lambda: row_gather_plain(tab, idx)),
            index_select_device_us=device_us(lambda: torch.index_select(tab, 0, long_idx)),
            cold_device_us=device_us(lambda: row_gather_cuda(tab, idx), cold=True),
            cold_plain_device_us=device_us(lambda: row_gather_plain(tab, idx), cold=True),
            cold_index_select_device_us=device_us(lambda: torch.index_select(tab, 0, long_idx),
                                                  cold=True),
            bound_ms=bound_ms(tab, idx), table_sectors=sectors(tab, idx),
            host_split_us=host_split(tab, idx), equal=True)
    print(json.dumps(result))
    if len(argv) > 1:
        with open(argv[1], "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
