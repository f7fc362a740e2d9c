"""The ctypes bindings of ``dsopp_tpu_torch/kernels.py`` against the C entry
points of ``dsopp_tpu_torch/csrc``: each :class:`kernels.Kernel`'s argument
types, one by one, must be those of its ``extern "C"`` definition (a pointer
for every ``T*``, ``c_int`` for ``int``, ``c_float`` for ``float``,
``c_double`` for ``double``).  The sources are read as text: nothing is
compiled, so a binding that would pass a float where the entry takes a
pointer fails here before a card runs it.  (The entries ``ba_solve_loop``
calls from C are declared in ``csrc/ba_entries.cuh``, which their defining
sources include, so the compiler holds those declarations to their
definitions.)  Also the step names of ``ba_solve_loop``'s error code against
``csrc/ba_lm.cu::SolveStep``, and the order of its host array of launch
counts (``pba._SOLVE_LOOP_COUNTED``) against the calls it counts; the
bytes of the three workspaces the wrappers hand their kernels against the C
structs they hold; K16's and K12's scratch arrays against their entries'
parameters (order, sizes, 256-byte starts, no overlap); and
``kernels.scratch``'s keying and growth, with the stream handle faked on the
CPU.
"""

import ctypes
import inspect
import re

import pytest
import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.features import extractor
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.tracker import depth_map as dm

KINDS = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double}


def _types(params):
    """A C parameter list → its argument types."""
    types = []
    for param in params.split(","):
        decl = re.sub(r"\b(const|unsigned|__restrict__)\b", " ", param).strip()
        if "*" in decl:
            types.append(ctypes.c_void_p)
        else:
            types.append(KINDS[decl.split()[0]])
    return types


def _definitions():
    """[(symbol, parameter list)] of every extern "C" definition of csrc/*.cu."""
    pattern = re.compile(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', re.S)
    return [m.groups() for src in sorted(kernels.CSRC.glob("*.cu"))
            for m in pattern.finditer(src.read_text())]


def _definition(symbol):
    """The argument types of ``symbol``'s extern "C" definition."""
    found = [params for name, params in _definitions() if name == symbol]
    assert len(found) == 1, f"{symbol}: {len(found)} definitions"
    return _types(found[0])


@pytest.mark.parametrize("kernel", kernels.ALL, ids=lambda kernel: kernel.symbol)
def test_binding_matches_the_c_entry(kernel):
    assert kernel.argtypes == _definition(kernel.symbol)


def _enum(src, name, prefix):
    """{member: value} of the C enum ``name`` in ``src``."""
    body = src[src.index(f"enum {name} {{"):]
    body = body[:body.index("};")]
    return {m: int(v) for m, v in re.findall(rf"({prefix}\w+) = (\d+),", body)}


def test_solve_loop_steps_match_the_source():
    src = (kernels.CSRC / "ba_lm.cu").read_text()
    values = list(_enum(src, "SolveStep", "kStep").values())
    assert values == list(range(len(kernels.BA_SOLVE_LOOP.steps)))


def test_solve_loop_counts_follow_the_calls_they_count():
    """In ``ba_solve_loop`` every entry call is followed by the increment of
    one count, each count belongs to one entry, and that entry's place in
    ``pba._SOLVE_LOOP_COUNTED`` is the count's index."""
    src = (kernels.CSRC / "ba_lm.cu").read_text()
    counts = _enum(src, "SolveCount", "kCount")
    body = src[src.index('extern "C" int ba_solve_loop('):]
    calls = re.findall(r"err = (\w+)\(", body)
    pairs = re.findall(r"err = (\w+)\([^;]*;\s*if \(err\) return failed\(\w+, err\);"
                       r"\s*\+\+launched\[(\w+)\];", body)
    # one call site a step past the argument check, each counted at once
    assert len(pairs) == len(calls) == len(kernels.BA_SOLVE_LOOP.steps) - 1, (calls, pairs)
    order = [kernel.symbol for kernel in pba._SOLVE_LOOP_COUNTED]
    for symbol, count in pairs:
        assert counts[count] == order.index(symbol), (symbol, count)
    assert {count for _, count in pairs} == set(counts)
    assert sorted(counts.values()) == list(range(len(pba._SOLVE_LOOP_COUNTED)))


def test_solve_loop_calls_k10_without_reduced_sums():
    """``ba_solve_loop``'s three K10 calls pass a null ``reduced`` pair (the
    trial's landmark sums that a sharded solve all-reduces), so the one-call
    solve's K10 sums the trial itself, as before the pair existed; the
    sharded solve's ``pba._lm_phase`` passes it where K10 expects it."""
    src = (kernels.CSRC / "ba_lm.cu").read_text()
    body = src[src.index('extern "C" int ba_solve_loop('):]
    macros = {name: [a.strip() for a in text.replace("\\\n", " ").split(",")]
              for name, text in re.findall(r"#define (\w+) ((?:[^\n]*\\\n)*[^\n]*)", body)}
    at = _params("ba_lm").index("reduced")
    calls = re.findall(r"ba_lm\(([^;]*)\);", body)
    assert len(calls) == 3
    for call in calls:
        args = [x for a in call.split(",") for x in macros.get(a.strip(), [a.strip()])]
        assert len(args) == len(kernels.BA_LM.argtypes)   # the stream is the last
        assert args[at] == "nullptr", args[at]
    phase = inspect.getsource(pba._lm_phase)
    passed = phase[phase.index("kernels.BA_LM("):].split("(", 1)[1]
    names = [a.strip() for a in passed.replace("\n", " ").split(",")]
    # the Python call's ``*start`` spreads six pointers before the carried state
    assert names.index("reduced") == at


SIZES = {"double": 8, "float": 4, "int": 4, "unsigned int": 4}


def _struct_bytes(src, name):
    """sizeof the C struct ``name`` of ``src`` (members ``T x[A][B];`` of
    the scalar types in SIZES, each array bound a number or an ``int``
    constant of the source), with C's alignment."""
    consts = {c: int(v) for c, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    body = src[src.index(f"struct {name} {{"):]
    body = body[body.index("{") + 1:body.index("};")]
    size = align = 0
    for ctype, dims in re.findall(r"^\s*((?:unsigned )?\w+) \w+((?:\[\w+\])*);", body, re.M):
        width = SIZES[ctype]
        count = 1
        for dim in re.findall(r"\[(\w+)\]", dims):
            count *= int(dim) if dim.isdigit() else consts[dim]
        size = -(-size // width) * width + width * count
        align = max(align, width)
    return -(-size // align) * align


def test_status_workspace_header_is_the_kernels():
    """K11's workspace holds a header a sequence at the stride the C source
    gives it (its candidates lie in a buffer of their own)."""
    src = (kernels.CSRC / "ba_status.cu").read_text()
    found = re.search(r"constexpr int kWorkspaceHeader = (\d+);", src)
    assert found and int(found.group(1)) == kernels.STATUS_WORKSPACE_BYTES


@pytest.mark.parametrize("source,struct,nbytes", [
    ("flow.cu", "FlowWorkspace", kernels.FLOW_WORKSPACE_BYTES),
    ("refine.cu", "PairWorkspace", kernels.PAIR_WORKSPACE_BYTES),
    ("ba_status.cu", "StatusWorkspace", kernels.STATUS_WORKSPACE_BYTES)])
def test_workspace_holds_its_struct(source, struct, nbytes):
    size = _struct_bytes((kernels.CSRC / source).read_text(), struct)
    assert 0 < size <= nbytes, (struct, size, nbytes)


def _params(symbol):
    """The parameter names of ``symbol``'s extern "C" definition."""
    found = [params for name, params in _definitions() if name == symbol]
    assert len(found) == 1
    return [re.findall(r"(\w+)\s*$", p.strip())[0] for p in found[0].split(",")]


def _disjoint_and_aligned(spans):
    """[(start byte, bytes)] → each start on 256 bytes, none overlapping."""
    spans = sorted(spans)
    assert all(start % 256 == 0 for start, _ in spans)
    assert all(a + na <= b for (a, na), (b, _) in zip(spans, spans[1:]))


# (K × N, VGA levels, frontend points): the standart and the dense windows
@pytest.mark.parametrize("points,levels,max_points", [(2500, 5, 2000), (5780, 5, 5000),
                                                      (40, 2, 300)])
def test_depth_maps_scratch_is_the_entry_s(points, levels, max_points):
    shapes = [(480 >> lvl, 640 >> lvl) for lvl in range(levels)]
    lay = dm.frontend_layout(points, 480, 640, levels, max_points)
    layout, nbytes, words, slots = lay.scratch, lay.scratch_bytes, lay.words, lay.slots
    assert list(lay.shapes) == shapes
    assert lay.pointers == tuple(4 * at for at, _ in layout.values())
    params = _params("depth_maps")
    # the scratch arrays in the entry's order, between the intensity images
    # and the outputs
    first = params.index("intensity") + 1
    assert list(layout) == params[first:first + len(layout)]
    assert params[first + len(layout)] == "out_i"
    sizes = [h * w for h, w in shapes]
    cells, rounds = sum(sizes), levels + 1
    tiles = sum(-(-size // 1024) for size in sizes) + -(-sizes[0] // 1024)
    m = max(max_points, dm.FLOW_CAP)
    want = dict(pix=points, pidep=points, next=points, has_prev=points, raw_i=cells,
                raw_w=cells, hist=levels * (points + 1), params=2 * rounds,
                tile_counts=2 * tiles, heavy=rounds * 2 * m, rank=rounds * m)
    assert {name: count for name, (_, count) in layout.items()} == want
    spans = [(4 * at, 4 * count) for at, count in layout.values()]
    _disjoint_and_aligned(spans)
    assert max(a + n for a, n in spans) <= nbytes
    assert slots == levels * max_points + dm.FLOW_CAP and words == 2 * cells + 4 * slots


@pytest.mark.parametrize("h,w,block", [(480, 640, 13), (480, 640, 11), (100, 150, 5)])
def test_candidates_scratch_is_the_entry_s(h, w, block):
    tiles = (h // block) * (w // block)
    offsets, nbytes = extractor.candidates_layout(h, w, tiles)
    params = _params("select_candidates")
    first = params.index("factor") + 1
    assert params[first:first + 3] == ["thr", "tile_score", "tile_pos"]
    sizes = [4 * (h // 32) * (w // 32), 4 * tiles, 8 * tiles]
    _disjoint_and_aligned(list(zip(offsets, sizes)))
    assert offsets[-1] + sizes[-1] <= nbytes


def test_scratch_is_kept_per_kernel_and_stream_and_grows(monkeypatch):
    """Keyed as the workspaces: (kernel, device, stream); a bigger request
    makes a bigger buffer, a smaller one reuses it."""
    stream = [7]
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: stream[0],
                        raising=False)
    monkeypatch.setattr(kernels, "_scratches", {})
    cpu = torch.device("cpu")
    a = kernels.scratch(kernels.DEPTH_MAPS, 100, cpu)
    assert a.dtype == torch.uint8 and a.numel() >= 100
    assert kernels.scratch(kernels.DEPTH_MAPS, 60, cpu) is a
    b = kernels.scratch(kernels.DEPTH_MAPS, 300, cpu)
    assert b is not a and b.numel() >= 300
    assert kernels.scratch(kernels.DEPTH_MAPS, 100, cpu) is b
    assert kernels.scratch(kernels.SELECT_CANDIDATES, 100, cpu) is not b
    stream[0] = 8
    c = kernels.scratch(kernels.DEPTH_MAPS, 100, cpu)
    assert c is not b
    stream[0] = 7
    assert kernels.scratch(kernels.DEPTH_MAPS, 100, cpu) is b
