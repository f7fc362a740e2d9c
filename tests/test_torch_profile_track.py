"""``dsopp_tpu_torch/testing/profile_track.py``'s stage timers: every stage
names a function this tree has (a renamed or removed function would drop its
stage's metric), a missing one is an error unless a parent tree is profiled,
where it is left untimed and listed, and leaving the timers puts every
function back; ``testing/profiling.py``'s session, which waits before the
work it records, and its launch count, which matches the host's launch calls
to the device records by correlation id.  No card is needed: no kernel is
called.
"""

import time
import types

import pytest
import torch

from dsopp_tpu_torch.testing import profile_track as pt
from dsopp_tpu_torch.testing.profiling import launch_records, profiled


@pytest.mark.parametrize("stage", list(pt.STAGES.items()), ids=lambda item: item[1])
def test_stage_function_exists(stage):
    (module, name), _ = stage
    assert callable(getattr(module, name, None)), f"{module.__name__}.{name}"


@pytest.fixture
def one_missing(monkeypatch):
    """STAGES with one stage whose function its module lacks."""
    module = types.ModuleType("tree_without_it")
    stages = {**pt.STAGES, (module, "gone"): "gone_stage"}
    monkeypatch.setattr(pt, "STAGES", stages)
    return stages


def test_missing_stage_raises_and_restores(one_missing):
    originals = {key: getattr(*key, None) for key in one_missing}
    with pytest.raises(AttributeError, match="gone_stage"):
        with pt.StageTimers():
            pass
    assert all(getattr(*key, None) is fn for key, fn in originals.items())


def test_missing_stage_of_a_parent_tree_is_listed(one_missing):
    originals = {key: getattr(*key, None) for key in one_missing}
    with pt.StageTimers(missing_ok=True) as timers:
        wrapped = [key for key, fn in originals.items()
                   if fn is not None and getattr(*key) is not fn]
    assert timers.untimed == ["gone_stage"]
    assert len(wrapped) == len(one_missing) - 1
    assert all(getattr(*key, None) is fn for key, fn in originals.items())


def test_profiled_waits_then_records():
    """``testing/profiling.py::profiled`` opens a session that records the
    work after its pause."""
    t0 = time.perf_counter()
    with profiled([torch.profiler.ProfilerActivity.CPU], lead_s=0.01) as prof:
        waited = time.perf_counter() - t0
        torch.ones(3) + 1
    assert waited >= 0.01
    assert "aten::add" in {e.name for e in prof.events()}


def test_earlier_name_is_timed_in_a_parent_tree(monkeypatch):
    """A parent tree without a stage's function, with its earlier design's
    (``EARLIER_NAMES``), has that one timed in its place; this tree must have
    the function itself."""
    module = types.ModuleType("parent_fused_tick")
    earlier = lambda *args: None  # noqa: E731
    module.mean_square_flows = earlier
    stages = {key: stage for key, stage in pt.STAGES.items() if stage != "flow"}
    stages[(module, "frame_statistics")] = "flow"
    monkeypatch.setattr(pt, "STAGES", stages)
    with pt.StageTimers(missing_ok=True) as timers:
        assert module.mean_square_flows is not earlier
    assert timers.untimed == [] and module.mean_square_flows is earlier
    with pytest.raises(AttributeError, match="flow"):
        with pt.StageTimers():
            pass


class _Event:
    """One raw profiler record, as ``kineto_results.events()`` gives it."""

    def __init__(self, name, corr, device=False, linked=0, thread=1):
        self._name, self._corr, self._linked, self._thread = name, corr, linked, thread
        self._device = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU

    def name(self):
        return self._name

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def device_type(self):
        return self._device

    def start_thread_id(self):
        return self._thread


def test_launch_records_count_host_calls_and_match_device_records():
    """Launches are the host's launch, copy and set calls; a call without its
    device record is named by the operator that made it, and a device record
    without its call is counted apart."""
    events = [_Event("aten::mul", 1), _Event("cudaLaunchKernel", 10, linked=1),
              _Event("mul_kernel", 10, device=True),
              _Event("aten::gather", 2), _Event("cudaLaunchKernel", 11, linked=2),
              _Event("cudaLaunchKernelExC", 12),
              _Event("align_level_kernel", 12, device=True),
              _Event("cudaMemcpyAsync", 13, linked=1), _Event("Memcpy DtoH", 13, device=True),
              _Event("cudaStreamSynchronize", 14),
              _Event("stray_kernel", 99, device=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    rec = launch_records(prof)
    assert (rec["host"], rec["device"]) == (4, 4)
    assert (rec["unmatched_host"], rec["unmatched_device"]) == (1, 1)
    assert not rec["complete"]
    assert rec["unmatched_ops"] == {"aten::gather": 1}
    assert rec["host_names"] == {"cudaLaunchKernel": 2, "cudaLaunchKernelExC": 1,
                                 "cudaMemcpyAsync": 1}
    events[:] = events[:4] + events[5:-1]
    rec = launch_records(prof)
    assert rec["complete"] and rec["host"] == rec["device"] == 3
