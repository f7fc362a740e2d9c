"""``dsopp_tpu_torch/testing/profile_track.py``'s stage timers: every stage
names a function this tree has (a renamed or removed function would drop its
stage's metric), a missing one is an error unless a parent tree is profiled,
where it is left untimed and listed, and leaving the timers puts every
function back; and ``testing/profiling.py``'s session, which waits before
the work it records.  No card is needed: no kernel is called.
"""

import time
import types

import pytest
import torch

from dsopp_tpu_torch.testing import profile_track as pt
from dsopp_tpu_torch.testing.profiling import profiled


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
