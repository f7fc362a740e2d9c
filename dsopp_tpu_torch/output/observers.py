"""Observers of a run (counterpart of ``dsopp_tpu/output/observers.py``):
they attach to the track (``track/state.py``: keyframe and marginalization
events, fired from ``PipelinedTracker``'s bookkeeping and from the
known-pose bootstrap) and to ``config/loader.py::Application`` (a notice a
frame and ``finish`` once after the run).  Every hook runs on the host,
outside the device's work, and reads nothing of the device's state."""

from __future__ import annotations

import time
from typing import Callable, List, Optional


class TrackObserver:
    """Base observer: every hook is a no-op (subclass what you need).

    Hooks mirror the reference interface set: per-frame ``notify``
    (output_interface.hpp), keyframe/marginalization events (track
    storage observers), and ``finish`` (called once after the run).
    """

    def on_frame(self, frame, result) -> None:            # notify()
        pass

    def on_keyframe(self, frame_id: int, timestamp: float) -> None:
        pass

    def on_marginalize(self, kf) -> None:                 # MarginalizedKeyframe
        pass

    def finish(self, tracker) -> None:
        pass


class ObserverSet(TrackObserver):
    """Fan-out container; also a TrackObserver itself."""

    def __init__(self, observers: Optional[List[TrackObserver]] = None):
        self.observers: List[TrackObserver] = list(observers or [])

    def add(self, obs: TrackObserver) -> "ObserverSet":
        self.observers.append(obs)
        return self

    def on_frame(self, frame, result):
        for o in self.observers:
            o.on_frame(frame, result)

    def on_keyframe(self, frame_id, timestamp):
        for o in self.observers:
            o.on_keyframe(frame_id, timestamp)

    def on_marginalize(self, kf):
        for o in self.observers:
            o.on_marginalize(kf)

    def finish(self, tracker):
        for o in self.observers:
            o.finish(tracker)


class CallbackObserver(TrackObserver):
    """Adapts the legacy ``on_frame(frame, result)`` callable."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def on_frame(self, frame, result):
        self._fn(frame, result)


class FpsMeter(TrackObserver):
    """Runtime frames/s meter (reference dsopp.cpp:45-73 runtime meter)."""

    def __init__(self):
        self.start: Optional[float] = None
        self.frames = 0
        self.keyframes = 0

    def on_frame(self, frame, result):
        if self.start is None:
            self.start = time.time()
        self.frames += 1

    def on_keyframe(self, frame_id, timestamp):
        self.keyframes += 1

    @property
    def fps(self) -> float:
        if self.start is None or self.frames == 0:
            return 0.0
        elapsed = max(time.time() - self.start, 1e-9)
        return self.frames / elapsed


class TrajectoryWriter(TrackObserver):
    """Writes the final TUM trajectory at ``finish`` (storage observer)."""

    def __init__(self, path: str):
        self.path = path

    def finish(self, tracker):
        from dsopp_tpu_torch.output.tum import export_tum

        export_tum(self.path, tracker.track.trajectory(tracker.window))
