"""Frame synchronization across sensors (counterpart of
``dsopp_tpu/sensors/synchronizer.py``): ``MasterSensorSynchronizer`` pulls
the master camera's next frame and attaches the latest frame of every other
sensor, ``NoSynchronization`` passes the master's frames through; the
``time:`` config section picks one."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class SynchronizedFrame:
    """Bundle of per-sensor frames sharing a timestamp (sensor/synchronized_frame.hpp)."""

    timestamp: float
    frames: Dict[str, object]   # sensor id → CameraDataFrame

    def camera_frame(self, sensor_id: str):
        return self.frames.get(sensor_id)


class NoSynchronization:
    """Pass-through: every master frame becomes a synchronized frame."""

    def __init__(self, cameras: dict, master: Optional[str] = None):
        self.cameras = cameras
        self.master = master or next(iter(cameras))

    def sync(self) -> Optional[SynchronizedFrame]:
        frame = self.cameras[self.master].next_frame()
        if frame is None:
            return None
        return SynchronizedFrame(frame.timestamp, {self.master: frame})


class MasterSensorSynchronizer(NoSynchronization):
    """Pull the master sensor; attach the latest frame of every other sensor
    (reference master_sensor_synchronizer.cpp)."""

    def sync(self) -> Optional[SynchronizedFrame]:
        frame = self.cameras[self.master].next_frame()
        if frame is None:
            return None
        out = {self.master: frame}
        for sid, cam in self.cameras.items():
            if sid == self.master:
                continue
            other = cam.next_frame()
            if other is not None:
                out[sid] = other
        return SynchronizedFrame(frame.timestamp, out)


def create_synchronizer(params: dict, cameras: dict):
    """Fabric on the ``time:`` config section (reference synchronizer
    fabric.cpp:12-44 — ``type: master`` with ``sensor_id``, or
    ``no_synchronization``).  Accepts a ``Sensors`` registry or a dict."""
    if hasattr(cameras, "cameras"):   # sensors.agent.Sensors
        cameras = cameras.cameras
    kind = (params or {}).get("type", "no_synchronization")
    if kind in ("no_synchronization", "none"):
        return NoSynchronization(cameras)
    if kind in ("master_sensor", "master"):
        master = params.get("sensor_id", params.get("master_sensor_id"))
        if master is not None and master not in cameras:
            raise ValueError(f"master sensor {master!r} not registered")
        return MasterSensorSynchronizer(cameras, master)
    raise ValueError(f"unknown synchronizer type {kind!r}")
