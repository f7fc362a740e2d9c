"""The agent and its sensor registry (counterpart of
``dsopp_tpu/sensors/agent.py``): cameras register by their string id, and
the first registered camera is the default master."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Sensors:
    """Sensor registry (reference sensors::Sensors)."""

    cameras: Dict[str, object] = field(default_factory=dict)

    def add_camera(self, camera) -> None:
        if camera.sensor_id in self.cameras:
            raise ValueError(f"duplicate sensor id {camera.sensor_id!r}")
        self.cameras[camera.sensor_id] = camera

    def get(self, sensor_id: str):
        return self.cameras.get(sensor_id)

    def camera_ids(self):
        return list(self.cameras)

    @property
    def master(self):
        """First registered camera (default master sensor)."""
        return next(iter(self.cameras.values()), None)

    def __len__(self):
        return len(self.cameras)


@dataclass
class Agent:
    """The tracked agent: owns the sensor rig (agent.hpp:15-30)."""

    sensors: Sensors = field(default_factory=Sensors)
