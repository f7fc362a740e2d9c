"""The port's config loader against the JAX package's (counterpart of the
override tests of ``tests/config/test_config.py``): the same YAML and the
same overrides give the same tree, and ``build_tracker_config`` the same
tracker configuration, field by field (exact)."""

import dataclasses

import cv2
import numpy as np
import pytest

from dsopp_tpu.config import loader as jloader
from dsopp_tpu_torch.config.loader import apply_overrides, build_tracker_config, load_config
from dsopp_tpu_torch.sensors.camera import Camera

from tests.config.test_config import YAML


@pytest.fixture
def dataset(tmp_path):
    (tmp_path / "mono.yaml").write_text(YAML)
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(folder / f"{i}.png"), rng.uniform(0, 255, (48, 64)).astype(np.uint8))
    (tmp_path / "times.txt").write_text("".join(f"{i} {0.1*i:.2f}\n" for i in range(3)))
    (tmp_path / "calib.txt").write_text("pinhole\n64 48\n40 40 32 24\n")
    return tmp_path


def _same_tracker_config(tracker_params):
    port = dataclasses.asdict(build_tracker_config(tracker_params))
    ref = dataclasses.asdict(jloader.build_tracker_config(tracker_params))
    assert port == {field: ref[field] for field in port}
    return build_tracker_config(tracker_params)


def test_dot_path_overrides(dataset):
    config = load_config(str(dataset / "mono.yaml"))
    assert config == jloader.load_config(str(dataset / "mono.yaml"))
    overrides = ["--config.tracker.number_of_desired_points=555",
                 "--config.tracker.keyframe_strategy.factor=2.5",
                 "--config.sensors.0.provider.start_frame=1"]
    config = apply_overrides(config, overrides)
    assert config == jloader.apply_overrides(jloader.load_config(str(dataset / "mono.yaml")),
                                             overrides)
    assert config["tracker"]["number_of_desired_points"] == 555
    assert config["tracker"]["keyframe_strategy"]["factor"] == 2.5
    assert config["sensors"][0]["provider"]["start_frame"] == 1
    cfg = _same_tracker_config(config["tracker"])
    assert cfg.desired_points == 555 and cfg.keyframe_factor == 2.5
    assert cfg.window_max == 6 and cfg.num_frame_slots == 8
    camera = Camera.from_config("camera_1", config["sensors"][0], base_dir=str(dataset),
                                device="cpu")
    assert camera.next_frame().frame_id == 1


def test_override_creates_missing_keys(dataset):
    config = load_config(str(dataset / "mono.yaml"))
    config = apply_overrides(config, ["--config.new_section.value=7"])
    assert config["new_section"]["value"] == 7
    assert "new_section" not in load_config(str(dataset / "mono.yaml"))


@pytest.mark.parametrize("tracker_params", [
    {},
    {"number_of_desired_points": 5000, "marginalization_strategy": {"maximum_size": 15},
     "photometric_bundle_adjustment": {"max_iterations": 9,
                                       "affine_brightness_regularizers": "1e6 1e4"},
     "pose_alignment": {"affine_brightness_regularizers": "10 20"}},
], ids=["defaults", "solver_sections"])
def test_build_tracker_config_matches(tracker_params):
    _same_tracker_config(tracker_params)
