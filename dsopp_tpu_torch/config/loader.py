"""YAML config with dot-path overrides → the tracker's configuration
(counterpart of ``dsopp_tpu/config/loader.py``: ``load_config``,
``apply_overrides`` and ``build_tracker_config``; yaml is imported where it
is used)."""

from __future__ import annotations

import copy

from dsopp_tpu_torch.tracker.monocular import TrackerConfig


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def apply_overrides(config: dict, overrides) -> dict:
    """Merge ``--config.a.b.0.c=value`` overrides into a copy of the tree:
    integer path components index lists, the value is parsed as YAML."""
    import yaml

    config = copy.deepcopy(config)
    for item in overrides:
        if item.startswith("--config."):
            item = item[len("--config."):]
        path, _, raw = item.partition("=")
        keys = path.split(".")
        node = config
        for key in keys[:-1]:
            node = node[int(key)] if isinstance(node, list) else node.setdefault(key, {})
        leaf, value = keys[-1], yaml.safe_load(raw)
        if isinstance(node, list):
            node[int(leaf)] = value
        else:
            node[leaf] = value
    return config


def _affine_reg(section: dict, default: tuple) -> tuple:
    """``affine_brightness_regularizers: "a b"`` of a solver section."""
    raw = section.get("affine_brightness_regularizers")
    if raw is None:
        return default
    parts = [float(x) for x in str(raw).split()]
    return (parts[0], parts[1])


def build_tracker_config(tracker_params: dict) -> TrackerConfig:
    """The ``tracker:`` section → :class:`TrackerConfig`."""
    cfg = TrackerConfig()
    cfg.desired_points = int(tracker_params.get("number_of_desired_points",
                                                cfg.desired_points))
    kf = tracker_params.get("keyframe_strategy", {})
    cfg.keyframe_factor = float(kf.get("factor", cfg.keyframe_factor))
    marg = tracker_params.get("marginalization_strategy", {})
    cfg.window_min = int(marg.get("minimum_size", cfg.window_min))
    cfg.window_max = int(marg.get("maximum_size", cfg.window_max))
    cfg.max_marginalized_fraction = float(
        marg.get("maximum_percentage_of_marginalized_points_in_frame",
                 cfg.max_marginalized_fraction))
    pba = tracker_params.get("photometric_bundle_adjustment", {}) or {}
    cfg.pba_max_iterations = int(pba.get("max_iterations", cfg.pba_max_iterations))
    cfg.pba_affine_reg = _affine_reg(pba, cfg.pba_affine_reg)
    pa = tracker_params.get("pose_alignment", {}) or {}
    cfg.align_affine_reg = _affine_reg(pa, cfg.align_affine_reg)
    # window_max + 2: the loop pushes the new keyframe before the fold
    cfg.num_frame_slots = cfg.window_max + 2
    cfg.landmarks_per_frame = max(64, cfg.desired_points // max(cfg.window_max - 1, 1))
    return cfg
