"""Feature-based bootstrap (the monocular initializer), the counterpart of
``dsopp_tpu/fbs``."""

from dsopp_tpu_torch.fbs.initializer import InitializerOptions, MonocularInitializer  # noqa: F401
