"""Output: trajectory files, the saved track and its evaluation
(counterpart of ``dsopp_tpu/output``)."""

from dsopp_tpu_torch.output.ate import absolute_trajectory_error, align_trajectories  # noqa: F401
from dsopp_tpu_torch.output.tum import export_tum, load_tum  # noqa: F401
