"""Ground-truth synthetic sequences (counterpart of ``dsopp_tpu.testing``)."""

from dsopp_tpu_torch.testing.synthetic import SyntheticSequence, render_sequence  # noqa: F401
