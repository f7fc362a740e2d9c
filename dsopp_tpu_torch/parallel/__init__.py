"""Many sequences and many processes: the (seq, lm) mesh of ranks, the
landmark-sharded BA step over ``torch.distributed`` and the sequence-batched
train step (counterpart of ``dsopp_tpu/parallel``)."""

from dsopp_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
