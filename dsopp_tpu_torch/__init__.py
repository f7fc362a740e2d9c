"""dsopp_tpu_torch: direct sparse odometry in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

The package mirrors the layout of ``dsopp_tpu`` (the JAX reference): each
module here is the counterpart of the module of the same path there, and
keeps its layouts at public function boundaries (maps ``[3, H, W]`` of
(I, dx, dy), SE3 as ``(q[..., 4] w-first, t[..., 3])``, immature banks
``[K, N]``).

Kernel dispatch rule: a wrapper given CPU tensors runs its plain PyTorch
version; given CUDA tensors it launches its CUDA kernel or raises.  Kernels
are compiled from ``csrc/`` at first use (see :mod:`dsopp_tpu_torch.kernels`).

Device rule: an entry point that takes ``device=None`` runs on the CUDA
card, and raises when there is none; it runs on the CPU only when the
caller passes ``device="cpu"`` (see :func:`default_device`).
"""

import torch

# Full float32 everywhere: TF32 keeps ~3 decimal digits, which is far below
# what the photometric residuals and the 8x8 / (8K)^2 normal systems need
# (the JAX reference computes these in full f32).  Matmuls default to full
# f32 already; cuDNN convolutions do not, so both flags are set explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card and
    raises ``RuntimeError`` when there is none (the CPU is never picked
    quietly: pass ``device="cpu"`` to run there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dsopp_tpu_torch runs on a CUDA device and none is available; "
            "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
