"""Global numeric settings (counterpart of ``dsopp_tpu/settings.py``).

The reference keeps one ``Precision`` scalar, float or double.  The port
keeps the device state in float32 (the card's native width; every kernel
takes f32), runs the plain versions in float64 on the CPU as the tests'
high-precision oracle, and keeps the marginalization ledger in float64 on
the card as well (the H100 has native f64; the reference keeps
``system_marginalized_`` in double for the same reason).
"""

import torch

# Default scalar dtype of the tracker's device state.
dtype = torch.float32

# Dtype of the persistent marginalization ledger (small dense system).
marg_dtype = torch.float64


def eps_for(dt) -> float:
    """Small epsilon that guards divisions at the working precision ``dt``."""
    return 1e-12 if dt == torch.float64 else 1e-8
