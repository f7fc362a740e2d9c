"""S2 unit-sphere local parameterization (counterpart of
``dsopp_tpu/solvers/s2.py``): a unit 3-vector is moved through its
spherical coordinates (θ, φ) by a 2-dof increment, with the 3×2
plus-Jacobian at zero.  The SO3×S2 refinement of the bootstrap
(``fbs/geometry.py``) updates the translation direction with it."""

from __future__ import annotations

import torch


def s2_plus(v, delta):
    """S2 ⊞: unit vector(s) ``v`` [..., 3] moved by ``delta`` [..., 2]:
    θ' = acos(v_z) + δ₀, φ' = atan2(v_y, v_x) + δ₁ → (sinθ' cosφ',
    sinθ' sinφ', cosθ')."""
    theta = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0)) + delta[..., 0]
    phi = torch.atan2(v[..., 1], v[..., 0]) + delta[..., 1]
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta)], dim=-1)


def s2_plus_jacobian(v):
    """d(s2_plus(v, δ))/dδ at δ = 0 → [..., 3, 2]."""
    theta = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))
    phi = torch.atan2(v[..., 1], v[..., 0])
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    rows = torch.stack([ct * cp, st * (-sp), ct * sp, st * cp, -st, torch.zeros_like(st)], dim=-1)
    return rows.reshape(rows.shape[:-1] + (3, 2))
