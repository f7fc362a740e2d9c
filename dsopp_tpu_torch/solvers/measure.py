"""Whole-patch Huber measure (counterpart of ``dsopp_tpu/solvers/measure.py``):

    ‖r‖² ≤ σ²:  energy = ‖r‖²/2,        weight = 1
    ‖r‖² > σ²:  energy = σ‖r‖ − σ²/2,   weight = σ/‖r‖
"""

import torch


def huber_energy_weight(residual_sq_norm, sigma):
    """[...] patch squared norms → (energy [...], irls weight [...])."""
    sigma_sq = sigma * sigma
    norm = torch.sqrt(torch.clamp(residual_sq_norm, min=1e-30))
    linear = residual_sq_norm > sigma_sq
    energy = torch.where(linear, sigma * norm - 0.5 * sigma_sq, 0.5 * residual_sq_norm)
    weight = torch.where(linear, sigma / norm, torch.ones_like(norm))
    return energy, weight
