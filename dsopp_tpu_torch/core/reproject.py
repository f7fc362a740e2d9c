"""Reprojection of (pixel, inverse depth) between frames, with Jacobians
(counterpart of ``dsopp_tpu/core/reproject.py``).

With reference ray ``r`` (z = 1) and inverse depth ``d`` the target point is
``q = R r + d t`` up to the positive scale ``1/d``; target inverse depth is
``d / q_z``.  Pose Jacobians use the right-increment convention
``T ← T exp(ε)``, tangent order [υ, ω].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsopp_tpu_torch.core.camera import MIN_DEPTH, _safe_z, valid_idepth
from dsopp_tpu_torch.core.lie import SE3, _cross, quat_rotate, quat_to_matrix


def _scaled_target_point(model_ref, uv, idepth, t_t_r: SE3):
    ray = model_ref.unproject(uv)
    q = quat_rotate(t_t_r.q, ray) + idepth[..., None] * t_t_r.t
    return q, ray


def _valid_z(q, idepth):
    return q[..., 2] >= MIN_DEPTH * torch.clamp(idepth, min=0.0) + 1e-12


class Reprojection(NamedTuple):
    uv: torch.Tensor
    idepth: torch.Tensor
    valid: torch.Tensor


class ReprojectionJac(NamedTuple):
    uv: torch.Tensor
    idepth: torch.Tensor
    valid: torch.Tensor
    d_uv_d_idepth: torch.Tensor    # [..., 2]
    d_uv_d_eps_ref: torch.Tensor   # [..., 2, 6]
    d_uv_d_eps_tgt: torch.Tensor   # [..., 2, 6]


def reproject(model_ref, model_tgt, uv, idepth, t_t_r: SE3) -> Reprojection:
    q, _ = _scaled_target_point(model_ref, uv, idepth, t_t_r)
    uv_t, valid_proj = model_tgt.project(q)
    idepth_t = idepth / _safe_z(q[..., 2])
    valid = valid_proj & _valid_z(q, idepth) & valid_idepth(idepth)
    return Reprojection(uv_t, idepth_t, valid)


def reproject_jacobian(model_ref, model_tgt, uv, idepth, t_t_r: SE3) -> ReprojectionJac:
    q, ray = _scaled_target_point(model_ref, uv, idepth, t_t_r)
    uv_t, j_proj, valid_proj = model_tgt.project_jacobian(q)
    idepth_t = idepth / _safe_z(q[..., 2])
    valid = valid_proj & _valid_z(q, idepth) & valid_idepth(idepth)

    d_uv_d_idepth = torch.sum(j_proj * t_t_r.t[..., None, :], dim=-1)
    r_tr = quat_to_matrix(t_t_r.q).expand(q.shape[:-1] + (3, 3))
    a = torch.sum(j_proj[..., :, :, None] * r_tr[..., None, :, :], dim=-2)
    d = idepth[..., None, None]
    ray_b = ray[..., None, :].expand(a.shape)
    q_b = q[..., None, :].expand(j_proj.shape)
    d_uv_d_eps_ref = torch.cat([d * a, -_cross(a, ray_b)], dim=-1)
    d_uv_d_eps_tgt = torch.cat([-d * j_proj, _cross(j_proj, q_b)], dim=-1)
    return ReprojectionJac(uv_t, idepth_t, valid, d_uv_d_idepth,
                           d_uv_d_eps_ref, d_uv_d_eps_tgt)
