"""Batched SO3/SE3 operations on quaternions (counterpart of
``dsopp_tpu/core/lie.py``).

Rotations are unit quaternions ``[w, x, y, z]`` with arbitrary leading batch
dimensions; tangents are ``[upsilon(3), omega(3)]``.  An SE3 is the pair
``(q, t)`` with ``x_out = R(q) x + t``.  Every formula and Taylor guard is
the reference's, so results agree to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_SMALL = 1e-6


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=1e-30))


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / _safe_sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def quat_rotate(q, v):
    """Rotate vectors ``v`` [..., 3] by quaternions ``q`` [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix [..., 3, 3] → quaternion [..., 4] (Shepperd): of the
    four candidates the best-conditioned one, normalized."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    scores = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None].expand(best.shape + (1, 4)), dim=-2)
    return quat_normalize(q[..., 0, :])


def so3_exp_quat(omega):
    """so3 tangent [..., 3] → unit quaternion."""
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = _safe_sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < _SMALL
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * omega], dim=-1))


def so3_log(q):
    """Unit quaternion → so3 tangent [..., 3]."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = q[..., :1]
    v = q[..., 1:]
    s_sq = torch.sum(v * v, dim=-1, keepdim=True)
    s = _safe_sqrt(s_sq)
    small = s_sq < _SMALL
    angle = 2.0 * torch.atan2(s, w)
    w_safe = torch.clamp(w, min=1e-12)
    k = torch.where(small, 2.0 / w_safe * (1.0 + s_sq / (3.0 * w_safe * w_safe)),
                    angle / s)
    return k * v


def _so3_left_jacobian_terms(omega):
    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = _safe_sqrt(theta_sq)
    small = theta_sq < _SMALL
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta_sq, min=1e-30))
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta_sq * theta, min=1e-30))
    return a, b


def _apply_V(omega, v):
    a, b = _so3_left_jacobian_terms(omega)
    c1 = _cross(omega, v)
    c2 = _cross(omega, c1)
    return v + a[..., None] * c1 + b[..., None] * c2


def _apply_V_inv(omega, t):
    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = _safe_sqrt(theta_sq)
    small = theta_sq < _SMALL
    half = 0.5 * theta
    cot = torch.cos(half) / torch.where(small, torch.ones_like(half), torch.sin(half))
    c = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - half * cot) / torch.clamp(theta_sq, min=1e-30))
    c1 = _cross(omega, t)
    c2 = _cross(omega, c1)
    return t - 0.5 * c1 + c[..., None] * c2


def so3_hat(w):
    """[..., 3] → skew matrices [..., 3, 3]."""
    z = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


class SE3(NamedTuple):
    """Batched rigid transform: quaternion [..., 4] + translation [..., 3]."""

    q: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(batch=(), dtype=torch.float32, device=None) -> "SE3":
        q = torch.zeros(tuple(batch) + (4,), dtype=dtype, device=device)
        q[..., 0] = 1.0
        return SE3(q, torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device))

    @staticmethod
    def from_matrix(m) -> "SE3":
        """4x4 (or [..., 3, 4]) T → SE3."""
        return SE3(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3].contiguous())

    @staticmethod
    def exp(xi) -> "SE3":
        upsilon, omega = xi[..., :3], xi[..., 3:]
        return SE3(so3_exp_quat(omega), _apply_V(omega, upsilon))

    def log(self):
        omega = so3_log(self.q)
        return torch.cat([_apply_V_inv(omega, self.t), omega], dim=-1)

    def apply(self, x):
        return quat_rotate(self.q, x) + self.t

    def inverse(self) -> "SE3":
        qi = quat_conjugate(self.q)
        return SE3(qi, -quat_rotate(qi, self.t))

    def compose(self, other: "SE3") -> "SE3":
        return SE3(quat_normalize(quat_multiply(self.q, other.q)),
                   quat_rotate(self.q, other.t) + self.t)

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return self.compose(other)
        return self.apply(other)

    def adjoint(self):
        """Adj(T) [..., 6, 6] for the tangent order [υ, ω]: [[R, t̂ R], [0, R]]."""
        r = quat_to_matrix(self.q)
        top = torch.cat([r, so3_hat(self.t) @ r], dim=-1)
        bot = torch.cat([torch.zeros_like(r), r], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def matrix(self):
        r = quat_to_matrix(self.q)
        top = torch.cat([r, self.t[..., None]], dim=-1)
        last = torch.zeros(top.shape[:-2] + (1, 4), dtype=self.q.dtype,
                           device=self.q.device)
        # fill_ takes the scalar as a kernel argument; an indexed assignment
        # of a Python number copies it from the host and waits for the device
        last[..., 0, 3].fill_(1.0)
        return torch.cat([top, last], dim=-2)
