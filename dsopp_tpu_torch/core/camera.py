"""Camera models with their projection Jacobians (counterpart of
``dsopp_tpu/core/camera.py``).

The tracker runs on :class:`Pinhole`.  The distorted models (SimpleRadial,
TumFov, Division, Atan, IOSCamera) serve the calibration loader and the
undistorter, which remaps their images to a pinhole one.

Intrinsics are plain Python floats: they are fixed per run, broadcast into
tensor arithmetic as weak scalars (so an f32 tensor stays f32 and an f64 one
f64), and the CUDA kernels take them by value without a device readback.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

BORDER_SIZE = 4.0
MIN_DEPTH = 1e-3
MIN_IDEPTH = -1e-4
MAX_IDEPTH = 1.0 / MIN_DEPTH + 10.0


def _inside_roi(uv, width, height, border):
    """uv [..., 2] within [border, size - border - 1]."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= border) & (v >= border)
            & (u <= width - border - 1.0) & (v <= height - border - 1.0))


def valid_idepth(idepth):
    return (idepth > MIN_IDEPTH) & (idepth < MAX_IDEPTH)


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


class Pinhole(NamedTuple):
    """Pinhole model uv = f * xy / z + c; ``width``/``height`` in pixels."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: float
    height: float

    @staticmethod
    def create(image_size, focal, principal) -> "Pinhole":
        return Pinhole(float(focal[0]), float(focal[1]), float(principal[0]),
                       float(principal[1]), float(image_size[0]),
                       float(image_size[1]))

    def scaled(self, scale) -> "Pinhole":
        """Model for a pyramid level downscaled by ``scale`` (2**level)."""
        s = float(scale)
        return Pinhole(self.fx / s, self.fy / s, self.cx / s, self.cy / s,
                       self.width / s, self.height / s)

    def project(self, p3d, border=BORDER_SIZE):
        """[..., 3] → (uv [..., 2], valid [...])."""
        z = p3d[..., 2]
        z_safe = _safe_z(z)
        u = self.fx * p3d[..., 0] / z_safe + self.cx
        v = self.fy * p3d[..., 1] / z_safe + self.cy
        uv = torch.stack([u, v], dim=-1)
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.width, self.height, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        """[..., 3] → (uv, J = d(uv)/d(p3d) [..., 2, 3], valid)."""
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        iz = 1.0 / _safe_z(z)
        iz2 = iz * iz
        uv = torch.stack([self.fx * x * iz + self.cx, self.fy * y * iz + self.cy], -1)
        zero = torch.zeros_like(x)
        j = torch.stack(
            [self.fx * iz, zero, -self.fx * x * iz2,
             zero, self.fy * iz, -self.fy * y * iz2],
            dim=-1,
        ).reshape(x.shape + (2, 3))
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.width, self.height, border)
        return uv, j, valid

    def unproject(self, uv):
        """[..., 2] → ray [..., 3] with z = 1."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.width, self.height, border)


def _jvp_jacobian(core, p3d):
    """d core(p3d) / d p3d [..., 2, 3] by forward-mode differentiation (the
    JAX package takes ``jax.jvp`` of the same closed forms)."""
    basis = torch.eye(3, dtype=p3d.dtype, device=p3d.device)
    cols = [torch.func.jvp(core, (p3d,), (basis[i].expand_as(p3d),))[1] for i in range(3)]
    return torch.stack(cols, dim=-1)


def _principal_point(model, like):
    return torch.stack([torch.full_like(like, model.cx), torch.full_like(like, model.cy)], -1)


class SimpleRadial(NamedTuple):
    """Single-focal radial model: r_d = r (1 + k1 r^2 + k2 r^4) on the
    normalized plane; projections past the radius where the distortion stops
    being monotonic are invalid."""

    f: float
    cx: float
    cy: float
    k1: float
    k2: float
    width: float
    height: float

    @staticmethod
    def create(image_size, f, principal, k1, k2) -> "SimpleRadial":
        return SimpleRadial(float(f), float(principal[0]), float(principal[1]), float(k1),
                            float(k2), float(image_size[0]), float(image_size[1]))

    def scaled(self, scale) -> "SimpleRadial":
        s = float(scale)
        # k1, k2 act on the normalized plane: invariant to pixel scaling
        return SimpleRadial(self.f / s, self.cx / s, self.cy / s, self.k1, self.k2,
                            self.width / s, self.height / s)

    def max_valid_r2(self) -> float:
        """Largest r^2 with d(r_d)/dr = 1 + 3 k1 r^2 + 5 k2 r^4 > 0 (the
        smallest positive root of the derivative; 1e12 when there is none)."""
        k1, k2, big = self.k1, self.k2, 1e12
        if abs(k2) < 1e-12:
            return -1.0 / (3.0 * k1) if k1 < 0 else big
        disc = 9.0 * k1 * k1 - 20.0 * k2
        if disc < 0:
            return big
        sq = math.sqrt(disc)
        roots = [(-3.0 * k1 - sq) / (10.0 * k2), (-3.0 * k1 + sq) / (10.0 * k2)]
        return min(r if r > 0 else big for r in roots)

    def _factor(self, r2):
        return 1.0 + self.k1 * r2 + self.k2 * r2 * r2

    def _valid(self, z, r2, uv, border):
        return ((z >= MIN_DEPTH) & (r2 <= self.max_valid_r2())
                & _inside_roi(uv, self.width, self.height, border))

    def project(self, p3d, border=BORDER_SIZE):
        z = p3d[..., 2]
        z_safe = _safe_z(z)
        mx = p3d[..., 0] / z_safe
        my = p3d[..., 1] / z_safe
        r2 = mx * mx + my * my
        factor = self._factor(r2)
        uv = torch.stack([self.f * factor * mx + self.cx, self.f * factor * my + self.cy], -1)
        return uv, self._valid(z, r2, uv, border)

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        """Analytic d(uv)/d(p3d) via the distorted-plane chain rule."""
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        iz = 1.0 / _safe_z(z)
        mx, my = x * iz, y * iz
        r2 = mx * mx + my * my
        factor = self._factor(r2)
        dfac_dr2 = self.k1 + 2.0 * self.k2 * r2
        a00 = factor + 2.0 * dfac_dr2 * mx * mx
        a01 = 2.0 * dfac_dr2 * mx * my
        a11 = factor + 2.0 * dfac_dr2 * my * my
        iz2 = iz * iz
        j = torch.stack([self.f * (a00 * iz), self.f * (a01 * iz),
                         self.f * (-(a00 * x + a01 * y) * iz2),
                         self.f * (a01 * iz), self.f * (a11 * iz),
                         self.f * (-(a01 * x + a11 * y) * iz2)], -1).reshape(x.shape + (2, 3))
        uv = torch.stack([self.f * factor * mx + self.cx, self.f * factor * my + self.cy], -1)
        return uv, j, self._valid(z, r2, uv, border)

    def unproject(self, uv, newton_iters: int = 10):
        """Invert the distortion with ``newton_iters`` Newton steps on
        r (1 + k1 r^2 + k2 r^4) = r_d."""
        dx = (uv[..., 0] - self.cx) / self.f
        dy = (uv[..., 1] - self.cy) / self.f
        rd = torch.sqrt(torch.clamp(dx * dx + dy * dy, min=1e-30))
        r = rd
        for _ in range(newton_iters):
            r2 = r * r
            fval = r * (1.0 + self.k1 * r2 + self.k2 * r2 * r2) - rd
            fprime = 1.0 + 3.0 * self.k1 * r2 + 5.0 * self.k2 * r2 * r2
            fprime = torch.where(torch.abs(fprime) < 1e-8, torch.full_like(fprime, 1e-8), fprime)
            r = r - fval / fprime
        scale = torch.where(rd > 1e-12, r / rd, torch.ones_like(rd))
        return torch.stack([dx * scale, dy * scale, torch.ones_like(dx)], -1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.width, self.height, border)


class TumFov(NamedTuple):
    """FOV fisheye model (Devernay–Faugeras), TUM-mono's:
    r_d = atan2(2 r_u tan(ω/2), z) / ω,  uv = f · (r_d / r_u) · xy + c."""

    fx: float
    fy: float
    cx: float
    cy: float
    fov: float
    width: float
    height: float

    @staticmethod
    def create(image_size, focal, principal, fov) -> "TumFov":
        return TumFov(float(focal[0]), float(focal[1]), float(principal[0]),
                      float(principal[1]), float(fov), float(image_size[0]),
                      float(image_size[1]))

    def scaled(self, scale) -> "TumFov":
        s = float(scale)
        return TumFov(self.fx / s, self.fy / s, self.cx / s, self.cy / s, self.fov,
                      self.width / s, self.height / s)

    def _project_core(self, p3d):
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        r_u = torch.sqrt(torch.clamp(x * x + y * y, min=1e-30))
        r_d = torch.atan2(2.0 * r_u * math.tan(self.fov / 2.0), z) / self.fov
        k = r_d / r_u
        uv = torch.stack([self.fx * k * x + self.cx, self.fy * k * y + self.cy], -1)
        # on the optical axis the limit is the principal point
        return torch.where((r_u < 1e-8)[..., None], _principal_point(self, x), uv)

    def project(self, p3d, border=BORDER_SIZE):
        uv = self._project_core(p3d)
        valid = (p3d[..., 2] >= MIN_DEPTH) & _inside_roi(uv, self.width, self.height, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        uv, valid = self.project(p3d, border)
        return uv, _jvp_jacobian(self._project_core, p3d), valid

    def unproject(self, uv):
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        r_d = torch.sqrt(torch.clamp(mx * mx + my * my, min=1e-30))
        z = 1.0 / torch.tan(r_d * self.fov)
        s = 1.0 / (2.0 * r_d * math.tan(self.fov / 2.0))
        ray = torch.stack([mx * s, my * s, z], -1)
        axis = torch.zeros_like(ray)
        axis[..., 2] = 1.0
        ray = torch.where((r_d < 1e-8)[..., None], axis, ray)
        zs = ray[..., 2:3]
        return ray / torch.where(torch.abs(zs) < 1e-9, torch.full_like(zs, 1e-9), zs)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.width, self.height, border)


class Division(NamedTuple):
    """Division fisheye model: uv = f · α(m) · m + c with
    α = (z − √(z² − 4 λ ‖xy‖²)) / (2 λ ‖xy‖²)."""

    f: float
    cx: float
    cy: float
    lam: float
    width: float
    height: float

    @staticmethod
    def create(image_size, f, principal, lam) -> "Division":
        return Division(float(f), float(principal[0]), float(principal[1]), float(lam),
                        float(image_size[0]), float(image_size[1]))

    def scaled(self, scale) -> "Division":
        s = float(scale)
        return Division(self.f / s, self.cx / s, self.cy / s, self.lam, self.width / s,
                        self.height / s)

    def _project_core(self, p3d):
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        lam_r2 = self.lam * (x * x + y * y)
        disc = torch.clamp(z * z - 4.0 * lam_r2, min=0.0)
        small = torch.abs(lam_r2) < 1e-12
        denom = torch.where(small, torch.full_like(lam_r2, 1e-12), 2.0 * lam_r2)
        alpha = (z - torch.sqrt(disc)) / denom
        # λ → 0: α = 1 / z
        alpha = torch.where(small, 1.0 / _safe_z(z), alpha)
        return torch.stack([self.f * alpha * x + self.cx, self.f * alpha * y + self.cy], -1)

    def project(self, p3d, border=BORDER_SIZE):
        uv = self._project_core(p3d)
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        disc_ok = z * z - 4.0 * self.lam * (x * x + y * y) >= 0
        valid = ((z >= MIN_DEPTH) & disc_ok
                 & _inside_roi(uv, self.width, self.height, border))
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        uv, valid = self.project(p3d, border)
        return uv, _jvp_jacobian(self._project_core, p3d), valid

    def unproject(self, uv):
        """ray = [m, 1 + λ‖m‖²], normalized to z = 1."""
        mx = (uv[..., 0] - self.cx) / self.f
        my = (uv[..., 1] - self.cy) / self.f
        z = 1.0 + self.lam * (mx * mx + my * my)
        z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        return torch.stack([mx / z_safe, my / z_safe, torch.ones_like(mx)], -1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.width, self.height, border)


class Atan(NamedTuple):
    """Theta-polynomial fisheye (the Kannala–Brandt form):
    r_d = θ · (1 + Σᵢ kᵢ θ^(i+1)),  θ = atan2(‖xy‖, z); ``poly`` = (k₁ … k_m).
    Unprojection inverts the polynomial with fixed-iteration Newton."""

    fx: float
    fy: float
    cx: float
    cy: float
    poly: tuple
    width: float
    height: float

    @staticmethod
    def create(image_size, focal, principal, poly) -> "Atan":
        return Atan(float(focal[0]), float(focal[1]), float(principal[0]),
                    float(principal[1]), tuple(float(p) for p in poly),
                    float(image_size[0]), float(image_size[1]))

    def scaled(self, scale) -> "Atan":
        s = float(scale)
        return Atan(self.fx / s, self.fy / s, self.cx / s, self.cy / s, self.poly,
                    self.width / s, self.height / s)

    def _distort(self, theta):
        acc = torch.zeros_like(theta)
        for k in reversed(self.poly):
            acc = acc * theta + k
        return theta * (1.0 + acc * theta)

    def _distort_deriv(self, theta):
        acc = torch.zeros_like(theta)
        for i in reversed(range(len(self.poly))):
            acc = acc * theta + self.poly[i] * (i + 2)
        return 1.0 + acc * theta

    def _project_core(self, p3d):
        n = torch.sqrt(torch.clamp(torch.sum(p3d * p3d, dim=-1), min=1e-30))
        ray = p3d / n[..., None]
        x, y, z = ray[..., 0], ray[..., 1], ray[..., 2]
        radius = torch.sqrt(torch.clamp(x * x + y * y, min=1e-30))
        k = self._distort(torch.atan2(radius, z)) / radius
        uv = torch.stack([self.fx * k * x + self.cx, self.fy * k * y + self.cy], -1)
        return torch.where((radius < 1e-6)[..., None], _principal_point(self, x), uv)

    def project(self, p3d, border=BORDER_SIZE):
        uv = self._project_core(p3d)
        valid = (p3d[..., 2] >= MIN_DEPTH) & _inside_roi(uv, self.width, self.height, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        uv, valid = self.project(p3d, border)
        return uv, _jvp_jacobian(self._project_core, p3d), valid

    def unproject(self, uv, newton_iters: int = 12):
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        r_d = torch.sqrt(torch.clamp(mx * mx + my * my, min=1e-30))
        theta = r_d
        for _ in range(newton_iters):
            fval = self._distort(theta) - r_d
            fprime = self._distort_deriv(theta)
            fprime = torch.where(torch.abs(fprime) < 1e-8, torch.full_like(fprime, 1e-8), fprime)
            theta = torch.clamp(theta - fval / fprime, 0.0, math.pi)
        s = torch.tan(torch.clamp(theta, 0.0, math.pi / 2 - 1e-6)) / r_d
        return torch.stack([mx * s, my * s, torch.ones_like(mx)], -1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.width, self.height, border)


class IOSCamera(NamedTuple):
    """iOS-device model: pinhole + a lookup-table radial magnifier (ARKit's
    lens-distortion table).  A pixel at scaled radius r = |f ⊙ m| moves
    radially by 1 / mag(r / R), ``mag`` the table (+1) interpolated over
    [0, R] and constant beyond, R the largest in-image radius; unprojection
    runs ``gn_iters`` Gauss-Newton steps on the z = 1 plane."""

    fx: float
    fy: float
    cx: float
    cy: float
    lut: tuple              # magnifier table (mag = lut + 1)
    max_radius: float
    width: float
    height: float

    @staticmethod
    def create(image_size, focal, principal, lut) -> "IOSCamera":
        w, h = float(image_size[0]), float(image_size[1])
        cx, cy = float(principal[0]), float(principal[1])
        # per axis max(center, size − center), the corners taken at (w, h)
        max_r = float(np.hypot(max(cx, w - cx), max(cy, h - cy)))
        return IOSCamera(float(focal[0]), float(focal[1]), cx, cy,
                         tuple(float(v) for v in np.asarray(lut).reshape(-1)), max_r, w, h)

    def scaled(self, scale) -> "IOSCamera":
        s = float(scale)
        # the table is indexed by r / R: invariant to uniform pixel scaling
        return IOSCamera(self.fx / s, self.fy / s, self.cx / s, self.cy / s, self.lut,
                         self.max_radius / s, self.width / s, self.height / s)

    def _magnifier(self, r_ratio):
        """mag(r / R) and d mag / d(r / R)."""
        lut = torch.tensor(self.lut, dtype=r_ratio.dtype, device=r_ratio.device)
        n = lut.shape[0]
        x = torch.clamp(r_ratio, 0.0, 1.0) * (n - 1)
        idx = torch.clamp(x.to(torch.int64), 0, n - 2)
        frac = x - idx.to(x.dtype)
        lo, hi = lut[idx], lut[idx + 1]
        mag = lo * (1.0 - frac) + hi * frac + 1.0
        inside = (r_ratio >= 0.0) & (r_ratio <= 1.0)
        dmag = torch.where(inside, (hi - lo) * (n - 1), torch.zeros_like(hi))
        return mag, dmag

    def _scaled_plane(self, p3d):
        z = p3d[..., 2]
        z_safe = _safe_z(z)
        sx = self.fx * p3d[..., 0] / z_safe
        sy = self.fy * p3d[..., 1] / z_safe
        return z, sx, sy, torch.sqrt(torch.clamp(sx * sx + sy * sy, min=1e-30))

    def project(self, p3d, border=BORDER_SIZE):
        z, sx, sy, r = self._scaled_plane(p3d)
        mag, _ = self._magnifier(r / self.max_radius)
        uv = torch.stack([sx / mag + self.cx, sy / mag + self.cy], -1)
        # beyond the table the last entry holds; only the image region gates
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.width, self.height, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        """Analytic Jacobian, the table's slope included."""
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        iz = 1.0 / _safe_z(z)
        sx, sy = self.fx * x * iz, self.fy * y * iz
        r = torch.sqrt(torch.clamp(sx * sx + sy * sy, min=1e-30))
        mag, dmag = self._magnifier(r / self.max_radius)
        uv = torch.stack([sx / mag + self.cx, sy / mag + self.cy], -1)
        # d(s / mag) / ds = I / mag − s sᵀ · dmag / (R r mag²)
        g = dmag / (self.max_radius * r * mag * mag)
        a00 = 1.0 / mag - g * sx * sx
        a01 = -g * sx * sy
        a11 = 1.0 / mag - g * sy * sy
        iz2 = iz * iz
        j = torch.stack([a00 * self.fx * iz, a01 * self.fy * iz,
                         -(a00 * self.fx * x + a01 * self.fy * y) * iz2,
                         a01 * self.fx * iz, a11 * self.fy * iz,
                         -(a01 * self.fx * x + a11 * self.fy * y) * iz2],
                        -1).reshape(x.shape + (2, 3))
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.width, self.height, border)
        return uv, j, valid

    def unproject(self, uv, gn_iters: int = 7):
        px = uv[..., 0] - self.cx
        py = uv[..., 1] - self.cy
        r_d = torch.sqrt(torch.clamp(px * px + py * py, min=1e-30))
        mag0, _ = self._magnifier(r_d / self.max_radius)
        mx = px * mag0 / self.fx
        my = py * mag0 / self.fy
        for _ in range(gn_iters):
            p3d = torch.stack([mx, my, torch.ones_like(mx)], -1)
            proj, jac, _ = self.project_jacobian(p3d, border=-1e9)
            rx = uv[..., 0] - proj[..., 0]
            ry = uv[..., 1] - proj[..., 1]
            a, b = jac[..., 0, 0], jac[..., 0, 1]
            c, d = jac[..., 1, 0], jac[..., 1, 1]
            det = a * d - b * c
            det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
            mx = mx + (d * rx - b * ry) / det
            my = my + (a * ry - c * rx) / det
        return torch.stack([mx, my, torch.ones_like(mx)], -1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.width, self.height, border)


CAMERA_MODELS = {"pinhole": Pinhole, "simple_radial": SimpleRadial, "tum_fov": TumFov,
                 "division": Division, "atan": Atan, "ios": IOSCamera}
