"""Two-view and multi-view geometry of the bootstrap (counterpart of
``dsopp_tpu/fbs/geometry.py``).

The host functions (``essential_8pt`` … ``ransac_pnp``,
``AutocalibrationSelector``) are numpy copies of the JAX package's, with
the same seeded ``default_rng``, so their results are equal.  The SO3×S2
Sampson refinement (``sampson_distance_pixels``, ``so3xs2_refine``) runs
in torch on the caller's device: a Levenberg–Marquardt loop of fixed length
with the Jacobian in closed form, the JAX function's accept / reject rule
and λ schedule, in the dtype the caller asks for (f64 by default).

Every function takes **normalized image coordinates** (z = 1 rays) but the
refinement, which takes principal-point-centred pixels.
"""

from __future__ import annotations

import numpy as np
import torch


def _normalize_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Essential matrix (8-point) + decomposition
# ---------------------------------------------------------------------------

def essential_8pt(m1, m2):
    """Least-squares essential matrix from ≥8 normalized correspondences.

    ``m1``/``m2``: [N, 2] normalized coords in view 1 / view 2 with
    m2ᵀ E m1 = 0.  Returns E with the (1, 1, 0) singular-value projection.
    """
    x1, y1 = m1[:, 0], m1[:, 1]
    x2, y2 = m2[:, 0], m2[:, 1]
    a = np.stack([
        x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1),
    ], axis=1)
    _, _, vt = np.linalg.svd(a)
    e = vt[-1].reshape(3, 3)
    u, s, vt = np.linalg.svd(e)
    return u @ np.diag([1.0, 1.0, 0.0]) @ vt


def sampson_distance(e, m1, m2):
    """First-order geometric (Sampson) distance of correspondences to E."""
    p1 = np.concatenate([m1, np.ones((len(m1), 1))], axis=1)
    p2 = np.concatenate([m2, np.ones((len(m2), 1))], axis=1)
    ep1 = p1 @ e.T            # E x1
    etp2 = p2 @ e              # Eᵀ x2
    num = np.sum(p2 * ep1, axis=1) ** 2
    den = ep1[:, 0] ** 2 + ep1[:, 1] ** 2 + etp2[:, 0] ** 2 + etp2[:, 1] ** 2
    return num / np.maximum(den, 1e-18)


def ransac_essential(m1, m2, threshold, iterations=300, seed=0):
    """→ (E, inlier mask).  threshold in normalized-coordinate units."""
    rng = np.random.default_rng(seed)
    n = len(m1)
    best_e, best_inliers = None, np.zeros(n, bool)
    if n < 8:
        return None, best_inliers
    thr2 = threshold * threshold
    for _ in range(iterations):
        idx = rng.choice(n, 8, replace=False)
        try:
            e = essential_8pt(m1[idx], m2[idx])
        except np.linalg.LinAlgError:
            continue
        inliers = sampson_distance(e, m1, m2) < thr2
        if inliers.sum() > best_inliers.sum():
            best_inliers = inliers
            best_e = e
    if best_e is not None and best_inliers.sum() >= 8:
        best_e = essential_8pt(m1[best_inliers], m2[best_inliers])
        best_inliers = sampson_distance(best_e, m1, m2) < thr2
    return best_e, best_inliers


def decompose_essential(e, m1, m2):
    """E → (R, t) with the cheirality check (most points in front).

    Returns (r, t, mask) mapping view-1 coords into view 2:
    x2 ∝ R x1 + t, ‖t‖ = 1.
    """
    u, _, vt = np.linalg.svd(e)
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    w = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    candidates = []
    for r in (u @ w @ vt, u @ w.T @ vt):
        for t in (u[:, 2], -u[:, 2]):
            pts, valid = triangulate(r, t, m1, m2)
            candidates.append((valid.sum(), r, t, pts, valid))
    candidates.sort(key=lambda c: -c[0])
    _, r, t, pts, valid = candidates[0]
    return r, t, pts, valid


def triangulate(r, t, m1, m2):
    """Midpoint-free DLT triangulation in view-1 frame.

    x2 ∝ R x1 + t.  Returns ([N, 3] points, in-front-of-both mask).
    """
    n = len(m1)
    pts = np.zeros((n, 3))
    p1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    p2 = np.hstack([r, t.reshape(3, 1)])
    for i in range(n):
        a = np.stack([
            m1[i, 0] * p1[2] - p1[0],
            m1[i, 1] * p1[2] - p1[1],
            m2[i, 0] * p2[2] - p2[0],
            m2[i, 1] * p2[2] - p2[1],
        ])
        _, _, vt = np.linalg.svd(a)
        x = vt[-1]
        pts[i] = x[:3] / x[3] if abs(x[3]) > 1e-12 else np.full(3, np.nan)
    z1 = pts[:, 2]
    z2 = (pts @ r.T + t)[:, 2]
    valid = np.isfinite(z1) & (z1 > 1e-6) & (z2 > 1e-6)
    return pts, valid


# ---------------------------------------------------------------------------
# Rotation-only fit (standstill detection)
# ---------------------------------------------------------------------------

def so3_fit(m1, m2):
    """Best rotation aligning bearing vectors (Kabsch)."""
    v1 = _normalize_rows(np.concatenate([m1, np.ones((len(m1), 1))], axis=1))
    v2 = _normalize_rows(np.concatenate([m2, np.ones((len(m2), 1))], axis=1))
    h = v1.T @ v2
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    return vt.T @ np.diag([1.0, 1.0, d]) @ u.T


def so3_inlier_ratio(m1, m2, threshold, iterations=100, seed=0):
    """Fraction of correspondences explained by pure rotation
    (reference estimate_so3_inlier_count — standstill RANSAC)."""
    rng = np.random.default_rng(seed)
    n = len(m1)
    if n < 2:
        return 1.0
    v1 = _normalize_rows(np.concatenate([m1, np.ones((n, 1))], axis=1))
    v2 = _normalize_rows(np.concatenate([m2, np.ones((n, 1))], axis=1))
    best = 0
    for _ in range(iterations):
        idx = rng.choice(n, min(2, n), replace=False)
        r = so3_fit(m1[idx], m2[idx])
        rot = v1 @ r.T
        # angular reprojection error on the normalized plane
        proj = rot[:, :2] / np.maximum(rot[:, 2:3], 1e-9)
        err = np.linalg.norm(proj - m2, axis=1)
        best = max(best, int((err < threshold).sum()))
    return best / n


# ---------------------------------------------------------------------------
# PnP (DLT minimal solver + RANSAC)
# ---------------------------------------------------------------------------

def pnp_dlt(points3d, m):
    """DLT pose from ≥6 3D–2D correspondences → (R, t): x ∝ R X + t."""
    n = len(points3d)
    a = np.zeros((2 * n, 12))
    for i, (X, u) in enumerate(zip(points3d, m)):
        xh = np.append(X, 1.0)
        a[2 * i, 0:4] = xh
        a[2 * i, 8:12] = -u[0] * xh
        a[2 * i + 1, 4:8] = xh
        a[2 * i + 1, 8:12] = -u[1] * xh
    _, _, vt = np.linalg.svd(a)
    p = vt[-1].reshape(3, 4)
    r_raw = p[:, :3]
    u_, s_, vt_ = np.linalg.svd(r_raw)
    r = u_ @ vt_
    scale = np.mean(s_)
    if np.linalg.det(r) < 0:
        r = -r
        scale = -scale
    t = p[:, 3] / scale
    return r, t


def ransac_pnp(points3d, m, threshold, iterations=200, seed=0):
    """→ (R, t, inlier mask): robust camera pose from 3D–2D matches."""
    rng = np.random.default_rng(seed)
    n = len(points3d)
    best = (None, None, np.zeros(n, bool))
    if n < 6:
        return best
    for _ in range(iterations):
        idx = rng.choice(n, 6, replace=False)
        try:
            r, t = pnp_dlt(points3d[idx], m[idx])
        except np.linalg.LinAlgError:
            continue
        cam = points3d @ r.T + t
        ok_z = cam[:, 2] > 1e-6
        proj = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-9)
        err = np.linalg.norm(proj - m, axis=1)
        inliers = ok_z & (err < threshold)
        if inliers.sum() > best[2].sum():
            best = (r, t, inliers)
    r, t, inliers = best
    if r is not None and inliers.sum() >= 6:
        r, t = pnp_dlt(points3d[inliers], m[inliers])
        cam = points3d @ r.T + t
        proj = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-9)
        err = np.linalg.norm(proj - m, axis=1)
        inliers = (cam[:, 2] > 1e-6) & (err < threshold)
    return r, t, inliers


# ---------------------------------------------------------------------------
# SO3×S2 Sampson refinement (+ focal autocalibration)
# ---------------------------------------------------------------------------

def sampson_distance_pixels(e, pc_ref, pc_tgt, inv_focal):
    """Sampson residual in pixels of principal-point-centred pixel coords
    [..., 2] under the essential matrix ``e``."""
    _, _, _, _, top, bottom = _sampson_terms(e, pc_ref, pc_tgt, inv_focal)
    return torch.where(bottom < 1e-16, top, top / torch.sqrt(torch.clamp(bottom, min=1e-16)))


def _hat(v):
    """[..., 3] → skew matrices [..., 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    m = torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0], -v[..., 1], v[..., 0], z],
                    dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _rodrigues(w):
    # series-safe at w = 0, as the JAX function writes it
    th2 = torch.sum(w * w)
    th = torch.sqrt(th2 + 1e-30)
    a = torch.sin(th) / th
    b = (1.0 - torch.cos(th)) / (th2 + 1e-30)
    k = _hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * k + b * (k @ k)


def _sampson_terms(e, pc_ref, pc_tgt, inv_focal):
    """The pieces of the pixel Sampson distance: (rays, er = E r, te = Eᵀ t,
    top, bottom)."""
    ones = torch.ones(pc_ref.shape[:-1] + (1,), dtype=pc_ref.dtype, device=pc_ref.device)
    r = torch.cat([pc_ref * inv_focal, ones], dim=-1)
    t = torch.cat([pc_tgt * inv_focal, ones], dim=-1)
    er = r @ e.T
    te = t @ e
    top = torch.sum(t * er, dim=-1)
    bottom = (torch.sum((er[..., :2] * inv_focal) ** 2, dim=-1)
              + torch.sum((te[..., :2] * inv_focal) ** 2, dim=-1))
    return r, t, er, te, top, bottom


def _sampson_jacobian(e, de, pc_ref, pc_tgt, focal, optimize_focal):
    """Residuals [N] and their Jacobian [N, P] at the current estimate: the
    residual of ``sampson_distance_pixels``, its derivative along each
    ``de`` [P', 3, 3] (dE of the rotation's and the direction's increments),
    and along the focal length when it is optimized."""
    u = 1.0 / focal
    r, t, er, te, top, bottom = _sampson_terms(e, pc_ref, pc_tgt, u)
    der = torch.einsum("pij,nj->pni", de, r)
    dte = torch.einsum("pji,nj->pni", de, t)
    dtop = torch.sum(t * der, dim=-1)
    dbottom = 2.0 * u * u * (torch.sum(er[..., :2] * der[..., :2], dim=-1)
                             + torch.sum(te[..., :2] * dte[..., :2], dim=-1))
    if optimize_focal:
        du = -u * u
        z = torch.zeros_like(pc_ref[..., :1])
        dr = torch.cat([pc_ref, z], dim=-1) * du
        dt = torch.cat([pc_tgt, z], dim=-1) * du
        der_f, dte_f = dr @ e.T, dt @ e
        dtop_f = torch.sum(dt * er + t * der_f, dim=-1)
        sq = torch.sum(er[..., :2] ** 2, dim=-1) + torch.sum(te[..., :2] ** 2, dim=-1)
        dbottom_f = 2.0 * u * du * sq + 2.0 * u * u * (
            torch.sum(er[..., :2] * der_f[..., :2], dim=-1)
            + torch.sum(te[..., :2] * dte_f[..., :2], dim=-1))
        dtop = torch.cat([dtop, dtop_f[None]])
        dbottom = torch.cat([dbottom, dbottom_f[None]])
    small = bottom < 1e-16
    s = torch.sqrt(torch.clamp(bottom, min=1e-16))
    res = torch.where(small, top, top / s)
    jac = torch.where(small, dtop, dtop / s - top * dbottom / (2.0 * s * s * s))
    return res, jac.T


def _moved(params, r_c, t_c, f_c, optimize_focal):
    """(R, t, f) moved by ``params``: R_c · exp(w), t_c ⊞ δ on S2, f + df."""
    from dsopp_tpu_torch.solvers.s2 import s2_plus

    r = r_c @ _rodrigues(params[:3])
    t = s2_plus(t_c, params[3:5])
    f = f_c + params[5] if optimize_focal else f_c + 0.0
    return r, t, f


def so3xs2_refine(pc_ref, pc_tgt, r0, t0, focal, threshold, optimize_focal=False,
                  iterations=40, dtype=torch.float64, device=None):
    """Refine (R, unit t[, focal]) by Huber'd Sampson distances in pixels
    (``threshold`` px): the rotation by a right increment, the direction on
    S2 (``solvers/s2.py``), LM with λ from 1e-4, halved on an accepted step
    and quadrupled on a rejected one, ``iterations`` steps with no host read
    inside; the Jacobian in closed form (the JAX function takes it by
    ``jax.jacfwd``).  ``optimize_focal`` adds the focal length
    (autocalibration).

    ``pc_ref``/``pc_tgt``: [N, 2] principal-point-centred pixel coords.
    Runs on ``device`` (``None``: the CUDA card).  Returns (r [3, 3],
    t_unit [3], focal, rms_px) on the host."""
    from dsopp_tpu_torch import default_device
    from dsopp_tpu_torch.solvers.s2 import s2_plus, s2_plus_jacobian

    d = dict(dtype=dtype, device=default_device(device))
    pc_ref = torch.as_tensor(np.asarray(pc_ref), **d)
    pc_tgt = torch.as_tensor(np.asarray(pc_tgt), **d)
    r_cur = torch.as_tensor(np.asarray(r0), **d)
    t_cur = torch.as_tensor(np.asarray(t0), **d)
    t_cur = t_cur / torch.linalg.norm(t_cur)
    f_cur = torch.as_tensor(float(focal), **d)
    thr = torch.as_tensor(float(threshold), **d)
    n_par = 6 if optimize_focal else 5
    basis = _hat(torch.eye(3, **d))                  # d exp(w)/dw_k at 0

    def energy(r, t, f):
        # at zero increment, as the JAX loop evaluates it (exp(0) = I exactly)
        res = sampson_distance_pixels(_hat(s2_plus(t, zero2)) @ r, pc_ref, pc_tgt, 1.0 / f)
        ab = torch.abs(res)
        return torch.sum(torch.where(ab <= thr, res * res, 2.0 * thr * ab - thr * thr))

    zero2 = torch.zeros(2, **d)
    e = energy(r_cur, t_cur, f_cur)
    lam = torch.as_tensor(1e-4, **d)
    eye = torch.eye(n_par, **d)
    for _ in range(iterations):
        # the residuals at zero increment, as the JAX loop evaluates them
        hat_t = _hat(s2_plus(t_cur, zero2))
        de = torch.cat([hat_t @ r_cur @ basis,
                        _hat(s2_plus_jacobian(t_cur).T) @ r_cur])
        res, j = _sampson_jacobian(hat_t @ r_cur, de, pc_ref, pc_tgt, f_cur, optimize_focal)
        ab = torch.abs(res)
        w = torch.where(ab <= thr, torch.ones_like(res), thr / torch.clamp(ab, min=1e-30))
        jw = j * w[:, None]
        h = jw.T @ j
        g = jw.T @ res
        h_d = h + lam * torch.diag(torch.diagonal(h)) + 1e-18 * eye
        step = -torch.linalg.solve_ex(h_d, g)[0]   # info unread: no host sync
        step = torch.where(torch.isfinite(step), step, torch.zeros_like(step))
        r_n, t_n, f_n = _moved(step, r_cur, t_cur, f_cur, optimize_focal)
        e_n = energy(r_n, t_n, f_n)
        acc = e_n < e
        r_cur = torch.where(acc, r_n, r_cur)
        t_cur = torch.where(acc, t_n, t_cur)
        f_cur = torch.where(acc, f_n, f_cur)
        e = torch.where(acc, e_n, e)
        lam = torch.where(acc, lam * 0.5, lam * 4.0)
    rms = torch.sqrt(e / max(len(pc_ref), 1))
    return (r_cur.cpu().numpy(), t_cur.cpu().numpy(), float(f_cur), float(rms))


class AutocalibrationSelector:
    """Aggregates per-pair autocalibration estimates and selects the robust
    consensus (reference autocalibration_selector.hpp — implementation
    hidden; median selection re-derived)."""

    def __init__(self):
        self.focal_lengths = []
        self.k1 = []
        self.k2 = []

    def add_result(self, focal_length, k=(0.0, 0.0)):
        self.focal_lengths.append(float(focal_length))
        self.k1.append(float(k[0]))
        self.k2.append(float(k[1]))

    def reset(self):
        self.focal_lengths.clear()
        self.k1.clear()
        self.k2.clear()

    def get_focal_length(self):
        return float(np.median(self.focal_lengths))

    def get_distortion_coeffs(self):
        return np.array([np.median(self.k1), np.median(self.k2)])

    def __len__(self):
        return len(self.focal_lengths)
