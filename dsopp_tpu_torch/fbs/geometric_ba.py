"""Geometric (reprojection-error) bundle adjustment of the bootstrap
(counterpart of ``dsopp_tpu/fbs/geometric_ba.py``, a numpy copy of it):
Levenberg–Marquardt over poses and points with the point-block Schur
complement (``refine``), and the joint pose / structure / pinhole
intrinsics refinement behind ``--refine_calibration``
(``refine_intrinsics``).  The sizes are a few frames × a few hundred
points, so it runs on the host.

Conventions: poses are world→camera (x_c = R X + t); normalized image
coordinates; frame 0 is fixed (gauge); the scale is re-normalized after the
solve to keep the first baseline.
"""

from __future__ import annotations

import numpy as np


def _so3_exp(w):
    theta = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-12:
        return np.eye(3) + k
    return (np.eye(3) + np.sin(theta) / theta * k
            + (1 - np.cos(theta)) / theta ** 2 * k @ k)


def _hat(v):
    out = np.zeros(v.shape[:-1] + (3, 3))
    out[..., 0, 1] = -v[..., 2]
    out[..., 0, 2] = v[..., 1]
    out[..., 1, 0] = v[..., 2]
    out[..., 1, 2] = -v[..., 0]
    out[..., 2, 0] = -v[..., 1]
    out[..., 2, 1] = v[..., 0]
    return out


def refine(poses_r, poses_t, points, obs_frame, obs_point, obs_m,
           huber=2e-3, iterations=15, fix_intrinsics=True):
    """LM refinement of poses + points.

    ``poses_r`` [F,3,3], ``poses_t`` [F,3] world→cam; ``points`` [P,3];
    observations: frame idx [M], point idx [M], measurement [M,2]
    (normalized coords).  Returns refined (poses_r, poses_t, points,
    final rms).
    """
    del fix_intrinsics
    f = len(poses_r)
    p = len(points)
    poses_r = poses_r.copy()
    poses_t = poses_t.copy()
    points = points.copy()
    lam = 1e-4
    baseline0 = np.linalg.norm(poses_t[-1]) or 1.0

    def residuals():
        cam = np.einsum("mij,mj->mi", poses_r[obs_frame], points[obs_point]) \
            + poses_t[obs_frame]
        z = np.maximum(cam[:, 2], 1e-9)
        proj = cam[:, :2] / z[:, None]
        r = proj - obs_m
        return r, cam

    def energy(r):
        n = np.linalg.norm(r, axis=1)
        e = np.where(n < huber, 0.5 * n ** 2, huber * n - 0.5 * huber ** 2)
        return e.sum()

    r, cam = residuals()
    e_prev = energy(r)

    for _ in range(iterations):
        # weights (IRLS huber)
        n = np.linalg.norm(r, axis=1)
        w = np.where(n < huber, 1.0, huber / np.maximum(n, 1e-18))

        z = np.maximum(cam[:, 2], 1e-9)
        iz = 1.0 / z
        # d proj / d cam
        j_proj = np.zeros((len(r), 2, 3))
        j_proj[:, 0, 0] = iz
        j_proj[:, 1, 1] = iz
        j_proj[:, 0, 2] = -cam[:, 0] * iz * iz
        j_proj[:, 1, 2] = -cam[:, 1] * iz * iz

        # d cam / d pose (left increment: δt, δω) and d cam / d point
        j_pose = np.concatenate(
            [np.broadcast_to(np.eye(3), (len(r), 3, 3)), -_hat(cam)], axis=2)
        j_p = np.einsum("mab,mbc->mac", j_proj, j_pose)       # [M,2,6]
        j_x = np.einsum("mab,mbc->mac", j_proj, poses_r[obs_frame])  # [M,2,3]

        # assemble H blocks
        hw = w[:, None, None]
        h_pp = np.zeros((f, 6, 6))
        b_p = np.zeros((f, 6))
        h_ll = np.zeros((p, 3, 3))
        b_l = np.zeros((p, 3))
        h_pl = np.zeros((f, p, 6, 3))

        np.add.at(h_pp, obs_frame, hw * np.einsum("mab,mac->mbc", j_p, j_p))
        np.add.at(b_p, obs_frame, np.einsum("mab,ma->mb", j_p, w[:, None] * r))
        np.add.at(h_ll, obs_point, hw * np.einsum("mab,mac->mbc", j_x, j_x))
        np.add.at(b_l, obs_point, np.einsum("mab,ma->mb", j_x, w[:, None] * r))
        np.add.at(h_pl, (obs_frame, obs_point),
                  hw * np.einsum("mab,mac->mbc", j_p, j_x))

        # LM damping + fixed frame 0
        h_pp += lam * np.eye(6) * np.maximum(
            np.einsum("fii->f", h_pp), 1e-9)[:, None, None] / 6.0
        h_ll_d = h_ll + lam * np.eye(3) * np.maximum(
            np.einsum("pii->p", h_ll), 1e-9)[:, None, None] / 3.0
        h_pp[0] += np.eye(6) * 1e12

        # Schur: eliminate points
        h_ll_inv = np.linalg.pinv(h_ll_d)
        # S = H_pp − Σ_l H_pl H_ll⁻¹ H_plᵀ (block over frame pairs)
        hpl_inv = np.einsum("fpab,pbc->fpac", h_pl, h_ll_inv)   # [F,P,6,3]
        s = np.zeros((f * 6, f * 6))
        for a in range(f):
            for b in range(f):
                blk = np.einsum("pac,pbc->ab", hpl_inv[a], h_pl[b])
                s[a * 6:(a + 1) * 6, b * 6:(b + 1) * 6] -= blk
        for a in range(f):
            s[a * 6:(a + 1) * 6, a * 6:(a + 1) * 6] += h_pp[a]
        rhs = (b_p - np.einsum("fpac,pc->fa", hpl_inv, b_l)).reshape(-1)

        try:
            delta_p = -np.linalg.solve(s, rhs).reshape(f, 6)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        delta_x = -np.einsum(
            "pab,pb->pa", h_ll_inv,
            b_l + np.einsum("fpab,fa->pb", h_pl, delta_p))

        # apply
        new_r = poses_r.copy()
        new_t = poses_t.copy()
        for i in range(f):
            rot = _so3_exp(delta_p[i, 3:])
            new_r[i] = rot @ poses_r[i]
            new_t[i] = rot @ poses_t[i] + delta_p[i, :3]
        new_pts = points + delta_x

        cam_new = np.einsum("mij,mj->mi", new_r[obs_frame], new_pts[obs_point]) \
            + new_t[obs_frame]
        zb = np.maximum(cam_new[:, 2], 1e-9)
        r_new = cam_new[:, :2] / zb[:, None] - obs_m
        e_new = energy(r_new)
        if e_new < e_prev:
            poses_r, poses_t, points = new_r, new_t, new_pts
            r, cam = r_new, cam_new
            if abs(e_prev - e_new) / max(e_prev, 1e-18) < 1e-8:
                e_prev = e_new
                break
            e_prev = e_new
            lam = max(lam / 2, 1e-8)
        else:
            lam *= 10

    # re-normalize scale (monocular gauge)
    scale = baseline0 / max(np.linalg.norm(poses_t[-1]), 1e-12)
    poses_t *= scale
    points *= scale
    rms = np.sqrt(np.mean(np.sum(r ** 2, axis=1)))
    return poses_r, poses_t, points, rms


def refine_intrinsics(poses_r, poses_t, points, obs_frame, obs_point, obs_px,
                      fx, fy, cx, cy, fix_focal=False, fix_center=False,
                      iterations=30, huber_px=2.0):
    """Joint pose/structure/intrinsics LM (pinhole, pixel residuals).

    The calibration-refinement path behind the reference's
    ``--refine_calibration`` app flag (dsopp_main.cpp:30), wired to the
    geometric BA's intrinsics flags
    (ceres_geometric_bundle_adjustment.hpp:16-35 fix_focal/fix_center).
    One SHARED intrinsics block g = (fx, fy, cx, cy) joins the frame side
    of the point-Schur reduced system — alternation cannot work here (the
    free structure absorbs any re-normalization, leaving zero gradient on
    the intrinsics), so the solve is joint.

    ``obs_px``: [M, 2] PIXEL measurements.  Returns
    (poses_r, poses_t, points, (fx, fy, cx, cy), rms_px).
    """
    f = len(poses_r)
    p = len(points)
    poses_r = poses_r.copy()
    poses_t = poses_t.copy()
    points = points.copy()
    g = np.array([float(fx), float(fy), float(cx), float(cy)])
    lam = 1e-4

    def project(pr, pt, pts, gg):
        cam = np.einsum("mij,mj->mi", pr[obs_frame], pts[obs_point]) \
            + pt[obs_frame]
        z = np.maximum(cam[:, 2], 1e-9)
        xn = cam[:, :2] / z[:, None]
        r = xn * gg[:2] + gg[2:] - obs_px
        return r, cam, xn

    def energy(r):
        n = np.linalg.norm(r, axis=1)
        e = np.where(n < huber_px, 0.5 * n ** 2,
                     huber_px * n - 0.5 * huber_px ** 2)
        return e.sum()

    r, cam, xn = project(poses_r, poses_t, points, g)
    e_prev = energy(r)

    for _ in range(iterations):
        n = np.linalg.norm(r, axis=1)
        w = np.where(n < huber_px, 1.0, huber_px / np.maximum(n, 1e-18))
        z = np.maximum(cam[:, 2], 1e-9)
        iz = 1.0 / z
        # d(pixel residual)/d cam = diag(fx, fy) · d proj / d cam
        j_proj = np.zeros((len(r), 2, 3))
        j_proj[:, 0, 0] = g[0] * iz
        j_proj[:, 1, 1] = g[1] * iz
        j_proj[:, 0, 2] = -g[0] * cam[:, 0] * iz * iz
        j_proj[:, 1, 2] = -g[1] * cam[:, 1] * iz * iz
        j_pose = np.concatenate(
            [np.broadcast_to(np.eye(3), (len(r), 3, 3)), -_hat(cam)], axis=2)
        j_p = np.einsum("mab,mbc->mac", j_proj, j_pose)            # [M,2,6]
        j_x = np.einsum("mab,mbc->mac", j_proj, poses_r[obs_frame])  # [M,2,3]
        j_g = np.zeros((len(r), 2, 4))                              # intr
        j_g[:, 0, 0] = xn[:, 0]
        j_g[:, 1, 1] = xn[:, 1]
        j_g[:, 0, 2] = 1.0
        j_g[:, 1, 3] = 1.0

        # frame-side block = [pose blocks | shared intrinsics block]
        d = 6 * f + 4
        hw = w[:, None, None]
        h_ll = np.zeros((p, 3, 3))
        b_l = np.zeros((p, 3))
        np.add.at(h_ll, obs_point, hw * np.einsum("mab,mac->mbc", j_x, j_x))
        np.add.at(b_l, obs_point, np.einsum("mab,ma->mb", j_x, w[:, None] * r))

        h_ff = np.zeros((d, d))
        b_f = np.zeros(d)
        h_fl = np.zeros((p, d, 3))
        for a in range(f):
            m = obs_frame == a
            sl = slice(a * 6, a * 6 + 6)
            jp = j_p[m]
            wm = w[m]
            h_ff[sl, sl] += np.einsum("mab,mac,m->bc", jp, jp, wm)
            h_ff[sl, 6 * f:] += np.einsum("mab,mac,m->bc", jp, j_g[m], wm)
            b_f[sl] += np.einsum("mab,ma,m->b", jp, r[m], wm)
            np.add.at(h_fl[:, sl, :], obs_point[m],
                      wm[:, None, None] * np.einsum("mab,mac->mbc", jp, j_x[m]))
        h_ff[6 * f:, :6 * f] = h_ff[:6 * f, 6 * f:].T
        h_ff[6 * f:, 6 * f:] += np.einsum("mab,mac,m->bc", j_g, j_g, w)
        b_f[6 * f:] += np.einsum("mab,ma,m->b", j_g, r, w)
        np.add.at(h_fl[:, 6 * f:, :], obs_point,
                  hw * np.einsum("mab,mac->mbc", j_g, j_x))

        # damping + gauges: frame 0 fixed; fixed intrinsics via huge reg
        diag = np.maximum(np.diag(h_ff), 1e-9)
        h_ff[np.arange(d), np.arange(d)] += lam * diag
        h_ff[:6, :6] += np.eye(6) * 1e12
        if fix_focal:
            h_ff[6 * f, 6 * f] += 1e18
            h_ff[6 * f + 1, 6 * f + 1] += 1e18
        if fix_center:
            h_ff[6 * f + 2, 6 * f + 2] += 1e18
            h_ff[6 * f + 3, 6 * f + 3] += 1e18
        h_ll_d = h_ll + lam * np.eye(3) * np.maximum(
            np.einsum("pii->p", h_ll), 1e-9)[:, None, None] / 3.0

        h_ll_inv = np.linalg.pinv(h_ll_d)
        hfl_inv = np.einsum("pab,pbc->pac", h_fl, h_ll_inv)        # [P,d,3]
        s = h_ff - np.einsum("pac,pbc->ab", hfl_inv, h_fl)
        rhs = b_f - np.einsum("pac,pc->a", hfl_inv, b_l)
        try:
            delta_f = -np.linalg.solve(s, rhs)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        delta_x = -np.einsum(
            "pab,pb->pa", h_ll_inv,
            b_l + np.einsum("pab,a->pb", h_fl, delta_f))

        new_r = poses_r.copy()
        new_t = poses_t.copy()
        for i in range(f):
            rot = _so3_exp(delta_f[i * 6 + 3:i * 6 + 6])
            new_r[i] = rot @ poses_r[i]
            new_t[i] = rot @ poses_t[i] + delta_f[i * 6:i * 6 + 3]
        new_pts = points + delta_x
        new_g = g + delta_f[6 * f:]

        r_new, cam_new, xn_new = project(new_r, new_t, new_pts, new_g)
        e_new = energy(r_new)
        if e_new < e_prev:
            poses_r, poses_t, points, g = new_r, new_t, new_pts, new_g
            r, cam, xn = r_new, cam_new, xn_new
            converged = abs(e_prev - e_new) / max(e_prev, 1e-18) < 1e-10
            e_prev = e_new
            lam = max(lam / 2, 1e-9)
            if converged:
                break
        else:
            lam *= 10

    rms_px = float(np.sqrt(np.mean(np.sum(r ** 2, axis=1))))
    return (poses_r, poses_t, points,
            (float(g[0]), float(g[1]), float(g[2]), float(g[3])), rms_px)
