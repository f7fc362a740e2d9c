"""Error measures between a kernel's outputs and its plain version's, shared
by ``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py`` (the callers
hold them against their tolerances).  Every function returns Python floats,
so each call reads the device."""

from __future__ import annotations

import torch

from dsopp_tpu_torch.core.lie import quat_conjugate, quat_multiply


def rel_frobenius(a, b) -> float:
    """‖a − b‖ / ‖b‖ over the whole tensor (0 when both are zero)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def rel_max(a, b) -> float:
    """max |a − b| / |b| elementwise."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def align_level_errors(res_k, res_p) -> dict:
    """K3 against the plain version, worst hypothesis of the batch."""
    dq = quat_multiply(res_k.t_t_r.q.double(), quat_conjugate(res_p.t_t_r.q.double()))
    nv_k, nv_p = res_k.num_valid.double(), res_p.num_valid.double()
    return dict(
        num_valid=float(((nv_k - nv_p).abs() / nv_p.clamp(min=1.0)).max()),
        energy=rel_max(res_k.energy, res_p.energy),
        rmse=rel_max(res_k.rmse, res_p.rmse),
        rotation=float((2.0 * dq[:, 1:].norm(dim=-1)).max()),
        translation=float((res_k.t_t_r.t.double() - res_p.t_t_r.t.double()).norm(dim=-1).max()),
        affine=float((res_k.affine.double() - res_p.affine.double()).abs().max()))


def fej_errors(fej_k, fej_p) -> dict:
    """K6: relative Frobenius error of every float output; ``geom_valid``
    as the count of differing entries."""
    out = {name: rel_frobenius(getattr(fej_k, name), getattr(fej_p, name))
           for name in ("d_uv_ref", "d_uv_tgt", "d_uv_idepth", "corrected_ref", "scale0")}
    out["geom_valid_differ"] = int((fej_k.geom_valid != fej_p.geom_valid).sum())
    return out


def evaluation_errors(ev_k, ev_p, live) -> dict:
    """K7: share of ``live`` (i, j, n) groups on which ``ok`` and
    ``status_candidate`` agree, and relative Frobenius errors on the groups
    that agree and are ok."""
    agree = (ev_k.ok == ev_p.ok) & (ev_k.status_candidate == ev_p.status_candidate)
    n_live = int(live.sum())
    both = agree & ev_k.ok & ev_p.ok
    m = both[..., None]
    zero = torch.zeros((), dtype=ev_k.residuals.dtype, device=ev_k.residuals.device)
    out = dict(agree=float((agree & live).sum()) / max(n_live, 1), live=n_live,
               ok=int(ev_p.ok.sum()))
    for name in ("residuals", "gx", "gy"):
        out[name] = rel_frobenius(torch.where(m, getattr(ev_k, name), zero),
                                  torch.where(m, getattr(ev_p, name), zero))
    for name in ("energy_patch", "weight"):
        out[name] = rel_frobenius(torch.where(both, getattr(ev_k, name), zero),
                                  torch.where(both, getattr(ev_p, name), zero))
    return out


def linear_system_errors(sys_k, sys_p) -> dict:
    """K8: relative Frobenius error of every output."""
    return {name: rel_frobenius(getattr(sys_k, name), getattr(sys_p, name))
            for name in sys_p._fields}
