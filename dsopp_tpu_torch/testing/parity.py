"""Error measures between a kernel's outputs and its plain version's, shared
by ``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py`` (the callers
hold them against their tolerances).  Every function returns Python floats,
so each call reads the device."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from dsopp_tpu_torch.core.lie import SE3, quat_conjugate, quat_multiply
from dsopp_tpu_torch.core.reproject import reproject
from dsopp_tpu_torch.features.pyramid import build_channel_map, build_pyramid_maps
from dsopp_tpu_torch.solvers.linear import pinv_rtol
from dsopp_tpu_torch.solvers.pba import (BLOCK, LEDGER_DTYPE, RES_OOB, LinearSystem,
                                         _assemble_step_system, _marginalize_plain,
                                         _prior_system, frame_count, newest_slot,
                                         push_frame_slot)
from dsopp_tpu_torch.testing.blocked_lu import unblocked_solve
from dsopp_tpu_torch.tracker import depth_estimation as de
from dsopp_tpu_torch.tracker.depth_estimation import estimate_depths
from dsopp_tpu_torch.tracker.depth_map import _older_landmarks
from dsopp_tpu_torch.tracker.fused_keyframe import immature_bank, set_bank
from dsopp_tpu_torch.tracker.marginalization import (EPS_DIST, KEEP_FRAMES_FROM_END,
                                                     MIN_FRAME_AGE, eq20_scores,
                                                     kept_first_perm, landmark_triage)


def to_f64(obj):
    """A window or a tuple of tensors with every float tensor in float64: the
    same inputs for a plain version run in double arithmetic."""
    cast = lambda t: t.double() if t is not None and t.is_floating_point() else t  # noqa: E731
    if dataclasses.is_dataclass(obj):
        return obj.replace(**{f.name: cast(getattr(obj, f.name))
                              for f in dataclasses.fields(obj)})
    return type(obj)(*(cast(t) for t in obj))


def moved(obj, device):
    """A tracker state (tensors in named tuples, tuples and dataclasses) with
    every tensor copied to ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: moved(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        items = [moved(x, device) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def contiguous(tensors):
    """A tuple of tensors, each dense: a plain version may return permuted
    views, the kernels' wrappers take dense tensors only."""
    return type(tensors)(*(t.contiguous() for t in tensors))


def scaled_ledger(window, sys, share: float = 0.1):
    """``window`` with a ledger that is ``share`` of its own Schur-reduced
    pose system (symmetrised, live frames only): a filled ledger of the
    window's own scale for a window whose frames were never marginalized."""
    live = torch.repeat_interleave(window.frame_valid & ~window.frame_fixed, 8)
    h = (sys.h_pose - sys.h_schur).double()
    h = share * 0.5 * (h + h.T) * (live[:, None] & live[None, :])
    return window.replace(h_marg=h.contiguous(), b_marg=torch.zeros_like(window.b_marg),
                          energy_marg=torch.zeros_like(window.energy_marg))


def rel_frobenius(a, b) -> float:
    """‖a − b‖ / ‖b‖ over the whole tensor (0 when both are zero)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def rel_max(a, b) -> float:
    """max |a − b| / |b| elementwise."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def align_level_errors(res_k, res_p) -> dict:
    """K3 against the plain version: per-hypothesis errors [B] (``rotation``,
    ``translation``, ``affine``) and the worst relative ``num_valid``,
    ``energy`` and ``rmse`` of the batch."""
    dq = quat_multiply(res_k.t_t_r.q.double(), quat_conjugate(res_p.t_t_r.q.double()))
    nv_k, nv_p = res_k.num_valid.double(), res_p.num_valid.double()
    return dict(
        num_valid=float(((nv_k - nv_p).abs() / nv_p.clamp(min=1.0)).max()),
        energy=rel_max(res_k.energy, res_p.energy),
        rmse=rel_max(res_k.rmse, res_p.rmse),
        rotation=2.0 * dq[:, 1:].norm(dim=-1),
        translation=(res_k.t_t_r.t.double() - res_p.t_t_r.t.double()).norm(dim=-1),
        affine=(res_k.affine.double() - res_p.affine.double()).abs().amax(dim=-1))


def align_level_equal(res_a, res_b) -> bool:
    """Two K3 results equal to the bit, field by field."""
    fields = lambda r: (r.t_t_r.q, r.t_t_r.t, r.affine, r.energy, r.num_valid,  # noqa: E731
                        r.rmse, r.iterations)
    return all(torch.equal(a, b) for a, b in zip(fields(res_a), fields(res_b)))


# K3's LM loop decides by the relative change of the energy at a trial, against
# 0 (accept) and against the function tolerance (done).  In f32 a trial energy
# sits up to 7.3e-6 of itself from the f64 one computed from the same state
# (``testing/align_trace.py`` on an H100), so two f32 loops whose changes
# differ by less than this and fall on either side of a limit part at a
# rounding tie
ALIGN_TIE = 2e-5


def align_level_partings(trace_k, trace_p, function_tolerance: float) -> list:
    """The hypotheses whose LM loops decide differently in the kernel and in
    the plain version, from their decision traces ([B, passes, 5]: energy
    before, trial energy, λ before, |step|², accept + 2·done; NaN where the loop
    had ended) → one dict each: ``hypothesis``, the first ``pass`` at which the
    flags differ, both rows of that pass, and ``tie``: both loops stood at the
    same λ, their relative changes of the energy differ by at most
    ``ALIGN_TIE``, and they fall on either side of the limit of the decision
    that flipped (accept: 0; else done: ``function_tolerance``)."""
    tk, tp = trace_k.double().cpu(), trace_p.double().cpu()
    passes = max(tk.shape[1], tp.shape[1])
    pad = lambda t: torch.cat([t, torch.full(  # noqa: E731
        (t.shape[0], passes - t.shape[1], t.shape[2]), float("nan"), dtype=t.dtype)], dim=1)
    tk, tp = pad(tk), pad(tp)
    out = []
    for hyp in range(tk.shape[0]):
        fk, fp = tk[hyp, :, 4], tp[hyp, :, 4]
        differ = ~((fk == fp) | (fk.isnan() & fp.isnan()))
        if not bool(differ.any()):
            continue
        at = int(torch.nonzero(differ)[0])
        rk, rp = tk[hyp, at], tp[hyp, at]
        tie = False
        if not bool(rk.isnan().any() | rp.isnan().any()):
            change_k, change_p = (float((r[1] - r[0]) / r[0]) for r in (rk, rp))
            if int(rk[4]) % 2 != int(rp[4]) % 2:
                sides = (change_k < 0.0) != (change_p < 0.0)
            else:
                sides = (abs(change_k) < function_tolerance) != (abs(change_p) < function_tolerance)
            tie = sides and abs(change_k - change_p) <= ALIGN_TIE \
                and abs(float(rk[2] - rp[2])) <= 1e-6 * abs(float(rp[2]))
        out.append({"hypothesis": hyp, "pass": at, "kernel": rk.tolist(),
                    "plain": rp.tolist(), "tie": tie})
    return out


def evaluation_errors(ev_k, ev_p, live) -> dict:
    """K7: share of ``live`` (i, j, n) groups on which ``ok`` and
    ``status_candidate`` agree, and relative Frobenius errors on the groups
    that agree and are ok."""
    agree = (ev_k.ok == ev_p.ok) & (ev_k.status_candidate == ev_p.status_candidate)
    n_live = int(live.sum())
    both = agree & ev_k.ok & ev_p.ok
    m = both[..., None, None]
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


def solve_step_errors(out_k, out_p, eps, idepth) -> dict:
    """K9: the pose step and the idepth step against the reference's, each
    relative to the norm of the reference's step, and the two squared norms."""
    eps, idepth = eps.double(), idepth.double()
    step_p, d_p = out_p[0].double() - eps, out_p[1].double() - idepth
    return dict(
        step=float((out_k[0].double() - out_p[0].double()).norm() / step_p.norm().clamp(min=1e-300)),
        d_step=float((out_k[1].double() - out_p[1].double()).norm() / d_p.norm().clamp(min=1e-300)),
        pose_sq=rel_max(out_k[2], out_p[2]), d_sq=rel_max(out_k[3], out_p[3]))


class StepWindow(NamedTuple):
    """What K9 and its plain version read of a window."""

    h_marg: torch.Tensor       # [8k, 8k] f64
    b_marg: torch.Tensor       # [8k] f64
    frame_valid: torch.Tensor  # [k] bool
    num_slots: int
    num_landmark_slots: int


def step_problem(k: int, n: int, seed: int, device):
    """A pose system of K9's shapes from numpy's generator → (StepWindow,
    LinearSystem, eps, idepth), f32 but the f64 ledger.  h_pose is a well
    conditioned matrix (singular values within 0.8 of 2) with its live rows in a
    random order, so partial pivoting swaps rows at nearly every column, the first
    included; the ledger and the Schur term move its singular values by less
    than 0.3; slot 3 is a dead frame."""
    rng = np.random.default_rng(seed)
    kb = k * BLOCK
    f32 = dict(dtype=torch.float32, device=device)
    valid = np.ones(k, dtype=bool)
    valid[3] = False
    live = np.flatnonzero(np.repeat(valid, BLOCK))
    h = 0.4 * rng.normal(size=(kb, kb)) / np.sqrt(kb) + 2.0 * np.eye(kb)
    perm = rng.permutation(live.size)
    while live[perm[0]] == live[0]:
        perm = rng.permutation(live.size)
    h[live] = h[live[perm]]
    a = rng.normal(size=(kb, kb)) / np.sqrt(kb)
    h_marg = 0.02 * (a @ a.T)
    s = rng.normal(size=(kb, kb)) / np.sqrt(kb)
    win = StepWindow(torch.tensor(h_marg, dtype=LEDGER_DTYPE, device=device),
                     torch.tensor(rng.normal(size=kb), dtype=LEDGER_DTYPE, device=device),
                     torch.tensor(valid, device=device), k, n)
    sys = LinearSystem(torch.tensor(h, **f32), torch.tensor(rng.normal(size=kb), **f32),
                       torch.tensor(0.04 * (s @ s.T), **f32),
                       torch.tensor(0.3 * rng.normal(size=kb), **f32),
                       torch.tensor(0.1 * rng.normal(size=(k, n, k, BLOCK)), **f32),
                       torch.tensor(rng.uniform(0.5, 2.0, size=(k, n)), **f32),
                       torch.tensor(rng.normal(size=(k, n)), **f32))
    eps = torch.tensor(1e-3 * rng.normal(size=(k, BLOCK)) * valid[:, None], **f32)
    idepth = torch.tensor(rng.uniform(0.2, 2.0, size=(k, n)), **f32)
    return win, sys, eps, idepth


def exact_step_problem(k: int, n: int, seed: int, device):
    """:func:`step_problem` with no ledger, no Schur term and eps 0: K9 and
    ``pba._assemble_step_system`` then build the same f32 system to the bit
    (h_pose with its damped diagonal, b_pose), and the kernel's step is the
    rounded f64 solution itself."""
    win, sys, eps, idepth = step_problem(k, n, seed, device)
    zero = torch.zeros_like
    return (win._replace(h_marg=zero(win.h_marg), b_marg=zero(win.b_marg)),
            sys._replace(h_schur=zero(sys.h_schur), b_schur=zero(sys.b_schur)), zero(eps),
            idepth)


def unblocked_step(win: StepWindow, sys: LinearSystem, eps, lam: float):
    """The pose step of the column-by-column LU with partial pivoting in f64
    (``testing/blocked_lu.py``, on the CPU) of the system K9 solves, rounded
    and masked as K9 does → (step [k, 8] on eps's device, pivot rows)."""
    h, b, live = _assemble_step_system(win, sys, eps, lam)
    x, pivots = unblocked_solve(h.double().cpu(), b.double().cpu())
    step = -x.float()
    step = torch.where(torch.isfinite(step) & live.cpu(), step, torch.zeros_like(step))
    return step.reshape(eps.shape).to(eps.device), pivots


def step_problem_f64(win: StepWindow, sys: LinearSystem, eps, idepth):
    """The same problem with every float tensor in f64."""
    return (win._replace(h_marg=win.h_marg.double(), b_marg=win.b_marg.double()),
            to_f64(sys), eps.double(), idepth.double())


def point_status_errors(ps_k, ps_p, ev, rel_band: float = 1e-6) -> dict:
    """K11 against the plain version on the same evaluation ``ev``: the
    threshold, and statuses, inlier counts, flags and baselines outside the
    band ``|e − threshold| ≤ rel_band · threshold`` (a group in the band may
    fall on either side; a landmark with such a group is left out)."""
    thr = ps_p.threshold.double()
    near = ev.ok & ((ev.energy_patch.double() - thr).abs() <= rel_band * thr)
    lm_clear = ~near.any(dim=1)
    return dict(
        threshold=rel_max(ps_k.threshold, ps_p.threshold), in_band=int(near.sum()),
        status_differ=int(((ps_k.res_status != ps_p.res_status) & ~near).sum()),
        inliers_differ=int(((ps_k.lm_inliers != ps_p.lm_inliers) & lm_clear).sum()),
        flags_differ=int((((ps_k.lm_outlier != ps_p.lm_outlier)
                           | (ps_k.lm_opt_count != ps_p.lm_opt_count)) & lm_clear).sum()),
        baseline=rel_max(torch.where(lm_clear, ps_k.lm_baseline, ps_p.lm_baseline),
                         ps_p.lm_baseline))


TIE = 1e-5   # an accepted step that changes the energy by less is a rounding tie


def same_decisions(log_k, log_p):
    """Whether two LM state logs take the same (accept, done, relinearize)
    decisions → (same, row of a rounding tie or None).  The two loops sum the
    patch energies in different orders, so near convergence ``e_new < e`` can
    fall either way: where the logs part and the step that one of them
    accepted changes the energy by less than ``TIE`` of it, the rows before
    are compared and the tie's row is returned."""
    flags = lambda r: (r["it"], r["accept"], r["done"], r["relin"])  # noqa: E731
    for i, (a, b) in enumerate(zip(log_k, log_p)):
        if flags(a) == flags(b):
            continue
        took = a if a["accept"] else b
        before = (log_k if took is a else log_p)[i - 1]["energy"]
        tie = i > 0 and took["accept"] and \
            abs(took["energy"] - before) <= TIE * abs(before)
        return bool(tie), (i if tie else None)
    if len(log_k) != len(log_p):
        # one loop went on after the other had ended: tolerated after a tie only
        return False, None
    return True, None


def solve_loop_errors(res_k, res_p, log_k, log_p) -> dict:
    """K10: a whole windowed solve ``(window, energy, num_valid)`` by the
    device-resident loop against the host-driven one, with their state logs."""
    win_k, win_p = res_k[0], res_p[0]
    same, tie_at = same_decisions(log_k, log_p)
    pk, pp = win_k.poses(), win_p.poses()
    dq = quat_multiply(pk.q.double(), quat_conjugate(pp.q.double()))
    live = (win_p.frame_valid[:, None] & win_p.frame_valid[None, :])[:, :, None] \
        & (win_p.lm_valid & win_p.frame_valid[:, None])[:, None, :]
    status_same = (win_k.res_status == win_p.res_status) & live
    energies = [abs(a["energy"] - b["energy"]) / max(abs(b["energy"]), 1e-30)
                for a, b in zip(log_k, log_p)]
    return dict(
        same_flags=same, tie_at=tie_at, iterations=log_p[-1]["it"],
        accepts=sum(r["accept"] for r in log_p), relins=sum(r["relin"] for r in log_p),
        log_energy=max(energies, default=0.0),
        energy=rel_max(res_k[1], res_p[1]), count_differ=abs(int(res_k[2]) - int(res_p[2])),
        rotation=float((2.0 * dq[:, 1:].norm(dim=-1)).max()),
        translation=float((pk.t.double() - pp.t.double()).norm(dim=-1).max()),
        idepth=rel_frobenius(win_k.lm_idepth, win_p.lm_idepth),
        status_agree=float(status_same.sum()) / max(int(live.sum()), 1),
        outlier_differ=int((win_k.lm_outlier != win_p.lm_outlier).sum()))


def keyframe_case(tracker, image, pose, frame_id: int):
    """The inputs of the keyframe backend's kernels (K12-K14, K16) as
    ``keyframe_front_sequences`` builds them: ``image`` at the known ``pose`` becomes
    the newest keyframe of the tracker's window (no landmarks yet), after the
    epipolar update of the immature banks against it, and brings its own bank
    of fresh candidates → (window, immature banks, the frame's pyramid); a
    window of C > 1 channels takes the frame's embedded channel map.  The
    tracker itself is left as it was."""
    cfg, win = tracker.config, tracker.window
    maps = build_pyramid_maps(image.contiguous(), cfg.pyramid_levels)
    poses = win.poses()
    exposure = torch.ones((), dtype=image.dtype, device=image.device)
    imm = estimate_depths(tracker.immature, maps[0], tracker.camera, pose.q.contiguous(),
                          pose.t.contiguous(), poses.q, poses.t, win.affine(),
                          tracker.last_affine, exposure, win.exposure, cfg.huber_sigma)
    slot = frame_count(win)
    channel_map = (None if win.num_channels == 1
                   else build_channel_map(tracker.embedder(maps[0][0])))
    win = push_frame_slot(win, slot, pose.q, pose.t, tracker.last_affine, exposure, False,
                          frame_id, maps[0], channel_map)
    imm = set_bank(imm, slot, immature_bank(maps[0], cfg.immature_per_frame, tracker.mask))
    return win, imm, maps


def epipolar_args(tracker, target_map, pose, huber_sigma: float = 20.0):
    """K4's arguments: every bank of ``tracker`` against a frame of level-0
    map ``target_map`` at pose ``pose`` (T_w_t), exposure 1."""
    win = tracker.window
    poses = win.poses()
    return (tracker.immature, target_map, tracker.models[0], pose.q.contiguous(),
            pose.t.contiguous(), poses.q, poses.t, win.affine(), tracker.last_affine,
            torch.ones((), dtype=target_map.dtype, device=target_map.device), win.exposure,
            huber_sigma)


class EpipolarRun(NamedTuple):
    kernel: de.ImmaturePoints     # K4's outputs
    debug: de.EpipolarDebug       # its sweep and relative poses
    sweep: de.SweepResult         # the debug sweep, flat as the plain version's
    inp: de.SweepInputs           # the plain version's parts on the same inputs
    geo: dict
    res_p: de.SweepResult
    plain: de.ImmaturePoints


def epipolar_run(args) -> EpipolarRun:
    """K4 with its debug output, and the plain version's parts, on ``args``."""
    points, target_map, model = args[:3]
    k, n = points.valid.shape
    dbg = de.debug_buffers(k, n, target_map.device)
    out_k = de.estimate_depths_cuda(*args, debug=dbg)
    t_rel = de.relative_poses(*args[3:7])
    inp, geo = de.sweep_inputs(points, model, t_rel.q, t_rel.t, args[7], args[8],
                               args[9] / torch.clamp(args[10], min=1e-12))
    res_p = de.epipolar_sweep_plain(inp, target_map[0], model, args[11])
    sweep = de.SweepResult(*(x.reshape(-1).long() if name == "best_idx" else x.reshape(-1)
                             for name, x in zip(de.SweepResult._fields, dbg)))
    return EpipolarRun(out_k, dbg, sweep, inp, geo, res_p,
                       de.update_from_sweep(points, geo, res_p, model))


EPIPOLAR_OUTPUTS = ("idepth_min", "idepth_max", "status", "traced", "uniqueness",
                    "search_interval")


def epipolar_chain_differ(args, run: EpipolarRun) -> dict:
    """{output: entries of K4's outputs that differ from the plain geometry
    and update (torch's operations) on the kernel's own relative poses and its
    own sweep}: the in-kernel geometry, error model, shrink and status machine
    against the PyTorch code they replace; every count 0 when they keep its
    bits.  Also ``pose_ulps``: the kernel's relative poses against torch's
    composition, in f32 ulps of each pose's largest component (at least 1 for
    the rotation)."""
    points, _, model = args[:3]
    rel = run.debug.rel_pose
    inp, geo = de.sweep_inputs(points, model, rel[:, :4].contiguous(), rel[:, 4:].contiguous(),
                               args[7], args[8], args[9] / torch.clamp(args[10], min=1e-12))
    own = de.update_from_sweep(points, geo, run.sweep, model)
    out = {name: int((getattr(run.kernel, name) != getattr(own, name)).sum())
           for name in EPIPOLAR_OUTPUTS}
    ref = de.relative_poses(*args[3:7])
    out["pose_ulps"] = pose_ulps(rel, ref)
    return out


def pose_ulps(rel, ref: SE3) -> float:
    """Poses ``rel`` [K, 7] (q, t) a kernel composed against torch's ``ref``:
    the largest difference in f32 ulps of each pose's largest component (at
    least 1 for the rotation)."""
    ulps = 0.0
    for a, b, floor in ((rel[:, :4], ref.q, 1.0), (rel[:, 4:], ref.t, 0.0)):
        scale = torch.maximum(a.abs(), b.abs()).amax(dim=-1, keepdim=True).clamp(min=floor)
        ulp = torch.as_tensor(np.spacing(scale.cpu().numpy().astype(np.float32)), device=a.device)
        ulps = max(ulps, float(((a - b).abs() / ulp).max()))
    return ulps


# K16: the __global__ functions of csrc/depth_maps.cu, the only device work of
# its call; and the host-side view operators its wrapper may run besides its
# allocations (its outputs are views of two allocations)
DEPTH_MAPS_KERNELS = ("prepare_kernel", "twins_kernel", "chain_kernel", "pool_kernel",
                      "dilate_hist_kernel", "class_threshold_kernel", "tile_count_kernel",
                      "select_write_kernel", "class_rank_kernel", "heavy_write_kernel")
VIEW_OPS = ("aten::split", "aten::split_with_sizes", "aten::narrow", "aten::slice",
            "aten::as_strided", "aten::view")


def frontend_pose_errors(window, rel_pose) -> dict:
    """K16's poses T_newest⁻¹ · T_f (``rel_pose`` [K, 7], the kernel's
    ``poses_out``) against torch's ``_older_landmarks``: their ulps and the
    entries equal to the bit."""
    ref = _older_landmarks(window)[0]
    same = (rel_pose == torch.cat([ref.q, ref.t], dim=-1))
    return dict(pose_ulps=pose_ulps(rel_pose, ref), equal=int(same.sum()), entries=same.numel())


def candidates_errors(out_k, out_p) -> dict:
    """K12: slots whose position or validity differ, and the largest
    difference of the squared gradient (the kernel repeats the plain version's
    arithmetic, so all three are expected to be 0)."""
    return dict(uv_differ=int((out_k.uv != out_p.uv).any(dim=-1).sum()),
                valid_differ=int((out_k.valid != out_p.valid).sum()),
                grad2=float((out_k.grad2 - out_p.grad2).abs().max()),
                valid=int(out_p.valid.sum()))


# px: a least distance this close to min_distance may fall either way (the two
# reprojections differ in the last bit of a pixel coordinate, 6e-5 at x = 600)
ACTIVATION_BAND = 2e-4
BORDER_BAND = 1e-3       # px: a reprojection this close to a pixel or image border
# the poses K13 and K14's refinement compute in the kernel (ba_body.cuh's
# frame_pose / relative_pose) against window.poses() and the plain versions'
# relative poses: the largest difference of a component in units of the last
# place of the pose's largest component (the two sum a quaternion's squares in
# other orders; tests/test_torch_activation_models.py).  The reprojections
# this moves stay far inside ACTIVATION_BAND and BORDER_BAND
KERNEL_POSE_ULPS = 8


def near_border(uv, model, band: float = BORDER_BAND):
    """Points whose reprojection ``uv`` [..., 2] lies within ``band`` of the
    border of the valid image region (core/camera.py: [4, size − 5])."""
    u, v = uv[..., 0], uv[..., 1]
    out = torch.zeros_like(u, dtype=torch.bool)
    for x, hi in ((u, model.width - 5.0), (v, model.height - 5.0)):
        out |= ((x - 4.0).abs() <= band) | ((x - hi).abs() <= band)
    return out


def activation_errors(res_k, res_p, terms, min_distance, model) -> dict:
    """K13 ``(activate, delete, n_active)`` against the plain version's, with
    the plain version's ``terms`` (``_activation_terms_plain``): the share of
    candidates on which both masks agree, and the differences that no rounding
    tie explains (the least distance within ``ACTIVATION_BAND`` px of
    ``min_distance``, or the reprojection within ``BORDER_BAND`` of the image
    border)."""
    _, _, min_d, _, rp_uv = terms
    differ = (res_k[0] != res_p[0]) | (res_k[1] != res_p[1])
    md = float(min_distance)
    tie = ((min_d - md).abs() <= ACTIVATION_BAND) | near_border(rp_uv, model)
    return dict(n_active_differ=abs(int(res_k[2]) - int(res_p[2])), n_active=int(res_p[2]),
                activate=int(res_p[0].sum()), delete=int(res_p[1].sum()),
                agree=1.0 - float(differ.sum()) / differ.numel(),
                differ=int(differ.sum()), unexplained=int((differ & ~tie).sum()))


REFINE_TIE = 2e-5   # relative change of the energy below which `e_new < e` is a rounding tie
# K14's refinement sums a candidate's per-target values in f64 in a warp's
# fixed order (two targets a lane, then a butterfly): cast to f32, a sum of
# non-negative terms (the energy, the Hessian) lands within this many ulp of
# the target-index order's (tests/test_torch_activation_models.py), far
# inside REFINE_TIE
REFINE_SUM_ULPS = 1


def refine_order(selected):
    """Flat indices of the refined candidates in refinement order (banks from
    the highest slot down, inside a bank by index)."""
    k, m = selected.shape
    flat = torch.nonzero(selected.reshape(-1))[:, 0]
    return flat[torch.argsort((k - 1 - flat // m) * m + flat % m)]


def refine_errors(out_k, out_p, trace_k, trace_p) -> dict:
    """K14's refinement ``(idepth, keep, selected)`` against the plain
    version's, with both decision traces ([cap, 3, 4]: energy, trial energy, λ,
    accept): ``selected`` must be equal; ``keep`` agreement among the selected;
    the idepth of candidates whose accept sequences are equal; and the
    candidates whose sequences part, split into rounding ties (at the first
    parting trial one version's energy changes by less than ``REFINE_TIE`` of
    itself) and others."""
    sel = out_p[2]
    out = dict(selected=int(sel.sum()), selected_differ=int((out_k[2] != out_p[2]).sum()))
    if out["selected_differ"] or out["selected"] == 0:
        return out
    order = refine_order(sel)
    n = order.shape[0]
    tk, tp = trace_k[:n].double(), trace_p[:n].double()
    same_seq = (tk[..., 3] == tp[..., 3]).all(dim=1)
    keep_k, keep_p = out_k[1].reshape(-1)[order], out_p[1].reshape(-1)[order]
    idep_k, idep_p = out_k[0].reshape(-1)[order].double(), out_p[0].reshape(-1)[order].double()
    held = same_seq & keep_k & keep_p
    rel = ((idep_k - idep_p).abs() / idep_p.abs().clamp(min=1e-12))
    ties = others = 0
    for pos in torch.nonzero(~same_seq)[:, 0].tolist():
        at = int(torch.nonzero(tk[pos, :, 3] != tp[pos, :, 3])[0])
        change = min(float(((t[pos, at, 1] - t[pos, at, 0]).abs() / t[pos, at, 0].abs().clamp(min=1e-30)))
                     for t in (tk, tp))
        if change <= REFINE_TIE:
            ties += 1
        else:
            others += 1
    out.update(keep=int(keep_p.sum()), keep_agree=float((keep_k == keep_p).double().mean()),
               kept_outside_selected=int((out_k[1] & ~sel).sum()),
               idepth=float(rel[held].max()) if bool(held.any()) else 0.0,
               idepth_abs=float((idep_k - idep_p).abs()[held].max()) if bool(held.any()) else 0.0,
               parted=int((~same_seq).sum()), parted_ties=ties, parted_others=others,
               accepts=int(tp[..., 3].sum()))
    return out


def scatter_errors(res_k, res_p) -> dict:
    """K14's pairing ``(window, immature, n_activated)`` against the plain
    version's on the same inputs: counts of differing entries (integer work and
    copies, so every count is expected to be 0)."""
    wk, wp = res_k[0], res_p[0]
    out = {name: int((getattr(wk, name) != getattr(wp, name)).sum())
           for name in ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "res_status")}
    out["imm_valid"] = int((res_k[1].valid != res_p[1].valid).sum())
    out["n_activated_differ"] = abs(int(res_k[2]) - int(res_p[2]))
    out["n_activated"] = int(res_p[2])
    return out


def pixel_boundary_landmarks(window, model, band: float = BORDER_BAND):
    """[K, N] mask of the live landmarks whose reprojection into the newest
    keyframe lies within ``band`` px of a half-integer (where the last bit of
    the reprojection decides the pixel it falls into) or of the image border
    (where it decides validity)."""
    t_rel, lm_mask = _older_landmarks(window)
    rp = reproject(model, model, window.lm_uv, window.lm_idepth,
                   SE3(t_rel.q[:, None], t_rel.t[:, None]))
    frac = rp.uv - torch.floor(rp.uv)
    return lm_mask & (((frac - 0.5).abs() <= band).any(dim=-1) | near_border(rp.uv, model, band))


def frontend_errors(out_k, out_p) -> dict:
    """K16 ``(idepth maps, weight maps, level points, flow points)`` against
    the plain version's: pixels whose weight differs (exact counts), the idepth
    sums relative to the plain version's on pixels that hold weight, and per
    point set the slots whose pixel or validity differ, the idepth relative and
    the intensity absolute."""
    weight_differ = sum(int((a != b).sum()) for a, b in zip(out_k[1], out_p[1]))
    idep = 0.0
    for a, b, w in zip(out_k[0], out_p[0], out_p[1]):
        rel = (a.double() - b.double()).abs() / b.double().abs().clamp(min=1e-30)
        idep = max(idep, float(torch.where(w > 0, rel, torch.zeros_like(rel)).max()))
    out = dict(weight_differ=weight_differ, idepth_map=idep,
               positive=[int((w > 0).sum()) for w in out_p[1]])
    sets = list(zip(out_k[2], out_p[2])) + [(out_k[3], out_p[3])]
    out["uv_differ"] = sum(int((a.uv != b.uv).any(dim=-1).sum()) for a, b in sets)
    out["valid_differ"] = sum(int((a.valid != b.valid).sum()) for a, b in sets)
    out["valid"] = [int(b.valid.sum()) for _, b in sets]
    out["idepth"] = max(rel_max(torch.where(b.valid, a.idepth, b.idepth), b.idepth)
                        for a, b in sets)
    out["intensity"] = max(float((a.intensity - b.intensity).abs().max()) for a, b in sets)
    return out


LEDGER_TOL = 1e-9   # K15: ledger entries relative to the largest one
CUTOFF_TIE = 1e-6   # K15: an eigenvalue this close (relative) to the cutoff may fall either side
# K15p: top two eq (20) scores this close (relative) may pick either frame, on
# top of the scores' bounds of eq20_score_bounds
POLICY_TIE = 1e-6


def eq20_score_bounds(window) -> torch.Tensor:
    """[K] float64: how far K15p's eq (20) score of each slot may lie from the
    plain version's (``eq20_scores``).

    The kernel composes the frames' positions itself, each component within
    ``KERNEL_POSE_ULPS`` f32 ulps of the pose's largest translation component
    of ``window.poses()`` (e_f of frame f, per component), so a distance
    D_ij = |t_i - t_j| moves by at most √3 (e_i + e_j).  To first order the
    score s_i = √D_in · S_i, S_i = Σ_j 1 / (ε + D_ij) over the eligible j,
    then moves by at most
        s_i (√3 (e_i + e_n) / (2 D_in) + Σ_j √3 (e_i + e_j) / (ε + D_ij)² / S_i),
    and the two versions round their f32 sums of k terms, the norms, the
    square roots and the product in other orders: (k + 8) ulps relative more.
    At the corridor's scale (positions up to ~10 m, keyframes ~0.5 m apart)
    the first term alone is ~1e-5 to 1e-4 of the score, so ``POLICY_TIE`` by
    itself does not cover the spread."""
    k = window.num_slots
    dev = window.frame_valid.device
    t = window.poses().t.double()
    largest = t.abs().amax(dim=-1).cpu().numpy().astype(np.float32)
    e = torch.as_tensor(KERNEL_POSE_ULPS * np.spacing(largest), dtype=torch.float64, device=dev)
    idx = torch.arange(k, device=dev)
    f = window.frame_valid.sum()
    ids = window.frame_id
    newest = newest_slot(window)
    newest_id = ids.index_select(0, newest)[0]
    elig_j = (idx < f - KEEP_FRAMES_FROM_END) & (ids + MIN_FRAME_AGE <= newest_id + 1)
    dist = torch.linalg.vector_norm(t[:, None, :] - t[None, :, :], dim=-1)
    live = elig_j[None, :] & ~torch.eye(k, dtype=torch.bool, device=dev)
    inv = torch.where(live, 1.0 / (EPS_DIST + dist), torch.zeros_like(dist))
    s_sum = inv.sum(dim=1)
    moved = torch.where(live, 3 ** 0.5 * (e[:, None] + e[None, :]) * inv * inv,
                        torch.zeros_like(dist)).sum(dim=1)
    d_new = dist.index_select(1, newest)[:, 0]
    e_new = e.index_select(0, newest)
    rel = (3 ** 0.5 * (e + e_new) / (2 * d_new.clamp(min=1e-300))
           + moved / s_sum.clamp(min=1e-300) + (k + 8) * 2.0 ** -24)
    score = eq20_scores(window).double()
    return torch.where(score > 0, score * rel, torch.zeros_like(score))


def ledger_errors(out_k, out_p) -> dict:
    """K15 ``(H_m, b_m, E_m)`` against the plain version's: the largest
    difference of each relative to the plain version's largest entry."""
    out = {}
    for name, a, b in zip(("H", "b", "E"), out_k, out_p):
        a, b = a.double(), b.double()
        out[name] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))
    return out


def folded_ledger(window, h_pts, opts):
    """The ledger with the landmark system and the flagged frames' priors
    folded in, f64 on the window's device, as K15 eliminates it → (H_m, the
    flagged rows [8K] bool)."""
    h_pr, _ = _prior_system(window, window.eps, opts, marg_pass=True)
    h = h_pts.double()
    hm = window.h_marg + 0.5 * (h + h.T) + h_pr.double()
    return hm, torch.repeat_interleave(window.frame_valid & window.frame_marg, BLOCK)


def cutoff_ties(window, h_pts, opts, band: float = CUTOFF_TIE) -> dict:
    """The flagged rows' block of :func:`folded_ledger` (f64 on the CPU) → its
    eigenvalue count, the cutoff of the identity-padded matrix, the
    eigenvalues it drops and those within ``band`` (relative) of it."""
    hm, rows = folded_ledger(window, h_pts, opts)
    hm, rows = hm.cpu(), rows.cpu()
    lam = torch.linalg.eigvalsh(hm[rows][:, rows]) if bool(rows.any()) else torch.zeros(0)
    top = max(1.0, float(lam.abs().max())) if lam.numel() else 1.0
    cutoff = pinv_rtol(hm.shape[0], window.eps.dtype) * top
    return dict(eigenvalues=int(lam.numel()), cutoff=cutoff,
                dropped=int((lam.abs() <= cutoff).sum()),
                ties=int(((lam.abs() - cutoff).abs() <= band * cutoff).sum()))


def pinv_cut(cutoff: float):
    """The pseudo-inverse of a symmetric matrix that drops |λ| ≤ ``cutoff``
    (absolute) and inverts the rest with their sign."""
    def pinv(a):
        lam, v = torch.linalg.eigh(a)
        inv = torch.where(lam.abs() > cutoff, 1.0 / torch.where(lam == 0, 1.0, lam),
                          torch.zeros_like(lam))
        return (v * inv) @ v.T
    return pinv


def ledger_check(out_k, fold, band: float = CUTOFF_TIE) -> dict:
    """K15's ``out_k`` against the plain fold of ``fold`` (its arguments) →
    :func:`ledger_errors`, :func:`cutoff_ties`, and ``within``: every error
    ≤ ``LEDGER_TOL``, or, where eigenvalues tie the cutoff, every error ≤
    ``LEDGER_TOL`` against the plain fold with the cutoff moved to either
    edge of the band, which drops or keeps every tied eigenvalue."""
    window, h_pts, opts = fold[0], fold[1], fold[5]
    out = ledger_errors(out_k, _marginalize_plain(*fold))
    ties = cutoff_ties(window, h_pts, opts, band)
    within = max(out.values()) <= LEDGER_TOL
    if not within and ties["ties"]:
        for cut in (ties["cutoff"] * (1 + band), ties["cutoff"] * (1 - band)):
            alt = ledger_errors(out_k, _marginalize_plain(*fold, pinv=pinv_cut(cut)))
            within = within or max(alt.values()) <= LEDGER_TOL
    out.update(ties, within=within)
    return out


def policy_errors(out_k, out_p, window, minimum_size: int, maximum_size: int,
                  band: float = POLICY_TIE) -> dict:
    """K15p ``(frame_flags, lm_flags, new_outliers, perm)`` against the plain
    version's → entries that differ; ``score_tie``: the two largest eq (20)
    scores (the plain version's arithmetic) closer than the sum of their
    bounds (``eq20_score_bounds``) and ``band`` of the larger; and
    ``explained``: nothing differs, or the scores tie, the frame flags differ
    only on those two slots (as many flagged), and the landmark triage and
    the permutation are the plain version's for the kernel's frame flags."""
    top = torch.topk(eq20_scores(window).double(), 2)
    names = ("frame_flags_differ", "lm_flags_differ", "outliers_differ", "perm_differ")
    out = {name: int((a != b).sum()) for name, a, b in zip(names, out_k, out_p)}
    out["frames_flagged"] = int(out_p[0].sum())
    out["lm_flagged"] = int(out_p[1].sum())
    hi, lo = (float(v) for v in top.values)
    reach = float(eq20_score_bounds(window)[top.indices].sum())
    out["score_gap"] = (hi - lo) / hi if hi > 0 else 0.0
    out["tie_band"] = (reach + band * abs(hi)) / hi if hi > 0 else 0.0
    out["score_tie"] = bool(hi - lo <= band * abs(hi) + reach and hi > 0)
    explained = not any(out[name] for name in names)
    if not explained and out["score_tie"]:
        moved = out_k[0] != out_p[0]
        moved[top.indices] = False
        lm, outliers = landmark_triage(window, out_k[0], minimum_size, maximum_size)
        explained = (not bool(moved.any()) and int(out_k[0].sum()) == int(out_p[0].sum())
                     and torch.equal(lm, out_k[1]) and torch.equal(outliers, out_k[2])
                     and torch.equal(kept_first_perm(window.frame_valid, out_k[0]), out_k[3]))
    out["explained"] = explained
    return out


# pose_covariances: an f64 decomposition of the reduced pose system rounds its
# weakest kept directions by up to ~ε·λ_max, so the covariance may move by
# COV_F64_ULPS · ε · condition of its largest live entry (the fixed frame's
# 1e16 prior makes the condition ~2.5e10 on a known-pose window: the JAX
# package's eigh and torch's part there by ~3e-6)
COV_F64_ULPS = 8
# pose_covariances on the card (K7, K8 in f32, the decomposition in f64) against
# its plain version in f32 on the same window: the largest difference of cov
# and cov_rel relative to the largest live entry.  Measured 5.4e-5 on the
# standart path's last window (condition 3.9e9; chip_smoke [outputs]); an f32
# window against its own f64 copy on the CPU parts by 2.2e-5
POSE_COV_F32_TOL = 5e-4


def pose_system_condition(h, frame_valid) -> float:
    """The condition of the pseudo-inverse :func:`pose_covariances` takes of
    the reduced pose system ``h`` (``pba.pose_information``): the largest
    |λ| of the live slots' block over the least |λ| it keeps (the least one
    is dropped)."""
    live = torch.repeat_interleave(frame_valid, BLOCK).cpu()
    h = h.double().cpu()[live][:, live]
    lam = torch.linalg.eigvalsh(h).abs().sort().values
    return float(lam[-1] / lam[1])


def covariance_errors(out_k, out_p, frame_valid) -> dict:
    """``pose_covariances``' (cov, cov_rel) against another's: the largest
    difference over the live slots' blocks (cov) and the live ordered pairs
    (cov_rel), each relative to the other's largest live entry."""
    live = frame_valid.cpu()
    k = live.shape[0]
    rows = torch.repeat_interleave(live, BLOCK)
    pairs = live[:, None] & live[None, :] & ~torch.eye(k, dtype=torch.bool)
    out = {}
    for name, a, b, mask in (("cov", out_k[0], out_p[0], rows[:, None] & rows[None, :]),
                             ("cov_rel", out_k[1], out_p[1], pairs)):
        a, b = a.double().cpu()[mask], b.double().cpu()[mask]
        out[name] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))
    return out


def cuda_ms(fn, reps: int = 50) -> float:
    """Mean time of ``fn`` per call over ``reps`` calls after 3 warm ones,
    between two CUDA events (the host work of ``fn`` included)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# K15's flagging cases: "a dead frame" keeps no live landmark and sees none
# (its block holds the priors and the ledger only: rank 2 on an empty ledger);
# "five frames" flags 40 rows, more than K15's one-warp solver takes
MARG_CASES = ("no frame", "one free frame", "two frames", "the fixed frame", "a dead frame",
              "five frames")


def marg_cases(window) -> dict:
    """{case of ``MARG_CASES``: the slots it flags} on ``window``: free frames
    older than the newest one (as many as there are, up to five), and slot 0
    for the fixed frame (made fixed where it is not)."""
    frames = int(window.frame_valid.sum())
    is_fixed = (window.frame_fixed & window.frame_valid).tolist()
    free = [i for i in range(frames - 1) if not is_fixed[i]]
    fixed = [i for i in range(frames) if is_fixed[i]]
    return {"no frame": [], "one free frame": free[:1], "two frames": free[:2],
            "the fixed frame": fixed[:1] or [0], "a dead frame": free[-1:],
            "five frames": free[:5]}


def marg_case(window, case: str, slots, gen):
    """``window`` with the frames ``slots`` of ``case`` flagged, their live
    landmarks and a random quarter (``gen``) of the others' flagged → (window,
    the kept-first permutation).  The fixed frame's eps is zero; a dead
    frame's landmarks are dropped and every residual into it is out of
    bounds."""
    k, n = window.num_slots, window.num_landmark_slots
    dev = window.eps.device
    marg = torch.zeros(k, dtype=torch.bool, device=dev)
    marg[list(slots)] = True
    none = torch.zeros_like(marg)
    fixed = window.frame_fixed | (marg if case == "the fixed frame" else none)
    dead = marg if case == "a dead frame" else none
    lm_valid = window.lm_valid & ~dead[:, None]
    res_status = torch.where(dead[None, :, None], RES_OOB, window.res_status).to(torch.int32)
    live = lm_valid & ~window.lm_outlier
    lm = live & (marg[:, None] | (torch.rand((k, n), generator=gen, device=dev) < 0.25))
    eps = torch.where(fixed[:, None], torch.zeros_like(window.eps), window.eps)
    w = window.replace(frame_marg=marg, frame_fixed=fixed, lm_marg_flag=lm, lm_valid=lm_valid,
                       res_status=res_status, eps=eps.contiguous())
    return w, kept_first_perm(w.frame_valid, marg)
