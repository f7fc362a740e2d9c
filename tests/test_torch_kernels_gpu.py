"""The hand-written CUDA kernels against their plain PyTorch versions, f32
on the card (marked ``gpu``; skipped without a CUDA device).

Tolerances (intensities 0..255): K1 1e-3 abs; K2 num_valid exact, H and b
1e-4 relative (Frobenius), energy 1e-5 relative; K4 best sample equal on
≥ 99.9 % of active landmarks, refined GN energy 1e-4 relative where the
winners agree; K3 num_valid within 0.5 %, energy and rmse 1e-3 relative,
rotation 1e-4 rad and translation 1e-4 m of the plain version (the result is
held, not the iteration trace: one accept/reject can flip by rounding; a
hypothesis is left out of the pose gate only where the two decision traces
show that flip: the same λ, and relative changes of the energy that differ by
at most ``parity.ALIGN_TIE`` and fall on either side of the decision's limit); K6
every output 1e-5 relative (Frobenius), geom_valid exact; K7 ok and
status_candidate equal on ≥ 99.9 % of live groups, the rest 1e-4 relative
on the agreeing ones; K8 every output 1e-4 relative (Frobenius), also with
``marg_pass=True``; K5 both flows 1e-5 relative; K9 pose and idepth step 1e-4
of the step's norm against the plain version in f64 arithmetic on the same
f32 inputs (the plain f32 solve's own distance from it is reported by
``chip_smoke.py``); K10 the same accept / done / relinearize sequence as the
host-driven loop, final energy 1e-4 relative, poses 1e-4 rad and 1e-4 m,
statuses equal on ≥ 99.9 % of live groups, no host synchronisation inside;
K11 threshold 1e-6 relative, statuses, counts and flags equal outside the
1e-6 band around the threshold; K12 positions, validity and slot order equal
and grad2 equal to the bit, with and without a mask; K13 n_active equal, masks
equal on ≥ 99.9 % of candidates and every difference a rounding tie (least
distance within 2e-4 px of min_distance, or the reprojection within 1e-3 px of
the image border); K14 selected equal, keep equal on ≥ 99.5 % of the selected,
idepth 1e-4 relative where the accept sequences are equal, the pairing equal
entry by entry on the same inputs; K16 (landmarks within 1e-3 px of a pixel
boundary left out of both) weights and selected pixels equal, idepth 1e-6
relative; K15 (the ledger fold, on an empty and a filled ledger, with no
frame, one free frame, two frames, the fixed frame and a dead frame flagged)
H_m, b_m and E_m within 1e-9 of their largest entry, of the plain version's
or, where an eigenvalue lies within 1e-6 (relative) of the pseudo-inverse's
cutoff, of the plain version's with the cutoff at either edge of that band;
the Jacobi solver converged; two runs equal to the bit, the window it leaves
equal; K15p (the policy) flags, outliers and the permutation equal, or, where
the two best eq (20) scores tie within 1e-6, frame flags that differ on those
two slots only and the plain triage of the kernel's frame flags; the
row gather equal to ``table[idx]`` to the bit in f32 and bf16; K18 (the
photometric correction) equal to the bit on u8 and f32 frames, with and
without a vignette, at VGA and at 479x637.  K12-K16 and K18 run with host
synchronisation an error.

Run on a machine with a card:
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``.
"""

import numpy as np
import pytest
import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features import extractor, pyramid
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.solvers import pose_alignment as pa
from dsopp_tpu_torch.testing import align_trace, gather_probe, parity, render_sequence
from dsopp_tpu_torch.tracker import activation as act
from dsopp_tpu_torch.tracker import depth_estimation as de
from dsopp_tpu_torch.tracker import depth_map as dm
from dsopp_tpu_torch.tracker import marginalization as marg
from dsopp_tpu_torch.tracker.fused_keyframe import immature_bank
from dsopp_tpu_torch.tracker.fused_tick import _initialization_hypotheses

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seq = render_sequence(num_frames=4, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    return seq


def test_pyramid_kernel_matches_plain(scene):
    img = scene.images[1].contiguous()
    before = kernels.PYRAMID.launches
    for a, b in zip(pyramid.build_pyramid_maps_cuda(img, 5),
                    pyramid.build_pyramid_maps_plain(img, 5)):
        assert float((a - b).abs().max()) <= 1e-3
    assert kernels.PYRAMID.launches == before + 5
    odd = torch.rand(121, 161, device="cuda") * 255
    for a, b in zip(pyramid.build_pyramid_maps_cuda(odd, 4),
                    pyramid.build_pyramid_maps_plain(odd, 4)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-3


def test_align_kernel_matches_plain(scene):
    rng = np.random.default_rng(0)
    maps = pyramid.build_pyramid_maps_cuda(scene.images[2].contiguous(), 2)
    n = 1500
    uv = torch.tensor(rng.uniform(8, [312, 232], size=(n, 2)), dtype=torch.float32, device="cuda")
    depth = scene.depths[0][uv[:, 1].long(), uv[:, 0].long()]
    pts = pa.LevelPoints(uv, (1.0 / depth).contiguous(),
                         scene.images[0][uv[:, 1].long(), uv[:, 0].long()].contiguous(),
                         torch.tensor(rng.random(n) < 0.9, device="cuda"))
    t_rel = scene.pose(2, torch.float32, "cuda").inverse() @ scene.pose(0, torch.float32, "cuda")
    xi = torch.tensor(rng.normal(size=(5, 6)) * 3e-3, dtype=torch.float32, device="cuda")
    hyp = SE3.exp(xi) @ SE3(t_rel.q.expand(5, 4), t_rel.t.expand(5, 3))
    aff = torch.tensor(rng.normal(size=(5, 2)) * [0.01, 1.0], dtype=torch.float32, device="cuda")
    ref = torch.tensor([0.01, -1.0], device="cuda")
    args = (pts, maps[0], scene.camera, hyp, aff, ref, torch.tensor(1.05, device="cuda"), 20.0)
    hk, bk, ek, nk = pa.residual_system_cuda(*args)
    hp, bp, ep, np_ = pa.residual_system_plain(*args)
    assert torch.equal(nk, np_) and int(nk.min()) > 100
    assert float(((hk - hp).norm(dim=(1, 2)) / hp.norm(dim=(1, 2))).max()) <= 1e-4
    assert float(((bk - bp).norm(dim=1) / bp.norm(dim=1)).max()) <= 1e-4
    assert float(((ek - ep).abs() / ep.abs()).max()) <= 1e-5


def test_epipolar_kernel_matches_plain(scene):
    k = 2
    banks = [immature_bank(pyramid.build_pyramid_maps_cuda(scene.images[0].contiguous(), 1)[0], 400)
             for _ in range(k)]
    pts = de.ImmaturePoints(*(torch.stack(x) for x in zip(*banks)))
    t_rel = scene.pose(3, torch.float32, "cuda").inverse() @ scene.pose(0, torch.float32, "cuda")
    inp, geo = de.sweep_inputs(pts, scene.camera, t_rel.q.expand(k, 4).contiguous(),
                               t_rel.t.expand(k, 3).contiguous(),
                               torch.zeros(k, 2, device="cuda"), torch.zeros(2, device="cuda"),
                               torch.ones(k, device="cuda"))
    img = scene.images[3].contiguous()
    rk = de.epipolar_sweep_cuda(inp, img, scene.camera, 20.0)
    rp = de.epipolar_sweep_plain(inp, img, scene.camera, 20.0)
    act = inp.active
    same = (rk.best_idx == rp.best_idx) & act
    assert float(same.sum()) >= 0.999 * float(act.sum())
    assert torch.equal(rk.any_sample[act], rp.any_sample[act])
    fin = same & torch.isfinite(rp.refined_energy)
    rel = (rk.refined_energy[fin] - rp.refined_energy[fin]).abs() / rp.refined_energy[fin].clamp(min=1.0)
    assert float(rel.max()) <= 1e-4
    with pytest.raises(ValueError):
        de.epipolar_sweep_cuda(inp._replace(alphas=inp.alphas[:16].contiguous()), img,
                               scene.camera, 20.0)


@pytest.fixture(scope="module")
def tracked():
    """A tracker bootstrapped on 6 known-pose frames at 240×320 (every second
    one a keyframe), and the next frame's pyramid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return align_trace.small_tracker()


def test_align_level_kernel_matches_plain(tracked):
    tracker, maps = tracked
    before = kernels.ALIGN_LEVEL.launches
    for level, args in align_trace.level_cases(*tracked):
        res_k, res_p, partings = align_trace.compare(args)
        err = parity.align_level_errors(res_k, res_p)
        # the pose of every hypothesis, but for those whose traces show the
        # rounding tie at which the two loops parted
        held = torch.ones_like(res_p.iterations, dtype=torch.bool)
        held[[p["hypothesis"] for p in partings if p["tie"]]] = False
        shown = [{k: p[k] for k in ("hypothesis", "pass", "kernel", "plain", "tie")}
                 for p in partings]
        assert int(res_p.num_valid.min()) > 50, level
        assert err["num_valid"] <= 5e-3 and err["energy"] <= 1e-3 and err["rmse"] <= 1e-3, err
        assert float(err["rotation"][held].max()) <= 1e-4, (level, shown)
        assert float(err["translation"][held].max()) <= 1e-4, (level, shown)
        assert int(res_k.iterations.max()) <= tracker.align_opts.max_iterations
        assert int(res_k.iterations.min()) >= 1
    assert kernels.ALIGN_LEVEL.launches == before + 3


def _ba_problem(tracker):
    """The tracker's window moved off its linearization point."""
    win = tracker.window
    gen = torch.Generator(device="cuda").manual_seed(0)
    k, n = win.num_slots, win.num_landmark_slots
    scale = torch.tensor([1e-3] * 6 + [5e-3, 0.3], device="cuda")
    eps = torch.randn((k, 8), generator=gen, device="cuda") * scale
    eps = torch.where(win.frame_valid[:, None] & ~win.frame_fixed[:, None], eps,
                      torch.zeros_like(eps))
    idepth = win.lm_idepth * (1.0 + 0.01 * torch.randn((k, n), generator=gen, device="cuda"))
    return win, eps.contiguous(), idepth.contiguous(), pba.active_lm_mask(win)


def test_ba_fej_kernel_matches_plain(tracked):
    tracker, _ = tracked
    win = tracker.window
    before = kernels.BA_FEJ.launches
    fej_k = pba._fej_cache_cuda(win, tracker.models[0])
    fej_p = pba._fej_cache_plain(win, tracker.models[0])
    assert kernels.BA_FEJ.launches == before + 1
    err = parity.fej_errors(fej_k, fej_p)
    assert err.pop("geom_valid_differ") == 0
    assert int(fej_p.geom_valid.sum()) > 100
    assert max(err.values()) <= 1e-5, err


def test_ba_evaluate_kernel_matches_plain(tracked):
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    args = (win, tracker.models[0], eps, idepth, lm_mask, tracker.pba_opts)
    ev_k = pba._evaluate_cuda(*args)
    ev_p = pba._evaluate_plain(*args)
    live = pba._pair_mask(win)[:, :, None] & lm_mask[:, None, :]
    err = parity.evaluation_errors(ev_k, ev_p, live)
    assert err["ok"] > 100 and err["agree"] >= 0.999, err
    assert max(err[name] for name in ("residuals", "gx", "gy", "energy_patch", "weight")) <= 1e-4, err


@pytest.mark.parametrize("marg_pass", [False, True])
def test_ba_linearize_kernel_matches_plain(tracked, marg_pass):
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    fej = pba._fej_cache_plain(win, tracker.models[0])
    ev = pba._evaluate_plain(win, tracker.models[0], eps, idepth, lm_mask, tracker.pba_opts)
    sys_k = pba._linearize_from_ev_cuda(win, fej, ev, eps, tracker.pba_opts, marg_pass)
    sys_p = pba._linearize_from_ev_plain(win, fej, ev, eps, tracker.pba_opts, marg_pass)
    err = parity.linear_system_errors(sys_k, sys_p)
    assert float(sys_p.h_schur.abs().max()) > 0
    assert max(err.values()) <= 1e-4, err


def test_flow_kernel_matches_plain(tracked):
    tracker, _ = tracked
    kf = tracker._kf_pose()
    hyp = _initialization_hypotheses(tracker.t_w_last, tracker.t_prev_rel, kf, False)
    t_t_kf = SE3(hyp.q[0], hyp.t[0]).inverse() @ kf
    t_t_kf = SE3(t_t_kf.q.contiguous(), t_t_kf.t.contiguous())
    before = kernels.FLOW.launches
    out_k = dm.mean_square_flows_cuda(tracker.flow_points, tracker.models[0], t_t_kf)
    out_p = dm.mean_square_flows_plain(tracker.flow_points, tracker.models[0], t_t_kf)
    assert kernels.FLOW.launches == before + 1
    assert float(out_p[0]) > 0 and float(out_p[1]) > 0
    assert parity.rel_max(out_k[0], out_p[0]) <= 1e-5
    assert parity.rel_max(out_k[1], out_p[1]) <= 1e-5


@pytest.mark.parametrize("lam", [1e-5, 1e-2])
def test_ba_solve_step_kernel_matches_plain(tracked, lam):
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts = tracker.pba_opts
    fej = pba._fej_cache_plain(win, tracker.models[0])
    ev = pba._evaluate_plain(win, tracker.models[0], eps, idepth, lm_mask, opts)
    sys = parity.contiguous(pba._linearize_from_ev_plain(win, fej, ev, eps, opts))
    out_k = pba._solve_step_cuda(win, sys, eps, idepth, lam, opts)
    out_64 = pba._solve_step_plain(parity.to_f64(win), parity.to_f64(sys), eps.double(),
                                   idepth.double(), lam, opts)
    err = parity.solve_step_errors(out_k, out_64, eps, idepth)
    assert float((out_64[0] - eps.double()).abs().max()) > 0
    assert err["step"] <= 1e-4 and err["d_step"] <= 1e-4, err


@pytest.mark.parametrize("ledger", ["empty", "filled"])
def test_ba_lm_loop_matches_host_driven_loop(tracked, ledger):
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = win.replace(eps=eps, lm_idepth=idepth)
    sys = pba._linearize_from_ev(win, pba._fej_cache(win, model),
                                 pba._evaluate(win, model, eps, idepth, lm_mask, opts), eps, opts)
    if ledger == "filled":
        win = parity.scaled_ledger(win, sys)
    else:
        win = win.replace(h_marg=torch.zeros_like(win.h_marg),
                          b_marg=torch.zeros_like(win.b_marg),
                          energy_marg=torch.zeros_like(win.energy_marg))
    log_k, log_p = [], []
    res_k = pba._solve_loop_cuda(win, model, opts, log=log_k)
    res_p = pba._solve_loop_plain(win, model, opts, log=log_p)
    err = parity.solve_loop_errors(res_k, res_p, log_k, log_p)
    assert err["same_flags"], (log_k, log_p)
    assert (err["relins"] > 0) == (ledger == "empty")
    assert err["energy"] <= 1e-4 and err["rotation"] <= 1e-4 and err["translation"] <= 1e-4, err
    assert err["status_agree"] >= 0.999, err
    # the device-resident loop reads nothing on the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        pba._solve_loop_device(win, model, opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_ba_point_status_kernel_matches_plain(tracked):
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = win.replace(eps=eps, lm_idepth=idepth)
    ev = pba._evaluate_cuda(win, model, eps, idepth, lm_mask, opts)
    ps_k = pba._point_status_from_ev_cuda(win, ev, lm_mask, opts)
    ps_p = pba._point_status_from_ev_plain(win, ev, lm_mask, opts)
    err = parity.point_status_errors(ps_k, ps_p, ev)
    assert int((ps_p.res_status == pba.RES_OUTLIER).sum()) > 0
    assert err["threshold"] <= 1e-6, err
    assert err["status_differ"] == err["inliers_differ"] == err["flags_differ"] == 0, err
    assert err["baseline"] <= 1e-6, err


def _no_host_reads(fn, *args, **kwargs):
    """``fn`` with every host synchronisation an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("masked,num_points", [(False, 400), (True, 400), (False, 5000)])
def test_candidates_kernel_matches_plain(scene, masked, num_points):
    maps = pyramid.build_pyramid_maps_cuda(scene.images[1].contiguous(), 1)[0]
    mask = None
    if masked:
        mask = torch.ones(maps.shape[1:], dtype=torch.bool, device="cuda")
        mask[180:] = False
        mask[:, ::7] = False
    before = kernels.SELECT_CANDIDATES.launches
    out_k = _no_host_reads(extractor.select_candidates_cuda, maps, num_points, mask)
    out_p = extractor.select_candidates_plain(maps, num_points, mask)
    assert kernels.SELECT_CANDIDATES.launches == before + 1
    err = parity.candidates_errors(out_k, out_p)
    assert err["valid"] > 100 and err["uv_differ"] == 0 and err["valid_differ"] == 0, err
    assert err["grad2"] == 0.0, err
    if masked:
        uv = out_k.uv[out_k.valid]
        assert float(uv[:, 1].max()) < 180 and bool((uv[:, 0].long() % 7 != 0).all())


@pytest.mark.parametrize("constant", [False, True])
def test_candidates_kernel_ragged_size_and_ties(constant):
    """100×150 (3.125 × 4.69 regions, tile 5) with a random mask; with a
    constant gradient every allowed pixel scores the same, so the order is
    that of the tile indices alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    h, w = 100, 150
    dx, dy = (np.full((h, w), 0.6), np.full((h, w), -0.5)) if constant else \
        (rng.normal(0, 20, (h, w)), rng.normal(0, 20, (h, w)))
    maps = torch.tensor(np.stack([rng.uniform(0, 255, (h, w)), dx, dy]), dtype=torch.float32,
                        device="cuda")
    mask = torch.tensor(rng.random((h, w)) < 0.6, device="cuda")
    for num_points in (300, 5000):          # 5000: more slots than the 50 x 75 tiles of 2 x 2
        out_k = extractor.select_candidates_cuda(maps, num_points, mask)
        out_p = extractor.select_candidates_plain(maps, num_points, mask)
        err = parity.candidates_errors(out_k, out_p)
        assert err["valid"] > 50 and err["uv_differ"] == 0 and err["valid_differ"] == 0, err
        assert err["grad2"] == 0.0, err


@pytest.fixture(scope="module")
def keyframe(tracked):
    """The tracker's window with the next frame pushed as its newest keyframe,
    and the banks before activation."""
    tracker, _ = tracked
    seq = render_sequence(num_frames=8, height=240, width=320, dtype=torch.float32,
                          device="cuda")
    return (tracker,) + parity.keyframe_case(tracker, seq.images[6],
                                             seq.pose(6, torch.float32, "cuda"), 6)


def test_activation_kernel_matches_plain(keyframe):
    tracker, win, imm, _ = keyframe
    model = tracker.models[0]
    min_distance = torch.tensor(1.5, device="cuda")
    before = kernels.ACTIVATION.launches
    res_k = _no_host_reads(act._activation_cuda, win, model, imm, min_distance)
    res_p = act._activation_plain(win, model, imm, min_distance)
    assert kernels.ACTIVATION.launches == before + 1
    terms = act._activation_terms_plain(win, model, imm)
    err = parity.activation_errors(res_k, res_p, terms, min_distance, model)
    assert err["n_active"] > 50 and err["activate"] > 20, err
    assert err["n_active_differ"] == 0 and err["agree"] >= 0.999 and err["unexplained"] == 0, err
    # no active landmark: every ready, valid candidate is spaced
    empty = win.replace(lm_valid=torch.zeros_like(win.lm_valid))
    res_k, res_p = (fn(empty, model, imm, 1.5) for fn in (act._activation_cuda,
                                                         act._activation_plain))
    assert int(res_k[2]) == 0 and int(res_p[0].sum()) > err["activate"]
    assert int((res_k[0] != res_p[0]).sum()) <= 1e-3 * res_p[0].numel()
    # an idepth of 0 and a point behind the camera: invalid reprojections
    odd = imm._replace(idepth_min=imm.idepth_min.clone(), idepth_max=imm.idepth_max.clone())
    odd.idepth_min[0, :8], odd.idepth_max[0, :8] = 0.0, 0.0
    odd.idepth_min[0, 8:16], odd.idepth_max[0, 8:16] = 900.0, 1100.0
    res_k, res_p = (fn(win, model, odd, min_distance) for fn in (act._activation_cuda,
                                                                 act._activation_plain))
    assert torch.equal(res_k[0][0, :16], res_p[0][0, :16])
    assert torch.equal(res_k[1][0, :16], res_p[1][0, :16])


@pytest.mark.parametrize("cap", [act.REFINE_CAP, 24])
def test_refine_and_scatter_kernels_match_plain(keyframe, cap):
    tracker, win, imm, _ = keyframe
    model = tracker.models[0]
    activate, delete, _ = act._activation_plain(win, model, imm, 1.5)
    trace_k, trace_p = [], []
    before = kernels.REFINE.launches
    out_k = _no_host_reads(act._refine_idepth_cuda, win, model, imm, activate, 20.0, cap,
                           trace_k)
    out_p = act._refine_idepth_plain(win, model, imm, activate, 20.0, cap, trace_p)
    assert kernels.REFINE.launches == before + 1
    err = parity.refine_errors(out_k, out_p, trace_k[0], trace_p[0])
    assert err["selected"] == min(cap, int(activate.sum())) > 0 and err["selected_differ"] == 0, err
    assert err["keep"] > 0 and err["accepts"] > 0 and err["kept_outside_selected"] == 0, err
    assert err["keep_agree"] >= 0.995 and err["idepth"] <= 1e-4, err
    assert err["parted_others"] <= 0.005 * err["selected"], err
    # the pairing, on the plain version's refinement
    idepth, keep, selected = out_p
    delete = delete | (selected & ~keep)
    imm2 = imm._replace(idepth_min=torch.where(keep, idepth, imm.idepth_min),
                        idepth_max=torch.where(keep, idepth, imm.idepth_max))
    # leave the newest host only a few free slots, so that take = #free there
    host = int(torch.argmax(keep.sum(dim=1)))
    lm_valid = win.lm_valid.clone()
    lm_valid[host, 5:] = True
    full = win.replace(lm_valid=lm_valid)
    before = kernels.ACTIVATION_SCATTER.launches
    for window in (win, full):
        res_k = _no_host_reads(act._activation_scatter_cuda, window, imm2, keep, delete)
        res_p = act._activation_scatter_plain(window, imm2, keep, delete)
        err = parity.scatter_errors(res_k, res_p)
        assert err.pop("n_activated") > 0
        assert not any(err.values()), err
        assert all(getattr(res_k[0], name).is_contiguous()
                   for name in ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "res_status"))
    assert kernels.ACTIVATION_SCATTER.launches == before + 2
    assert torch.equal(win.lm_valid, keyframe[1].lm_valid)      # the input window is untouched


def test_frontend_state_kernel_matches_plain(tracked):
    tracker, maps = tracked
    win, model = tracker.window, tracker.models[0]
    h, w = tracker.image_shape
    cfg = tracker.config
    boundary = parity.pixel_boundary_landmarks(win, model)
    win = win.replace(lm_valid=win.lm_valid & ~boundary)
    args = (win, model, tuple(maps), h, w, cfg.pyramid_levels, cfg.frontend_points)
    before = kernels.DEPTH_MAPS.launches
    out_k = _no_host_reads(dm.build_frontend_state_cuda, *args)
    out_p = dm.build_frontend_state_plain(*args)
    assert kernels.DEPTH_MAPS.launches == before + 1
    err = parity.frontend_errors(out_k, out_p)
    assert err["positive"][0] > 100 and min(err["valid"]) > 50, err
    assert err["weight_differ"] == 0 and err["uv_differ"] == 0 and err["valid_differ"] == 0, err
    assert err["idepth_map"] <= 1e-6 and err["idepth"] <= 1e-6 and err["intensity"] == 0.0, err
    # level 4 (15 x 20 pixels) pads its 800 slots; two runs give the same bits
    assert not bool(out_k[2][4].valid[300:].any())
    again = dm.build_frontend_state_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(out_k[0], again[0]))


@pytest.fixture(scope="module")
def marg_windows(tracked):
    """The tracker's window off its linearization point, with an empty and
    with a filled ledger."""
    tracker, _ = tracked
    win, eps, idepth, lm_mask = _ba_problem(tracker)
    opts, model = tracker.pba_opts, tracker.models[0]
    win = win.replace(eps=eps, lm_idepth=idepth)
    sys = pba._linearize_from_ev(win, pba._fej_cache(win, model),
                                 pba._evaluate(win, model, eps, idepth, lm_mask, opts), eps, opts)
    empty = win.replace(h_marg=torch.zeros_like(win.h_marg), b_marg=torch.zeros_like(win.b_marg),
                        energy_marg=torch.zeros_like(win.energy_marg))
    return {"empty": empty, "filled": parity.scaled_ledger(win, sys)}


@pytest.mark.parametrize("case", parity.MARG_CASES)
@pytest.mark.parametrize("ledger", ["empty", "filled"])
def test_marg_fold_kernel_matches_plain(tracked, marg_windows, ledger, case):
    """K15: the new ledger within ``parity.LEDGER_TOL`` of its largest entry
    (``parity.ledger_check``); the Jacobi solver converged; two runs equal to
    the bit; the window it leaves as the plain version's; no host read."""
    tracker, _ = tracked
    opts, model = tracker.pba_opts, tracker.models[0]
    start = marg_windows[ledger]
    slots = parity.marg_cases(start)[case]
    w, perm = parity.marg_case(start, case, slots, torch.Generator(device="cuda").manual_seed(1))
    h_pts, b_pts, e_land = pba._marg_system_kernel(w, model, opts)
    fold = (w, h_pts.contiguous(), b_pts.contiguous(), e_land, perm, opts)
    before = kernels.MARG_FOLD.launches
    sweeps = torch.full((1,), -1, dtype=torch.int32, device="cuda")
    out_k = _no_host_reads(pba._marginalize_cuda, *fold, sweeps)
    assert kernels.MARG_FOLD.launches == before + 1
    err = parity.ledger_check(out_k, fold)
    assert err["eigenvalues"] == 8 * len(slots)
    if case == "a dead frame" and ledger == "empty":
        assert err["dropped"] == 6, err         # only the two affine priors are kept
    assert err["within"], err
    assert 0 <= int(sweeps) < pba.MARG_MAX_SWEEPS
    assert slots or int(sweeps) == 0
    assert all(torch.equal(a, b) for a, b in zip(out_k, pba._marginalize_cuda(*fold)))
    win_k = _no_host_reads(pba._marginalize_device, w, model, perm, opts)
    win_p = pba._marginalize_with(pba._marginalize_plain, w, model, perm, opts)
    for name in ("frame_valid", "frame_id", "lm_valid", "lm_marg_flag"):
        assert torch.equal(getattr(win_k, name), getattr(win_p, name)), name


def test_marg_policy_kernel_matches_plain(tracked, marg_windows):
    """K15p: flags, outliers and the permutation equal to the plain version's
    (``parity.policy_errors``) at the tracker's window sizes and with the
    window one frame too large; no host read."""
    tracker, _ = tracked
    cfg = tracker.config
    win = marg_windows["filled"]
    frames = int(win.frame_valid.sum())
    imm_counts = torch.sum(tracker.immature.valid, dim=1)
    flagged = 0
    for lo, hi in ((cfg.window_min, cfg.window_max), (min(cfg.window_min, frames - 2), frames - 1)):
        args = (win, imm_counts, lo, hi, cfg.max_marginalized_fraction)
        before = kernels.MARG_POLICY.launches
        out_k = _no_host_reads(marg.flags_device_cuda, *args)
        assert kernels.MARG_POLICY.launches == before + 1
        out_p = marg.flags_device_plain(*args)
        err = parity.policy_errors(out_k, out_p, win, lo, hi)
        assert err["explained"], err
        flagged += err["frames_flagged"]
    assert flagged > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_row_gather_kernel_matches_plain(dtype):
    """The row gather at the probe's shapes equal to ``table[idx]`` to the
    bit; an index outside the table: a zero row from the kernel, an error
    from the checked wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    table, table_bf, idx = gather_probe.probe_inputs("cuda")
    tab = table if dtype == "f32" else table_bf
    before = kernels.ROW_GATHER.launches
    out_k = _no_host_reads(gather_probe.row_gather_cuda, tab, idx)
    assert kernels.ROW_GATHER.launches == before + 1
    assert torch.equal(out_k, gather_probe.row_gather_plain(tab, idx))
    bad = idx[:64].clone()
    bad[3], bad[9] = -1, tab.shape[0]
    out_bad = gather_probe.row_gather_cuda(tab, bad)
    assert not bool(out_bad[[3, 9]].any()) and torch.equal(out_bad[:3], tab[bad[:3]])
    with pytest.raises(IndexError):
        gather_probe.row_gather(tab, bad)


@pytest.mark.parametrize("size", [(480, 640), (479, 637)])
@pytest.mark.parametrize("raw_dtype", ["u8", "f32"])
@pytest.mark.parametrize("with_vignette", [False, True])
def test_photometric_kernel_matches_plain(size, raw_dtype, with_vignette):
    """K18 equal to its plain version to the bit: u8 and f32 frames (the f32
    ones reach past both ends of [0, 255]), with and without a vignette (some
    of it below the 1e-3 floor), at VGA and at a width that is not a multiple
    of 4; one launch per call, and an unaligned f32 view takes the scalar path
    to the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dsopp_tpu_torch.sensors import photometric as ph
    from dsopp_tpu_torch.testing import paths

    h, w = size
    gen = torch.Generator(device="cuda").manual_seed(h + w)
    lut = torch.as_tensor(paths.inverse_response(), device="cuda")
    if raw_dtype == "u8":
        raw = torch.randint(0, 256, (h, w), generator=gen, device="cuda", dtype=torch.uint8)
    else:
        raw = torch.rand((h, w), generator=gen, device="cuda") * 275.0 - 10.0
        raw[0, :6] = torch.tensor([0.0, 255.0, 254.5, -0.0, 254.99998, 17.0])
    vig = None
    if with_vignette:
        vig = torch.as_tensor(paths.sensor_vignette(h, w), device="cuda")
        vig[1, :5] = torch.tensor([0.0, 1e-4, 1e-3, -1.0, 2e-3])
    before = kernels.PHOTOMETRIC.launches
    out_k = _no_host_reads(ph.correct_image_cuda, raw, lut, vig)
    assert kernels.PHOTOMETRIC.launches == before + 1
    assert out_k.dtype == torch.float32 and tuple(out_k.shape) == (h, w)
    assert torch.equal(out_k, ph.correct_image_plain(raw, lut, vig))
    assert torch.equal(ph.correct_image(raw, lut, vig), out_k)
    if raw_dtype == "f32":
        flat = torch.empty(h * w + 1, device="cuda")
        shifted = flat[1:].view(h, w)      # 4 bytes past a 16-byte boundary
        shifted.copy_(raw)
        assert torch.equal(ph.correct_image_cuda(shifted, lut, vig), out_k)
    with pytest.raises(ValueError):
        ph.correct_image_cuda(raw.double() if raw_dtype == "f32" else raw.t(), lut, vig)
