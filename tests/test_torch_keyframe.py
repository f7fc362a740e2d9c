"""Port parity: the keyframe path in plain PyTorch (f64 on the CPU) against
the JAX package.

* ``select_candidates``: uv and valid exact;
* activation (``_activation_kernel`` + ``_refine_idepth_kernel`` +
  ``_activation_scatter``): masks and slot assignment exact, idepths 1e-9;
* the pairing's one entry (``_activation_scatter`` with the refinement's
  outputs, its glue inside) against JAX's glue and ``_activation_scatter``,
  with and without a refinement: slots, masks and bounds exact, idepths
  1e-9; the kernel's tiled pairing (``activation_models.tiled_pairing``)
  writes each entry once and pairs as the plain version;
* the refine cap at the dense operating point's 17 slots: the newest host
  bank is refined first and what exceeds the cap stays immature;
* ``_solve_loop_device``: eps and lm_idepth 1e-7 relative; res_status,
  lm_outlier and lm_inliers exact;
* ``_marginalize_device``: the ledger over repeated folds 1e-9 relative
  (the JAX ledger is double-float pairs, the port's plain float64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core.interpolate import build_pixel_map, sample
from dsopp_tpu.core.pattern import shift_pattern
from dsopp_tpu.features import extractor as jext
from dsopp_tpu.solvers import pba as jpba
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import build_test_window
from dsopp_tpu.tracker import activation as jact
from dsopp_tpu.tracker.depth_estimation import STATUS_GOOD, make_immature_points
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.features import extractor as text
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.testing.activation_models import compaction as compaction_model
from dsopp_tpu_torch.testing.activation_models import tiled_pairing
from dsopp_tpu_torch.tracker import activation as tact

from tests._torch_port import assert_close, assert_equal, np_tree, to_torch, window_fields

FRAMES = [0, 2, 4, 6]
SLOTS = 6
N_LM = 96
N_IMM = 64


@pytest.fixture(scope="module")
def seq():
    return render_sequence(num_frames=8, height=120, width=160)


def _cam(seq):
    c = seq.camera
    return convert.pinhole(c.fx, c.fy, c.cx, c.cy, c.image_size)


def _port_window(window):
    return convert.window(window_fields(window))


@pytest.mark.parametrize("num_points", [150, 600])
def test_select_candidates_matches(seq, num_points):
    pm = build_pixel_map(jnp.asarray(seq.images[3]))
    ref = jext.select_candidates(pm, num_points)
    out = text.select_candidates(to_torch(pm), num_points)
    assert_equal(out.uv, ref.uv)
    assert_equal(out.valid, ref.valid)
    assert_close(out.grad2, ref.grad2, rtol=1e-12)
    thr_j = jext._region_threshold(pm[1] ** 2 + pm[2] ** 2, 2.0)
    thr_t = text._region_threshold(to_torch(pm[1] ** 2 + pm[2] ** 2), 2.0)
    assert_equal(thr_t, thr_j)


def _ready_banks(seq, window, frames=FRAMES, ready=2, n_imm=N_IMM):
    """[K] immature banks: the first ``ready`` frames hold ready points with
    GT idepth ×1.08, the rest are empty."""
    k = window.num_slots
    banks = []
    for pos in range(k):
        pm = window.maps[pos]
        cands = jext.select_candidates(pm, n_imm)
        patches, _ = sample(pm, shift_pattern(cands.uv))
        grads, _ = sample(pm, cands.uv)
        bank = make_immature_points(cands.uv, patches[..., 0], grads[..., 1:], dtype=jnp.float64)
        if pos < ready:
            uv = np.asarray(cands.uv).astype(int)
            gt = jnp.asarray(seq.idepths[frames[pos]][uv[:, 1], uv[:, 0]] * 1.08)
            bank = bank._replace(idepth_min=gt, idepth_max=gt, traced=jnp.ones(n_imm, bool),
                                 status=jnp.full(n_imm, STATUS_GOOD, jnp.int32),
                                 uniqueness=jnp.full(n_imm, 5.0),
                                 search_interval=jnp.full(n_imm, 1.0),
                                 valid=bank.valid & cands.valid)
        else:
            bank = bank._replace(valid=jnp.zeros(n_imm, bool))
        banks.append(bank)
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *banks)


def _activation_chain_matches(seq, frames, slots, n_lm, n_imm, ready):
    """Activation, refinement and pairing through both packages on one window."""
    window = build_test_window(seq, frames, num_landmarks=n_lm, slots=slots, seed=1)
    # thin the active set so some candidates are spaced out
    window = dataclasses.replace(
        window, lm_valid=window.lm_valid & (jnp.arange(n_lm) % 3 == 0)[None])
    imm = _ready_banks(seq, window, frames, ready=ready, n_imm=n_imm)
    cam = seq.camera
    act_j, del_j, nact_j = jact._activation_kernel(window, cam, imm, 2.0)
    idep_j, act2_j, sel_j = jact._refine_idepth_kernel(window, cam, imm, act_j, 20.0)
    del2_j = del_j | (sel_j & ~act2_j)
    imm2_j = imm._replace(idepth_min=jnp.where(act2_j, idep_j, imm.idepth_min),
                          idepth_max=jnp.where(act2_j, idep_j, imm.idepth_max))
    win_j, imm3_j, n_j = jact._activation_scatter(window, imm2_j, act2_j, del2_j)

    tw = _port_window(window)
    ti = convert.immature_points(np_tree(imm._asdict()))
    tc = _cam(seq)
    act_t, del_t, nact_t = tact._activation_kernel(tw, tc, ti, 2.0)
    assert_equal(act_t, act_j)
    assert_equal(del_t, del_j)
    assert int(nact_t) == int(nact_j)
    assert 0 < int(act_t.sum()) < int(ti.valid.sum())
    idep_t, act2_t, sel_t = tact._refine_idepth_kernel(tw, tc, ti, act_t, 20.0)
    assert_equal(act2_t, act2_j)
    assert_equal(sel_t, sel_j)
    assert_close(idep_t, idep_j, rtol=1e-9)
    del2_t = del_t | (sel_t & ~act2_t)
    ti2 = ti._replace(idepth_min=torch.where(act2_t, idep_t, ti.idepth_min),
                      idepth_max=torch.where(act2_t, idep_t, ti.idepth_max))
    win_t, imm3_t, n_t = tact._activation_scatter(tw, ti2, act2_t, del2_t)
    assert int(n_t) == int(n_j) > 0
    assert_equal(win_t.lm_valid, win_j.lm_valid)
    assert_equal(win_t.res_status, win_j.res_status)
    assert_equal(imm3_t.valid, imm3_j.valid)
    assert_close(win_t.lm_uv, win_j.lm_uv, atol=0)
    assert_close(win_t.lm_idepth, win_j.lm_idepth, rtol=1e-9)
    assert_close(win_t.lm_patch, win_j.lm_patch, atol=0)
    for name in ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "res_status"):
        assert getattr(win_t, name).is_contiguous(), name       # the BA kernels take no views


def test_activation_matches(seq):
    _activation_chain_matches(seq, FRAMES, SLOTS, N_LM, N_IMM, ready=2)


def _pairing_entry_matches(seq, window, imm, refine):
    """The pairing's one entry on the port's activation (and refinement)
    against JAX's glue and ``_activation_scatter`` → the port's window."""
    cam = seq.camera
    tw = _port_window(window)
    ti = convert.immature_points(np_tree(imm._asdict()))
    tc = _cam(seq)
    act_j, del_j, _ = jact._activation_kernel(window, cam, imm, 2.0)
    act_t, del_t, _ = tact._activation_kernel(tw, tc, ti, 2.0)
    idep_t = sel_t = None
    if refine:
        idep_j, act_j, sel_j = jact._refine_idepth_kernel(window, cam, imm, act_j, 20.0)
        del_j = del_j | (sel_j & ~act_j)
        imm = imm._replace(idepth_min=jnp.where(act_j, idep_j, imm.idepth_min),
                           idepth_max=jnp.where(act_j, idep_j, imm.idepth_max))
        idep_t, act_t, sel_t = tact._refine_idepth_kernel(tw, tc, ti, act_t, 20.0)
        assert_equal(act_t, act_j)
    valid_before = ti.valid.clone()
    win_j, imm_j, n_j = jact._activation_scatter(window, imm, act_j, del_j)
    win_t, imm_t, n_t = tact._activation_scatter(tw, ti, act_t, del_t, idep_t, sel_t)
    assert int(n_t) == int(n_j) > 0
    assert torch.equal(ti.valid, valid_before)          # the caller's banks stay
    assert_equal(win_t.lm_valid, win_j.lm_valid)
    assert_equal(win_t.res_status, win_j.res_status)
    assert_equal(imm_t.valid, imm_j.valid)
    assert_close(imm_t.idepth_min, imm_j.idepth_min, rtol=1e-9)
    assert_close(imm_t.idepth_max, imm_j.idepth_max, rtol=1e-9)
    assert_close(win_t.lm_uv, win_j.lm_uv, atol=0)
    assert_close(win_t.lm_idepth, win_j.lm_idepth, rtol=1e-9)
    assert_close(win_t.lm_patch, win_j.lm_patch, atol=1e-12)
    return win_t


@pytest.mark.parametrize("refine", [False, True])
def test_pairing_entry_matches_jax_glue_and_scatter(seq, refine):
    window = build_test_window(seq, FRAMES, num_landmarks=N_LM, slots=SLOTS, seed=1)
    window = dataclasses.replace(
        window, lm_valid=window.lm_valid & (jnp.arange(N_LM) % 3 == 0)[None])
    imm = _ready_banks(seq, window, FRAMES, ready=2, n_imm=N_IMM)
    _pairing_entry_matches(seq, window, imm, refine)


@pytest.mark.parametrize("k,n,m,free,active", [(10, 250, 800, 0.5, 0.1),
                                               (17, 340, 1200, 0.3, 0.05),
                                               (7, 96, 192, 0.9, 0.5), (3, 5, 700, 1.0, 1.0),
                                               (4, 130, 40, 0.02, 0.6)])
def test_tiled_pairing_model_matches_the_plain_pairing(k, n, m, free, active):
    """``pair_slots_kernel``'s grid (tiles of 64 landmark slots, each block
    recounting its slot): every landmark slot and bank entry written once,
    the same pairs as the rank-for-rank pairing, the same taken points."""
    rng = np.random.default_rng(k * n + m)
    lm_valid = rng.random((k, n)) >= free
    activate = rng.random((k, m)) < active
    src, taken, writes_n, writes_m = tiled_pairing(lm_valid, activate)
    assert (writes_n == 1).all() and (writes_m == 1).all()
    want_src = np.full((k, n), -1)
    want_taken = np.zeros((k, m), bool)
    for a, dst, s in _pairing_model(lm_valid, activate):
        want_src[a, dst] = s
        want_taken[a, s] = True
    assert np.array_equal(src, want_src) and np.array_equal(taken, want_taken)
    assert int(want_taken.sum()) > 0


@pytest.mark.parametrize("slots,num_frames", [(5, 4), (17, 13)])
def test_activation_chain_matches_at_slots(slots, num_frames):
    """The chain at a small window and at the dense operating point's 17 slots
    (13 frames, every older bank ready)."""
    frames = list(range(num_frames))
    seq_n = render_sequence(num_frames=num_frames, height=120, width=160)
    _activation_chain_matches(seq_n, frames, slots, n_lm=48, n_imm=32, ready=num_frames - 1)


# -- host models of csrc/refine.cu's integer steps ---------------------------

def _pairing_model(lm_valid, activate):
    """Per frame slot: the r-th free landmark slot takes the r-th activating
    candidate, r < min(#free, #activating) → list of (slot, dst, src)."""
    pairs = []
    for a in range(lm_valid.shape[0]):
        free = np.flatnonzero(~lm_valid[a])
        act = np.flatnonzero(activate[a])
        pairs += [(a, int(d), int(s)) for d, s in zip(free, act)]
    return pairs


@pytest.mark.parametrize("k,m,cap,share", [(5, 40, 512, 0.3), (17, 64, 100, 0.4),
                                           (17, 64, 100, 0.02), (3, 7, 4, 1.0)])
def test_compaction_model_matches_stable_argsort(k, m, cap, share):
    rng = np.random.default_rng(k * m)
    activate = rng.random((k, m)) < share
    order, n_sel, selected = compaction_model(activate, cap)
    # the plain version's key: rank of the activating ones, the others behind in index order
    flat = np.arange(k * m)
    rank = (k - 1 - flat // m) * m + flat % m
    key = torch.tensor(np.where(activate.reshape(-1), rank, k * m + flat))
    want = torch.argsort(key, stable=True)[:cap].numpy()
    assert n_sel == min(cap, int(activate.sum()))
    assert_equal(order[:n_sel], want[:n_sel])
    assert (order[n_sel:] == -1).all()
    want_sel = np.zeros(k * m, bool)
    want_sel[want[:n_sel]] = True
    assert_equal(selected.reshape(-1), want_sel)


@pytest.mark.parametrize("k,n,m,free_share,act_share", [(5, 30, 50, 0.5, 0.2), (17, 34, 120, 0.1, 0.3),
                                                        (4, 20, 10, 1.0, 1.0), (6, 16, 40, 0.0, 0.5)])
def test_pairing_model_matches_plain_scatter(k, n, m, free_share, act_share):
    rng = np.random.default_rng(n + m)
    lm_valid = rng.random((k, n)) >= free_share
    activate = rng.random((k, m)) < act_share
    delete = (rng.random((k, m)) < 0.1) & ~activate
    window = tpba.empty_window(k, n, (3, 8, 8), dtype=torch.float64, device="cpu")
    window = window.replace(lm_valid=torch.tensor(lm_valid),
                            lm_idepth=torch.tensor(rng.random((k, n))),
                            res_status=torch.tensor(rng.integers(0, 3, (k, k, n)), dtype=torch.int32))
    f64 = lambda *shape: torch.tensor(rng.random(shape))  # noqa: E731
    imm = tact.ImmaturePoints(
        uv=f64(k, m, 2), patch=f64(k, m, 8), gradient=f64(k, m, 2), idepth_min=f64(k, m),
        idepth_max=f64(k, m), status=torch.zeros((k, m), dtype=torch.int32),
        traced=torch.ones((k, m), dtype=torch.bool), uniqueness=f64(k, m),
        search_interval=f64(k, m), valid=torch.tensor(rng.random((k, m)) < 0.9))
    out, imm_out, n_act = tact._activation_scatter_plain(window, imm, torch.tensor(activate),
                                                         torch.tensor(delete))
    pairs = _pairing_model(lm_valid, activate)
    assert int(n_act) == len(pairs)
    want_valid, want_status = lm_valid.copy(), window.res_status.numpy().copy()
    want_imm = imm.valid.numpy() & ~delete
    want_idepth = window.lm_idepth.numpy().copy()
    for a, dst, src in pairs:
        want_valid[a, dst] = True
        want_status[a, :, dst] = tpba.RES_OK
        want_imm[a, src] = False
        want_idepth[a, dst] = float(imm.idepth[a, src])
        assert_equal(out.lm_uv[a, dst], imm.uv[a, src])
        assert_equal(out.lm_patch[a, dst], imm.patch[a, src])
    assert_equal(out.lm_valid, want_valid)
    assert_equal(out.res_status, want_status)
    assert_equal(imm_out.valid, want_imm)
    assert_equal(out.lm_idepth, want_idepth)


def test_refine_cap_takes_the_newest_bank_first_at_17_slots():
    """The dense operating point's window (17 slots, 13 frames here) with more
    activating candidates than the refine cap: the cap goes to the newest
    host banks, and a candidate beyond it is neither selected nor kept."""
    frames = list(range(13))
    n_imm, cap = 16, 40
    seq13 = render_sequence(num_frames=len(frames), height=120, width=160)
    window = build_test_window(seq13, frames, num_landmarks=24, slots=17, seed=6)
    imm = _ready_banks(seq13, window, frames, ready=len(frames), n_imm=n_imm)
    activate = imm.valid
    assert int(activate.sum()) > 2 * cap
    idep_j, keep_j, sel_j = jact._refine_idepth_kernel(window, seq13.camera, imm, activate,
                                                       20.0, cap=cap)
    ti = convert.immature_points(np_tree(imm._asdict()))
    idep_t, keep_t, sel_t = tact._refine_idepth_kernel(_port_window(window), _cam(seq13), ti,
                                                       to_torch(activate), 20.0, cap=cap)
    assert_equal(sel_t, sel_j)
    assert_equal(keep_t, keep_j)
    assert_close(idep_t, idep_j, rtol=1e-9)
    per_bank = sel_t.sum(dim=1).tolist()
    act_bank = np.asarray(activate).sum(axis=1).tolist()
    assert sum(per_bank) == cap
    newest = len(frames) - 1
    assert per_bank[newest] == act_bank[newest] > 0          # the newest bank is whole
    first = min(b for b in range(17) if per_bank[b])
    assert all(per_bank[b] == act_bank[b] for b in range(first + 1, 17))
    assert not any(per_bank[:first]) and per_bank[first] <= act_bank[first]
    assert not bool((keep_t & ~sel_t).any())
    assert int(keep_t.sum()) > 0


@pytest.fixture(scope="module")
def solved(seq):
    window = build_test_window(seq, FRAMES, num_landmarks=N_LM, slots=SLOTS,
                               pose_noise=3e-3, idepth_noise=0.05, seed=2)
    exposure = jnp.asarray([1.0, 1.1, 0.95, 1.02, 1.0, 1.0])
    window = dataclasses.replace(window, exposure=exposure)
    out_j, e_j, n_j = jpba._solve_loop_device(window, seq.camera, jpba.PBAOptions())
    out_t, e_t, n_t = tpba._solve_loop_device(_port_window(window), _cam(seq), tpba.PBAOptions())
    return window, (out_j, e_j, n_j), (out_t, e_t, n_t)


def test_solve_loop_matches(solved):
    _, (out_j, e_j, n_j), (out_t, e_t, n_t) = solved
    assert int(n_t) == int(n_j)
    assert_close(e_t, e_j, rtol=1e-7)
    # with an empty ledger every accepted step is folded into t_lin
    assert_close(out_t.eps, out_j.eps, rtol=1e-7, atol=1e-12)
    assert_close(out_t.affine0, out_j.affine0, rtol=1e-7, atol=1e-12)
    assert_close(out_t.t_lin_q, out_j.t_lin_q, rtol=1e-7, atol=1e-10)
    assert_close(out_t.t_lin_t, out_j.t_lin_t, rtol=1e-7, atol=1e-10)
    assert_close(out_t.lm_idepth, out_j.lm_idepth, rtol=1e-7, atol=1e-12)
    assert_equal(out_t.res_status, out_j.res_status)
    assert_equal(out_t.lm_outlier, out_j.lm_outlier)
    assert_equal(out_t.lm_inliers, out_j.lm_inliers)
    assert_equal(out_t.lm_opt_count, out_j.lm_opt_count)
    assert_close(out_t.lm_baseline, out_j.lm_baseline, rtol=1e-7, atol=1e-12)


def _ledger(w):
    if isinstance(w, tpba.Window):
        return [w.h_marg, w.b_marg, w.energy_marg]
    return [np.asarray(w.h_marg) + np.asarray(w.h_marg_lo),
            np.asarray(w.b_marg) + np.asarray(w.b_marg_lo),
            np.asarray(w.energy_marg) + np.asarray(w.energy_marg_lo)]


def test_marginalize_ledger_over_repeated_folds(seq, solved):
    """Fold landmarks, then a frame, then landmarks of the compacted window."""
    _, (wj, _, _), (wt, _, _) = solved
    opts_j, opts_t = jpba.PBAOptions(), tpba.PBAOptions()
    cam_j, cam_t = seq.camera, _cam(seq)
    k = wj.num_slots
    rng = np.random.default_rng(4)
    for step, frame in enumerate([None, 1, None]):
        lm = rng.random((k, N_LM)) < 0.25
        frames = np.zeros(k, bool)
        if frame is not None:
            frames[frame] = True
        wj = dataclasses.replace(wj, lm_marg_flag=jnp.asarray(lm) & wj.lm_valid,
                                 frame_marg=jnp.asarray(frames))
        wt = wt.replace(lm_marg_flag=torch.as_tensor(lm) & wt.lm_valid,
                        frame_marg=torch.as_tensor(frames))
        fv = np.asarray(wj.frame_valid)
        kept = np.where(~frames & fv)[0]
        perm = np.concatenate([kept, [i for i in range(k) if i not in kept]]).astype(np.int32)
        wj = jpba._marginalize_device(wj, cam_j, jnp.asarray(perm), opts_j, True, True)
        wt = tpba._marginalize_device(wt, cam_t, torch.as_tensor(perm, dtype=torch.long), opts_t)
        for name, a, b in zip(("H", "b", "E"), _ledger(wt), _ledger(wj)):
            scale = float(np.max(np.abs(b)))
            assert scale > 0, (step, name)
            assert_close(a, b, rtol=1e-9, atol=1e-9 * scale, err_msg=f"fold {step} {name}")
        assert_equal(wt.frame_valid, wj.frame_valid)
        assert_equal(wt.frame_id, wj.frame_id)
        assert_equal(wt.lm_valid, wj.lm_valid)
        assert_close(wt.maps, wj.maps, atol=0)
    assert int(wt.frame_valid.sum()) == len(FRAMES) - 1
