"""Port parity at C > 1 frame-embedder channels: the plain versions of the
kernels whose channel axis the port carries (K7, K8 with K6's FEJ inside,
K10's loop, K11, K15's fold, K14's pairing and refinement, K2 and K3) against
the JAX package, both f64 on the CPU, at 120×160.

On a JAX window of C = 2 and 3 channels (``build_test_window(…,
embedder=FilterBankEmbedder(…))``: the JAX package's bank, and its first two
filters) after the marginalization of one frame, so that its slot-indirect
patch bank is permuted (``patch_map`` not the identity):

* ``convert.window`` reads each slot's channels through ``patch_map``: the
  port's channel bank equals ``build_pixel_map`` of the JAX embedder's
  channels of that slot's intensity, exactly;
* ``_evaluate_plain`` with the window moved off its linearization point
  (``tests/test_torch_ba.py`` holds the FEJ, the evaluation and the
  linearization at C = 1, 2 and 3 on an unpermuted window): floats 1e-9
  relative to the array's largest entry, masks and statuses exact;
* the plain LM solve loop against ``_solve_loop_device`` (empty ledger:
  relinearizing; and the folded ledger): energy and poses 1e-7 relative,
  counts and statuses exact (``tests/test_torch_ba_solve.py``'s);
* the point statuses after the solve, exact, and the baselines 1e-9;
* the marginalization fold of a further frame: the ledger within 1e-9 of its
  largest entry (``tests/test_torch_marginalization.py``'s);
* ``embedded_patches`` at points near the image border (a window that leaves
  the image, corners clamped into the window) and the whole activation chain
  (activation, refinement, pairing): patches 1e-12 absolute (intensities
  0..255), masks exact, idepths 1e-9; the pairing's one entry (the
  refinement's glue inside) against JAX's glue and pairing, with and without
  a refinement;
* the refinement on a bank whose channel 0 is a Scharr filter, not the
  intensity: the port samples channel 0 of the bank as JAX does (the same
  decisions, idepths 1e-9), and keeps nothing where the default bank keeps;
* ``residual_system_plain`` and ``align_level_plain`` on two embedded frames
  (``tests/features/test_embedder.py``'s setup), with σ·√C: H, b and energy
  1e-9 relative, the solved pose 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core.interpolate import build_pixel_map as jbuild_pixel_map
from dsopp_tpu.core.interpolate import sample as jsample
from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.features.embedder import FilterBankEmbedder
from dsopp_tpu.solvers import pba as jpba
from dsopp_tpu.solvers import pose_alignment as jpa
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import build_test_window
from dsopp_tpu.tracker import activation as jact
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.core.interpolate import build_pixel_map
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.solvers import pose_alignment as tpa
from dsopp_tpu_torch.tracker import activation as tact

from tests._torch_port import assert_close, assert_equal, np_tree, to_np, to_torch, window_fields
from tests.test_torch_keyframe import _pairing_entry_matches, _ready_banks

FRAMES = [0, 2, 4, 6, 8]
SLOTS = 6
N_LM = 48
N_IMM = 48
SCHARR_X = [[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]]
BANK = np.asarray(FilterBankEmbedder().filters)


def _bank(channels):
    return FilterBankEmbedder(BANK[:channels])


def _cam(seq):
    c = seq.camera
    return convert.pinhole(c.fx, c.fy, c.cx, c.cy, c.image_size)


def _fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _close(actual, expected, name, rtol=1e-9):
    scale = float(np.max(np.abs(to_np(expected))))
    assert_close(actual, expected, rtol=rtol, atol=rtol * scale, err_msg=name)


@pytest.fixture(scope="module")
def seq():
    return render_sequence(num_frames=10, height=120, width=160)


@pytest.fixture(scope="module", params=[2, 3], ids=lambda c: f"C{c}")
def marginalized(request, seq):
    """A JAX window of C channels whose frame slot 1 was marginalized (the
    patch bank permuted), its states moved off the linearization point."""
    c = request.param
    w = build_test_window(seq, FRAMES, num_landmarks=N_LM, slots=SLOTS, pose_noise=3e-3,
                          idepth_noise=0.05, seed=4, embedder=_bank(c))
    flags = np.zeros(SLOTS, bool)
    flags[1] = True
    w = dataclasses.replace(w, frame_marg=jnp.asarray(flags),
                            lm_marg_flag=w.lm_valid & jnp.asarray(flags)[:, None])
    w = jpba.marginalize(w, seq.camera)
    assert w.num_channels == c
    assert not np.array_equal(np.asarray(w.patch_map), np.arange(SLOTS))
    assert float(jnp.max(jnp.abs(w.h_marg))) > 0
    rng = np.random.default_rng(11)
    eps = rng.normal(size=(SLOTS, 8)) * np.array([2e-3] * 6 + [1e-2, 0.5])
    eps *= np.asarray(w.frame_valid & ~w.frame_fixed)[:, None]
    moved = dataclasses.replace(w, eps=jnp.asarray(eps))
    idepth = w.lm_idepth * jnp.asarray(1.0 + 0.02 * rng.normal(size=(SLOTS, N_LM)))
    return dict(c=c, window=w, moved=moved, idepth=idepth, cam=seq.camera, tcam=_cam(seq))


def test_convert_reads_the_permuted_patch_bank(marginalized):
    w = marginalized["window"]
    tw = convert.window(window_fields(w))
    c = marginalized["c"]
    assert tw.num_channels == c and tw.channel_maps.shape == (SLOTS, 3 * c, 120, 160)
    emb = _bank(c)
    live = np.asarray(w.frame_valid)
    for j in np.flatnonzero(live):
        want = build_pixel_map(to_torch(emb(w.maps[j][0])))
        assert_equal(tw.channel_maps[j], want, err_msg=f"slot {j}")
    # the indirection matters: a slot's own physical table is another frame's
    j = next(j for j in np.flatnonzero(live) if int(w.patch_map[j]) != j)
    own = convert.embedded_channels(np.asarray(w.patch)[[j]], [0], 120, 160)[0]
    assert not np.array_equal(own, to_np(tw.channel_maps[j][:c]))


def test_evaluate_matches_through_the_permuted_bank(marginalized):
    """K7's plain version reads each target's channels from the converted
    bank; JAX's reads its tables through ``patch_map``."""
    w, cam, tcam = marginalized["moved"], marginalized["cam"], marginalized["tcam"]
    tw = convert.window(window_fields(w))
    opts = jpba.PBAOptions()
    lm_mask = jpba.active_lm_mask(w)
    ev_j = jpba._evaluate(w, cam, w.eps, marginalized["idepth"], lm_mask, opts)
    ev_t = tpba._evaluate_plain(tw, tcam, tw.eps, to_torch(marginalized["idepth"]),
                                to_torch(lm_mask), tpba.PBAOptions())
    ref_ev = convert.evaluation(_fields(ev_j))
    assert_equal(ev_t.ok, ref_ev.ok)
    assert_equal(ev_t.status_candidate, ref_ev.status_candidate)
    assert int(ev_t.ok.sum()) > 100
    for name in ("residuals", "energy_patch", "weight"):
        _close(getattr(ev_t, name), getattr(ref_ev, name), name)
    m = ref_ev.ok[..., None, None]
    for name in ("gx", "gy"):
        _close(torch.where(m, getattr(ev_t, name), 0.0),
               torch.where(m, getattr(ref_ev, name), 0.0), name)


@pytest.mark.parametrize("ledger", ["empty", "folded"])
def test_solve_loop_and_point_status_match(marginalized, ledger):
    w = marginalized["window"]
    if ledger == "empty":
        w = dataclasses.replace(w, h_marg=jnp.zeros_like(w.h_marg),
                                b_marg=jnp.zeros_like(w.b_marg),
                                energy_marg=jnp.zeros_like(w.energy_marg),
                                h_marg_lo=jnp.zeros_like(w.h_marg),
                                b_marg_lo=jnp.zeros_like(w.b_marg),
                                energy_marg_lo=jnp.zeros_like(w.energy_marg))
    w = dataclasses.replace(w, eps=marginalized["moved"].eps)
    out_j, e_j, n_j = jpba._solve_loop_device(w, marginalized["cam"], jpba.PBAOptions())
    log = []
    out_t, e_t, n_t = tpba._solve_loop_plain(convert.window(window_fields(w)),
                                             marginalized["tcam"], tpba.PBAOptions(), log=log)
    assert int(n_t) == int(n_j) > 0
    assert_close(e_t, e_j, rtol=1e-7)
    assert any(row["relin"] for row in log) == (ledger == "empty")
    assert_close(out_t.poses().q, out_j.poses().q, rtol=1e-7, atol=1e-10)
    assert_close(out_t.poses().t, out_j.poses().t, rtol=1e-7, atol=1e-10)
    _close(out_t.lm_idepth, out_j.lm_idepth, "lm_idepth", 1e-7)
    for name in ("res_status", "lm_outlier", "lm_inliers", "lm_opt_count"):
        assert_equal(getattr(out_t, name), getattr(out_j, name), err_msg=name)
    # K11 alone on the solved window
    ps_j = convert.point_status(jpba._point_status_kernel(out_j, marginalized["cam"],
                                                          jpba.PBAOptions()))
    ps_t = tpba._point_status_plain(convert.window(window_fields(out_j)), marginalized["tcam"],
                                    tpba.PBAOptions())
    for name in ("res_status", "lm_inliers", "lm_outlier", "lm_opt_count"):
        assert_equal(getattr(ps_t, name), getattr(ps_j, name), err_msg=name)
    _close(ps_t.lm_baseline, ps_j.lm_baseline, "lm_baseline")


def test_marginalize_matches(marginalized):
    """The fold of the frame in slot 2 and a fifth of the landmarks."""
    w = marginalized["moved"]
    k = w.num_slots
    frames = np.zeros(k, bool)
    frames[2] = True
    lm = jnp.asarray(np.random.default_rng(3).random((k, N_LM)) < 0.2) & w.lm_valid
    w = dataclasses.replace(w, frame_marg=jnp.asarray(frames), lm_marg_flag=lm)
    valid = np.asarray(w.frame_valid)
    perm = np.concatenate([np.flatnonzero(valid & ~frames), np.flatnonzero(~valid | frames)])
    out_j = jpba._marginalize_device(w, marginalized["cam"], jnp.asarray(perm),
                                     jpba.PBAOptions(), True, True)
    out_t = tpba._marginalize_device(convert.window(window_fields(w)), marginalized["tcam"],
                                     torch.as_tensor(perm, dtype=torch.int64), tpba.PBAOptions())
    for name, got, hi, lo in (("H", out_t.h_marg, out_j.h_marg, out_j.h_marg_lo),
                              ("b", out_t.b_marg, out_j.b_marg, out_j.b_marg_lo),
                              ("E", out_t.energy_marg, out_j.energy_marg, out_j.energy_marg_lo)):
        want = np.asarray(hi) + np.asarray(lo)
        err = float(np.max(np.abs(to_np(got) - want))) / float(np.max(np.abs(want)))
        assert err <= 1e-9, f"{name}: {err:.3g} of the largest entry"
    assert_equal(out_t.frame_valid, out_j.frame_valid)
    assert_equal(out_t.lm_valid, out_j.lm_valid)
    # the channel bank follows the permutation: converted again, the same maps
    again = convert.window(window_fields(out_j))
    assert_equal(out_t.channel_maps, again.channel_maps)


def test_embedded_patches_near_the_border(marginalized):
    w = marginalized["window"]
    rng = np.random.default_rng(5)
    k, m = SLOTS, 40
    uv = np.stack([rng.uniform(0.0, 159.0, (k, m)), rng.uniform(0.0, 119.0, (k, m))], -1)
    # a border band: the pattern (±2 px) and its window leave the image
    uv[:, :10, 0] = rng.uniform(0.0, 2.5, (k, 10))
    uv[:, 10:20, 0] = rng.uniform(156.5, 159.0, (k, 10))
    uv[:, 20:30, 1] = rng.uniform(116.5, 119.0, (k, 10))
    want = jact.embedded_patches(w, jnp.asarray(uv))
    got = tact.embedded_patches(convert.window(window_fields(w)), to_torch(uv))
    assert got.shape == (k, m, marginalized["c"] * 8)
    assert_close(got, want, atol=1e-12)


def _activation_chain(seq, window, imm, pairs=True):
    """Activation, refinement and pairing of both packages on one window, the
    port's against JAX's (``pairs``: some points must move into the window)
    → the port's (refined idepth, keep, paired window)."""
    cam = seq.camera
    act_j, del_j, _ = jact._activation_kernel(window, cam, imm, 2.0)
    idep_j, act2_j, sel_j = jact._refine_idepth_kernel(window, cam, imm, act_j, 20.0)
    imm2_j = imm._replace(idepth_min=jnp.where(act2_j, idep_j, imm.idepth_min),
                          idepth_max=jnp.where(act2_j, idep_j, imm.idepth_max))
    win_j, imm3_j, n_j = jact._activation_scatter(window, imm2_j, act2_j,
                                                  del_j | (sel_j & ~act2_j))
    tw = convert.window(window_fields(window))
    ti = convert.immature_points(np_tree(imm._asdict()))
    act_t, del_t, _ = tact._activation_kernel(tw, _cam(seq), ti, 2.0)
    idep_t, act2_t, sel_t = tact._refine_idepth_kernel(tw, _cam(seq), ti, act_t, 20.0)
    ti2 = ti._replace(idepth_min=torch.where(act2_t, idep_t, ti.idepth_min),
                      idepth_max=torch.where(act2_t, idep_t, ti.idepth_max))
    win_t, imm3_t, n_t = tact._activation_scatter(tw, ti2, act2_t, del_t | (sel_t & ~act2_t))
    assert_equal(act_t, act_j)
    assert_equal(sel_t, sel_j)
    assert_equal(act2_t, act2_j)
    assert_close(idep_t, idep_j, rtol=1e-9)
    assert int(n_t) == int(n_j)
    assert (int(n_t) > 0) == pairs
    assert_equal(win_t.lm_valid, win_j.lm_valid)
    assert_equal(win_t.res_status, win_j.res_status)
    assert_equal(imm3_t.valid, imm3_j.valid)
    assert_close(win_t.lm_idepth, win_j.lm_idepth, rtol=1e-9)
    assert_close(win_t.lm_patch, win_j.lm_patch, atol=1e-12)
    return idep_t, act2_t, win_t


def _channel_window(seq, embedder):
    window = build_test_window(seq, FRAMES[:4], num_landmarks=96, slots=SLOTS, seed=1,
                               embedder=embedder)
    return dataclasses.replace(window,
                               lm_valid=window.lm_valid & (jnp.arange(96) % 3 == 0)[None])


def test_activation_chain_matches_at_c3(seq):
    window = _channel_window(seq, FilterBankEmbedder())
    imm = _ready_banks(seq, window, FRAMES[:4], ready=2, n_imm=N_IMM)
    _, _, win_t = _activation_chain(seq, window, imm)
    assert win_t.lm_patch.shape[-1] == 3 * 8


@pytest.mark.parametrize("refine", [False, True])
def test_pairing_entry_matches_jax_glue_and_scatter_at_c3(seq, refine):
    """The pairing's one entry samples the moved points' C-channel patches,
    with and without the refinement's glue inside."""
    window = _channel_window(seq, FilterBankEmbedder())
    imm = _ready_banks(seq, window, FRAMES[:4], ready=2, n_imm=N_IMM)
    win_t = _pairing_entry_matches(seq, window, imm, refine)
    assert win_t.lm_patch.shape[-1] == 3 * 8


def test_refinement_reads_channel_zero_of_the_bank(seq):
    """A bank whose channel 0 is a Scharr filter: the refinement samples it,
    as JAX's does, against the immature points' intensity patches, which it
    then rejects all (nothing pairs); on the default bank, whose channel 0 is
    the intensity, it keeps some."""
    scharr = np.stack([np.asarray(SCHARR_X) / 16.0, BANK[0], np.asarray(SCHARR_X).T / 16.0])
    window = _channel_window(seq, FilterBankEmbedder(scharr))
    imm = _ready_banks(seq, window, FRAMES[:4], ready=2, n_imm=N_IMM)
    _, keep_t, _ = _activation_chain(seq, window, imm, pairs=False)
    intensity = _channel_window(seq, FilterBankEmbedder(BANK))
    tw = convert.window(window_fields(intensity))
    ti = convert.immature_points(np_tree(imm._asdict()))
    act, _, _ = tact._activation_kernel(tw, _cam(seq), ti, 2.0)
    assert int(act.sum()) > 0
    _, keep_i, _ = tact._refine_idepth_kernel(tw, _cam(seq), ti, act, 20.0)
    assert int(keep_t.sum()) == 0 < int(keep_i.sum())


def _align_problem(channels):
    """tests/features/test_embedder.py's setup: frames 2 and 3 embedded, the
    reference points on frame 2's gradient-rich pixels with GT idepth."""
    seq = render_sequence(num_frames=6, height=120, width=160, seed=21, advance=0.06)
    emb = _bank(channels)
    ref_map = jbuild_pixel_map(emb(jnp.asarray(seq.images[2])))
    tgt_map = jbuild_pixel_map(emb(jnp.asarray(seq.images[3])))
    rng = np.random.default_rng(2)
    uv = jnp.asarray(np.stack([rng.uniform(6, 153, 600), rng.uniform(6, 113, 600)], -1))
    idepths = np.asarray(seq.idepths[2])
    idep = jnp.asarray(idepths[np.asarray(uv[:, 1]).astype(int), np.asarray(uv[:, 0]).astype(int)])
    vals, inside = jsample(ref_map[:channels], uv)
    pts = jpa.LevelPoints(uv=uv, idepth=idep, intensity=vals, valid=inside)
    t_gt = seq.t_target_ref(3, 2)
    t_init = JSE3.exp(jnp.asarray([0.003, -0.002, 0.0025, 0.0008, -0.001, 0.0005])) @ t_gt
    tpts = tpa.LevelPoints(*(to_torch(x) for x in pts))
    return seq, pts, tpts, tgt_map, t_init


@pytest.mark.parametrize("channels", [2, 3])
def test_alignment_matches_at_c(channels):
    seq, pts, tpts, tgt_map, t_init = _align_problem(channels)
    cam = seq.camera
    zero = jnp.zeros(2)
    opts = jpa.AlignmentOptions()
    ttgt, tcam = to_torch(tgt_map), _cam(seq)
    tinit = tpa.SE3(to_torch(t_init.q)[None], to_torch(t_init.t)[None])
    e_j, n_j, (h_j, b_j) = jpa._residual_system(pts, tgt_map, cam, t_init, zero, zero,
                                                jnp.asarray(1.0), opts, with_jacobian=True)
    e_t, n_t, h_t, b_t = tpa.residual_system(tpts, ttgt, tcam, tinit, torch.zeros(1, 2),
                                             torch.zeros(2, dtype=torch.float64),
                                             torch.tensor(1.0, dtype=torch.float64),
                                             tpa.AlignmentOptions())
    assert int(n_t[0]) == int(n_j) > 300
    _close(e_t[0], e_j, "energy")
    _close(h_t[0], h_j, "H")
    _close(b_t[0], b_j, "b")
    res_j = jpa.align_level(pts, tgt_map, cam, t_init, zero, zero, jnp.asarray(1.0), opts)
    res_t = tpa.align_level_plain(tpts, ttgt, tcam, tinit, torch.zeros(1, 2, dtype=torch.float64),
                                  torch.zeros(2, dtype=torch.float64),
                                  torch.tensor(1.0, dtype=torch.float64), tpa.AlignmentOptions())
    assert int(res_t.num_valid[0]) == int(res_j.num_valid)
    assert_close(res_t.t_t_r.q[0], res_j.t_t_r.q, rtol=1e-9, atol=1e-12)
    assert_close(res_t.t_t_r.t[0], res_j.t_t_r.t, rtol=1e-9, atol=1e-12)
    _close(res_t.energy[0], res_j.energy, "energy")
    delta = (tpa.SE3(to_torch(seq.t_target_ref(3, 2).q), to_torch(seq.t_target_ref(3, 2).t))
             .inverse() @ tpa.SE3(res_t.t_t_r.q[0], res_t.t_t_r.t[0]))
    assert float(delta.t.norm()) < 5e-3            # the JAX test's gate
