"""A host model of kernel K15p (``csrc/marg_policy.cu``, the marginalization
policy) against the port's plain version (``flags_device_plain``) and the JAX
package's ``flags_device``, on rendered windows.

The model repeats the kernel's steps in f32: each frame's position composed
as ``ba_body.cuh::frame_pose`` does (``testing/activation_models.py``'s
mirror), the frame's live landmarks and valid immature points counted as
integers, DSO eq (20) summed in slot order with the kernel's operations, the
frame flags decided in slot order (the exclusive cumsum of rule 1, the first
argmax of rule 2), the kept-first permutation and the landmark triage.

On a 13-frame window of 17 slots (positions up to ~2 m, ids with gaps, eps
off the linearization point, mixed statuses and counts), with an empty and
with a filled ledger, in four cases:

* too few live points: a frame whose landmarks are all outliers and whose
  bank holds no immature point, the window within its size (rule 1 alone;
  the reference counts a frame's total as its live points, so the share never
  falls and no frame is flagged: the landmark triage alone acts);
* the eq (20) argmax: the window two frames too large (rules 1 and 2);
* the window one frame too large;
* near-tied scores: a frame moved until its eq (20) score equals the best
  one's in f64.

Outside a tie the model equals JAX's flags (f64) and the plain version's
(f32) bit for bit; at the tie ``parity.policy_errors`` must explain every
difference (the two top scores closer than their bounds, the rest the plain
triage of the model's flags).  The model's positions meet ``window.poses()``
within ``parity.KERNEL_POSE_ULPS``, and its scores meet the plain version's
within ``parity.eq20_score_bounds``: the tie band the card's gate uses holds
the spread the kernel's poses cause.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.solvers import pba as jpba
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import build_test_window
from dsopp_tpu.tracker import marginalization as jmarg
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.testing import activation_models as am
from dsopp_tpu_torch.testing import parity
from dsopp_tpu_torch.tracker import marginalization as tmarg

from tests._torch_port import assert_equal, window_fields

F32 = np.float32
SLOTS, N_LM, M_IMM = 17, 24, 40
FRAMES = list(range(0, 25, 2))          # 13 keyframes, ids with gaps
MIN_SIZE, FRACTION = 3, 0.95
CASES = ("too_few_live", "eq20_argmax", "one_too_large", "near_tie")


def model(window, immature_valid, minimum_size, maximum_size, fraction):
    """K15p's outputs (frame flags, landmark flags, new outliers, perm) and
    its eq (20) scores, step by step as the kernel computes them."""
    k, n = window.num_slots, window.num_landmark_slots
    fv = window.frame_valid.numpy()
    f = int(fv.sum())
    newest = max(f - 1, 0)
    _, t = am.frame_poses(window.t_lin_q, window.t_lin_t, window.eps)
    pos = torch.stack(t, dim=-1).numpy().astype(F32)
    ids = window.frame_id.numpy()
    live = window.lm_valid.numpy() & ~window.lm_outlier.numpy()
    active = live.sum(axis=1) + immature_valid.numpy().sum(axis=1)

    score = np.zeros(k, F32)
    newest_id = ids[newest]
    for i in range(k):
        inv_sum = F32(0.0)
        for j in range(k):
            term = F32(0.0)
            if j < f - 2 and ids[j] + 1 <= newest_id + 1 and j != i:
                dx, dy, dz = pos[i] - pos[j]
                term = F32(1.0) / (F32(1e-5) + np.sqrt((dx * dx + dy * dy) + dz * dz))
            inv_sum = F32(inv_sum + term)
        dx, dy, dz = pos[i] - pos[newest]
        if i < f - 2 and ids[i] + 1 <= newest_id:
            score[i] = np.sqrt(np.sqrt((dx * dx + dy * dy) + dz * dz)) * inv_sum

    keep_fraction = F32(1.0 - fraction)
    flag = np.zeros(k, bool)
    prior = flagged1 = 0
    for i in range(k):
        total = int(active[i])
        cand = i < f - 2 and total > 0 and F32(active[i]) < keep_fraction * F32(total)
        flag[i] = cand and f - prior > minimum_size
        flagged1 += int(flag[i])
        prior += int(cand)
    best = 0
    for i in range(1, k):
        if score[i] > score[best]:
            best = i
    if f > maximum_size + flagged1 and score[best] > 0:
        flag[best] = True
    kept = [i for i in range(k) if fv[i] and not flag[i]]
    perm = np.asarray(kept + [i for i in range(k) if i not in kept], np.int64)

    status = window.res_status.numpy()[:, newest]
    tri = np.asarray([i < f - 1 and f > 2 for i in range(k)])[:, None]
    oob = (status != 0) | flag[:, None]
    valid_marg = ((window.lm_inliers.numpy() >= (minimum_size + 1) // 2)
                  & (window.lm_opt_count.numpy() > maximum_size * 2))
    sufficient = window.lm_opt_count.numpy() > 0
    out = tri & live & oob & ~sufficient
    marg = (tri & live & ~out & (oob | valid_marg)) | (
        (np.arange(k) < f)[:, None] & flag[:, None] & live & ~out)
    flags = (torch.as_tensor(flag), torch.as_tensor(marg), torch.as_tensor(out),
             torch.as_tensor(perm))
    return flags, torch.as_tensor(score), torch.as_tensor(pos)


@pytest.fixture(scope="module")
def seq():
    return render_sequence(num_frames=max(FRAMES) + 1, height=120, width=160)


@pytest.fixture(scope="module", params=["empty", "filled"], ids=["empty_ledger", "filled_ledger"])
def base(request, seq):
    """A 13-frame JAX window moved off its linearization point, with mixed
    statuses and counts; with a landmark fold in its ledger for "filled"."""
    w = build_test_window(seq, FRAMES, num_landmarks=N_LM, slots=SLOTS, pose_noise=2e-3,
                          idepth_noise=0.03, seed=5)
    rng = np.random.default_rng(21)
    fv = np.asarray(w.frame_valid)
    free = (fv & ~np.asarray(w.frame_fixed))[:, None]
    w = dataclasses.replace(
        w, eps=jnp.asarray(rng.normal(size=(SLOTS, 8)) * np.array([3e-3] * 6 + [5e-3, 0.3]) * free),
        frame_id=jnp.asarray(np.where(fv, np.asarray(w.frame_id), -1).astype(np.int32)),
        lm_outlier=jnp.asarray(rng.random((SLOTS, N_LM)) < 0.15) & w.lm_valid,
        lm_inliers=jnp.asarray(rng.integers(0, 6, (SLOTS, N_LM)).astype(np.int32)),
        lm_opt_count=jnp.asarray(rng.integers(0, 24, (SLOTS, N_LM)).astype(np.int32)),
        res_status=jnp.asarray(np.where(rng.random((SLOTS, SLOTS, N_LM)) < 0.7, jpba.RES_OK,
                                        jpba.RES_OOB).astype(np.int32)))
    if request.param == "filled":
        lm = jnp.asarray(rng.random((SLOTS, N_LM)) < 0.25) & w.lm_valid
        w = dataclasses.replace(w, lm_marg_flag=lm, frame_marg=jnp.zeros(SLOTS, bool))
        w = jpba._marginalize_device(w, seq.camera, jnp.arange(SLOTS, dtype=jnp.int32),
                                     jpba.PBAOptions(), True, True)
        assert float(jnp.max(jnp.abs(w.h_marg))) > 0
    imm = rng.random((SLOTS, M_IMM)) < 0.5
    imm[~fv] = False
    return w, imm


def _scores64(w):
    return tmarg.eq20_scores(convert.window(window_fields(w))).numpy()


def _tie(w):
    """``w`` with a frame moved along the corridor until its eq (20) score
    equals the best one's in f64 (bisection on the distance moved)."""
    s = _scores64(w)
    best, second = np.argsort(s)[::-1][:2]
    t0 = np.asarray(w.t_lin_t)

    def gap(alpha):
        t = t0.copy()
        t[second] = t0[second] + alpha * (t0[best] - t0[second])
        moved = dataclasses.replace(w, t_lin_t=jnp.asarray(t))
        sc = _scores64(moved)
        return sc[best] - sc[second], moved

    lo, hi = 0.0, 1.5
    # the second frame moved half-way past the best one's position overtakes it
    assert gap(lo)[0] > 0 and gap(hi)[0] <= 0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if gap(mid)[0] > 0 else (lo, mid)
    moved = gap(lo)[1]
    sc = _scores64(moved)
    assert abs(sc[best] - sc[second]) <= 1e-12 * sc[best]
    return moved


def _case(base, name):
    """(JAX window, immature mask, minimum_size, maximum_size) of a case."""
    w, imm = base
    frames = int(np.asarray(w.frame_valid).sum())
    if name == "too_few_live":
        outl = np.asarray(w.lm_outlier).copy()
        outl[2] = np.asarray(w.lm_valid)[2]
        imm = imm.copy()
        imm[2] = False
        return dataclasses.replace(w, lm_outlier=jnp.asarray(outl)), imm, MIN_SIZE, SLOTS
    if name == "eq20_argmax":
        return w, imm, MIN_SIZE, frames - 2
    if name == "one_too_large":
        return w, imm, MIN_SIZE, frames - 1
    return _tie(w), imm, MIN_SIZE, frames - 1


@pytest.mark.parametrize("name", CASES)
def test_policy_model_matches_plain_and_jax(base, name):
    wj, imm, lo, hi = _case(base, name)
    tw = convert.window(window_fields(wj), dtype=torch.float32)
    valid = torch.as_tensor(imm)
    out_m, score_m, _ = model(tw, valid, lo, hi, FRACTION)
    out_p = tmarg.flags_device_plain(tw, valid, lo, hi, FRACTION)
    ref = jmarg.flags_device(wj, jnp.asarray(imm.sum(axis=1)), lo, hi, FRACTION)
    ref = (*ref, jmarg.kept_first_perm(wj.frame_valid, ref[0]))
    flagged = int(out_p[0].sum())
    if name == "too_few_live":
        assert flagged == 0
    elif name == "eq20_argmax":
        assert flagged >= 1 and bool(out_p[0][int(torch.argmax(tmarg.eq20_scores(tw)))])
    else:
        assert flagged == 1
    assert int(out_p[1].sum()) > 0
    err = parity.policy_errors(out_m, out_p, tw, lo, hi)
    if name == "near_tie":
        assert err["score_tie"], err
        assert err["explained"], err
        return
    assert not err["score_tie"], err
    for label, a, b, c in zip(("frame flags", "lm flags", "outliers", "perm"), out_m, out_p, ref):
        assert_equal(a, b, err_msg=f"{label}: model vs plain")
        assert_equal(a, c, err_msg=f"{label}: model vs JAX")


@pytest.mark.parametrize("name", CASES)
def test_policy_model_scores_within_bounds(base, name):
    """The model's positions within ``KERNEL_POSE_ULPS`` of ``window.poses()``
    and its eq (20) scores within ``eq20_score_bounds`` of the plain
    version's (f32 both); on the corridor ``POLICY_TIE`` alone would not hold
    them."""
    wj, imm, lo, hi = _case(base, name)
    tw = convert.window(window_fields(wj), dtype=torch.float32)
    _, score_m, pos = model(tw, torch.as_tensor(imm), lo, hi, FRACTION)
    t = tw.poses().t
    ulp = torch.as_tensor(np.spacing(t.abs().amax(dim=-1, keepdim=True).numpy()))
    assert float(((pos - t).abs() / ulp).max()) <= parity.KERNEL_POSE_ULPS
    plain = tmarg.eq20_scores(tw).double()
    bound = parity.eq20_score_bounds(tw)
    gap = (score_m.double() - plain).abs()
    assert bool((gap <= bound).all()), (gap, bound)
    assert bool((bound[plain > 0] > parity.POLICY_TIE * plain[plain > 0]).all())
