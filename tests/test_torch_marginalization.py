"""Port parity: the marginalization policy (K15p) and the ledger fold (K15)
in plain PyTorch (f64 on the CPU) against the JAX package, and a numpy model
of the fold kernel's algorithm.

* ``flags_device`` and ``kept_first_perm``: equal to the JAX functions bit
  for bit on the 40 randomized windows of
  ``tests/tracker/test_marg_flags_device.py`` (K = 8, N = 32, 2..8 frames;
  the port takes the immature banks' valid mask, JAX its row sums);
* ``_marginalize_device`` (``_marginalize_plain`` for the fold): after a
  landmark fold that fills the ledger, H_m, b_m and E_m within 1e-9 of their
  largest entry of ``jpba._marginalize_device(..., True, True)`` with no
  frame, one frame, two frames, the fixed frame and a frame with no live
  landmark (its block: the two affine priors, rank 2) flagged, at 10 and at
  17 slots; frame validity, frame ids and landmark validity equal; the
  same cases in f32 within 5e-5, with the cutoff of f32's working precision;
* the numpy model of ``csrc/marg_fold.cu`` — compaction of the flagged rows,
  parallel-order Jacobi, the cutoff of the identity-padded matrix, the
  Newton step, the permutation — against ``torch.linalg.pinv`` on the padded
  matrix (the kept eigen-directions of X within 1e-9 of its largest entry,
  the dropped ones the same) and against ``_marginalize_plain`` (1e-9 of the
  largest entry) on the same cases, converging in fewer than
  ``MARG_MAX_SWEEPS`` sweeps;
* the card's error measures (``testing/parity.py``) excuse no more than a
  tie explains: a fold that dropped an eigenvalue passes only when that
  eigenvalue lies in the tie band of the cutoff, and a perturbed ledger never;
  frame flags moved between the two best eq (20) scores pass only on a score
  tie, with the landmark triage and the permutation that follow from them.
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
from dsopp_tpu_torch import convert, kernels
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.solvers.linear import pinv_rtol
from dsopp_tpu_torch.testing import parity
from dsopp_tpu_torch.tracker import marginalization as tmarg

from tests._torch_port import assert_equal, to_np, to_torch, window_fields
from tests.tracker.test_marg_flags_device import K, _random_window

LEDGER_RTOL = 1e-9
F32_LEDGER_RTOL = 5e-5   # f32: JAX's eigen-decomposition in f32 against the port's in f64
N_LM = 24
DEAD = 4          # the slot whose frame keeps no live landmark and sees none
# flagged slots of each case (slot 0 is the fixed frame)
CASES = {"none": (), "one": (2,), "two": (1, 3), "fixed": (0,), "dead": (DEAD,)}


def test_flags_device_matches_jax():
    """The randomized windows of the JAX test, bit for bit, with the
    kept-first permutation of the frame flags."""
    rng = np.random.default_rng(7)
    for trial in range(40):
        f = int(rng.integers(2, K + 1))
        w = _random_window(rng, f)
        imm = rng.integers(0, 50, K).astype(np.int32)
        imm[f:] = 0
        ref = jmarg.flags_device(w, jnp.asarray(imm), 3, 5, 0.95)
        perm_ref = jmarg.kept_first_perm(w.frame_valid, ref[0])
        # the banks' valid mask with imm[i] valid points in bank i, scattered
        valid = np.random.default_rng(trial).permuted(np.arange(64)[None, :] < imm[:, None],
                                                      axis=1)
        out = tmarg.flags_device(convert.window(window_fields(w)), torch.as_tensor(valid),
                                 3, 5, 0.95)
        for name, a, b in zip(("frame flags", "lm flags", "outliers", "perm"), out,
                              (*ref, perm_ref)):
            assert_equal(a, b, err_msg=f"{name}, trial {trial}")


def test_kept_first_perm_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        f = int(rng.integers(1, K + 1))
        fv = np.zeros(K, bool)
        fv[:f] = True
        flags = (rng.random(K) < 0.4) & fv
        ref = jmarg.kept_first_perm(jnp.asarray(fv), jnp.asarray(flags))
        assert_equal(tmarg.kept_first_perm(torch.as_tensor(fv), torch.as_tensor(flags)), ref)


@pytest.fixture(scope="module")
def seq():
    return render_sequence(num_frames=13, height=120, width=160)


def _identity_perm(k):
    return np.arange(k, dtype=np.int32)


def _kept_first(frame_valid, flags):
    kept = [i for i in range(len(flags)) if frame_valid[i] and not flags[i]]
    return np.asarray(kept + [i for i in range(len(flags)) if i not in kept], np.int32)


@pytest.fixture(scope="module", params=[10, 17], ids=["10_slots", "17_slots"])
def filled(request, seq):
    """A JAX window whose ledger holds a landmark fold, with a dead frame in
    slot ``DEAD`` (no landmark of its own; every residual into it OOB)."""
    return filled_window(seq, request.param)


def filled_window(seq, slots):
    """:func:`filled`'s window of ``slots`` frame slots."""
    frames = list(range(8 if slots == 10 else 13))
    w = build_test_window(seq, frames, num_landmarks=N_LM, slots=slots, pose_noise=2e-3,
                          idepth_noise=0.03, seed=3)
    rng = np.random.default_rng(slots)
    w = dataclasses.replace(
        w, eps=jnp.asarray(rng.normal(size=(slots, 8)) * np.array([1e-3] * 6 + [5e-3, 0.3])
                           * np.asarray(w.frame_valid & ~w.frame_fixed)[:, None]),
        lm_valid=w.lm_valid.at[DEAD].set(False),
        res_status=w.res_status.at[:, DEAD].set(jpba.RES_OOB))
    cam = seq.camera
    lm = jnp.asarray(rng.random((slots, N_LM)) < 0.25) & w.lm_valid
    w = dataclasses.replace(w, lm_marg_flag=lm, frame_marg=jnp.zeros(slots, bool))
    w = jpba._marginalize_device(w, cam, jnp.asarray(_identity_perm(slots)), jpba.PBAOptions(),
                                 True, True)
    assert float(jnp.max(jnp.abs(w.h_marg))) > 0
    return w


def _case(filled, name):
    """(JAX window with the case's flags, the port's copy of it, perm)."""
    w = filled
    k = w.num_slots
    lm = jnp.asarray(np.random.default_rng(len(name)).random((k, N_LM)) < 0.2) & w.lm_valid
    frames = np.zeros(k, bool)
    frames[list(CASES[name])] = True
    w = dataclasses.replace(w, lm_marg_flag=lm, frame_marg=jnp.asarray(frames))
    perm = _kept_first(np.asarray(w.frame_valid), frames)
    return w, convert.window(window_fields(w)), perm


def _cam(seq):
    c = seq.camera
    return convert.pinhole(c.fx, c.fy, c.cx, c.cy, c.image_size)


def _assert_ledger(got, want, label):
    for name, a, b in zip(("H", "b", "E"), got, want):
        a, b = to_np(a), to_np(b)
        scale = float(np.max(np.abs(b)))
        assert scale > 0, (label, name)
        err = float(np.max(np.abs(a - b))) / scale
        assert err <= LEDGER_RTOL, f"{label} {name}: {err:.3g} of the largest entry"


@pytest.mark.parametrize("name", list(CASES))
def test_marginalize_matches_jax(seq, filled, name):
    wj, wt, perm = _case(filled, name)
    out_j = jpba._marginalize_device(wj, seq.camera, jnp.asarray(perm), jpba.PBAOptions(),
                                     True, True)
    out_t = tpba._marginalize_device(wt, _cam(seq), torch.as_tensor(perm, dtype=torch.int64),
                                     tpba.PBAOptions())
    want = [np.asarray(out_j.h_marg) + np.asarray(out_j.h_marg_lo),
            np.asarray(out_j.b_marg) + np.asarray(out_j.b_marg_lo),
            np.asarray(out_j.energy_marg) + np.asarray(out_j.energy_marg_lo)]
    _assert_ledger((out_t.h_marg, out_t.b_marg, out_t.energy_marg), want, name)
    assert_equal(out_t.frame_valid, out_j.frame_valid)
    assert_equal(out_t.frame_id, out_j.frame_id)
    assert_equal(out_t.lm_valid, out_j.lm_valid)
    assert int(out_t.frame_valid.sum()) == int(wt.frame_valid.sum()) - len(CASES[name])


def _f32(window):
    return dataclasses.replace(window, **{
        f.name: getattr(window, f.name).astype(jnp.float32)
        for f in dataclasses.fields(window) if getattr(window, f.name).dtype == jnp.float64})


@pytest.mark.parametrize("name", list(CASES))
def test_marginalize_matches_jax_in_f32(seq, filled, name):
    """The same cases in f32: the reference inverts the flagged block in the
    working precision, so its cutoff drops every eigenvalue below f32's
    10·n·eps; the port's fold drops the same ones (a cutoff of f64's keeps
    3 to 8 of them here and lands 0.26 % to 1.9 % off) and meets JAX's pair-
    precision ledger within F32_LEDGER_RTOL of its largest entry."""
    wj, _, perm = _case(filled, name)
    wj = _f32(wj)
    wt = convert.window(window_fields(wj), dtype=torch.float32)
    out_j = jpba._marginalize_device(wj, seq.camera, jnp.asarray(perm), jpba.PBAOptions(),
                                     True, True)
    out_t = tpba._marginalize_device(wt, _cam(seq), torch.as_tensor(perm, dtype=torch.int64),
                                     tpba.PBAOptions())
    for name_, a, hi, lo in (("H", out_t.h_marg, out_j.h_marg, out_j.h_marg_lo),
                             ("b", out_t.b_marg, out_j.b_marg, out_j.b_marg_lo)):
        want = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        err = float(np.max(np.abs(to_np(a) - want))) / float(np.max(np.abs(want)))
        assert err <= F32_LEDGER_RTOL, f"{name} {name_}: {err:.3g} of the largest entry"
    assert_equal(out_t.frame_valid, out_j.frame_valid)
    assert_equal(out_t.lm_valid, out_j.lm_valid)


# ---------------------------------------------------------------------------
# numpy model of csrc/marg_fold.cu
# ---------------------------------------------------------------------------

ROT_TOL = 4.0 * np.finfo(np.float64).eps     # marg_fold.cu kRotTol
MAX_SWEEPS = tpba.MARG_MAX_SWEEPS


def round_pairs(n, r):
    """Round ``r`` of the circle schedule over ``n`` (even) indices."""
    out = [(n - 1, r)]
    for t in range(1, n // 2):
        out.append(((r + t) % (n - 1), (r - t + n - 1) % (n - 1)))
    return out


def jacobi(a):
    """Parallel-order cyclic Jacobi of a symmetric matrix → (eigenvalues,
    eigenvectors as columns, the sweeps that rotated: ``MAX_SWEEPS`` when it
    did not converge), the kernel's rotations and threshold."""
    a = a.copy()
    n = a.shape[0]
    v = np.eye(n)
    for sweep in range(MAX_SWEEPS):
        rotated = False
        for r in range(n - 1):
            rots = []
            for p, q in round_pairs(n, r):
                app, aqq, apq = a[p, p], a[q, q], a[p, q]
                if apq == 0.0 or abs(apq) <= ROT_TOL * np.sqrt(abs(app) * abs(aqq)):
                    continue
                theta = (aqq - app) / (2.0 * apq)
                t = (1.0 if theta >= 0 else -1.0) / (abs(theta) + np.hypot(1.0, theta))
                c = 1.0 / np.sqrt(1.0 + t * t)
                rots.append((p, q, c, t * c, t))
            if not rots:
                continue
            rotated = True
            j = np.eye(n)
            for p, q, c, s, _ in rots:
                j[p, p], j[p, q], j[q, p], j[q, q] = c, s, -s, c
            diag = [(p, q, a[p, p] - t * a[p, q], a[q, q] + t * a[p, q]) for p, q, _, _, t in rots]
            a = j.T @ a @ j
            for p, q, app, aqq in diag:
                a[p, p], a[q, q], a[p, q], a[q, p] = app, aqq, 0.0, 0.0
            v = v @ j
        if not rotated:
            return np.diag(a).copy(), v, sweep
    return np.diag(a).copy(), v, MAX_SWEEPS


def prior_vectors(eps, affine0, valid, fixed, marg, opts):
    """The flagged frames' priors (diag d, b) as ``_prior_system``."""
    sel = valid & marg
    d = np.zeros_like(eps)
    b = np.zeros_like(eps)
    d[sel & fixed] = opts.fixed_reg
    b[sel & fixed] = opts.fixed_reg * eps[sel & fixed]
    free = sel & ~fixed
    reg = np.array([opts.affine_reg_a, opts.affine_reg_b])
    d[free, 6:] += reg
    b[free, 6:] += reg * (affine0[free] + eps[free, 6:])
    return d.reshape(-1), b.reshape(-1)


def pinv_model(a, padded_size):
    """X0 of the compact block with the padded matrix's cutoff, then X."""
    lam, v, sweeps = jacobi(a)
    assert sweeps < MAX_SWEEPS
    cutoff = pinv_rtol(padded_size, torch.float64) * max(1.0, float(np.max(np.abs(lam))))
    inv = np.where(np.abs(lam) > cutoff, 1.0 / np.where(lam == 0, 1.0, lam), 0.0)
    x0 = (v * inv) @ v.T
    return x0, x0 + x0 @ (np.eye(len(a)) - a @ x0), lam, cutoff


def fold_model(w, h_pts, b_pts, e_land, perm, opts):
    """The new ledger (H, b, E) as csrc/marg_fold.cu computes it."""
    g = {name: to_np(getattr(w, name)) for name in (
        "eps", "affine0", "frame_valid", "frame_fixed", "frame_marg", "h_marg", "b_marg",
        "energy_marg")}
    k = len(g["frame_valid"])
    rows = 8 * k
    s = g["eps"].reshape(-1)
    h = 0.5 * (h_pts + h_pts.T)
    hs = h @ s
    d, b_pr = prior_vectors(g["eps"], g["affine0"], g["frame_valid"], g["frame_fixed"],
                            g["frame_marg"], opts)
    hm = g["h_marg"] + h + np.diag(d)
    bm = (g["b_marg"] + (b_pts - hs)) + (b_pr - d * s)
    e = g["energy_marg"] + ((e_land + s @ hs) - s @ b_pts)
    marg_rows = [i * 8 + c for i in range(k) if g["frame_valid"][i] and g["frame_marg"][i]
                 for c in range(8)]
    keep = np.repeat(g["frame_valid"] & ~g["frame_marg"], 8)
    hkk = np.where(keep[:, None] & keep[None, :], hm, 0.0)
    bk = np.where(keep, bm, 0.0)
    if marg_rows:
        _, x, _, _ = pinv_model(hm[np.ix_(marg_rows, marg_rows)], rows)
        hke = hm[:, marg_rows] * keep[:, None]
        corr = hke @ x
        hkk = hkk - corr @ hke.T
        bk = bk - corr @ bm[marg_rows]
    hkk = 0.5 * (hkk + hkk.T)
    idx = (np.asarray(perm)[:, None] * 8 + np.arange(8)[None, :]).reshape(-1)
    return hkk[np.ix_(idx, idx)], bk[idx], e


@pytest.mark.parametrize("name", list(CASES))
def test_fold_model_matches_plain(seq, filled, name):
    _, wt, perm = _case(filled, name)
    opts, cam = tpba.PBAOptions(), _cam(seq)
    h_pts, b_pts, e_land = tpba._marg_system_kernel(wt, cam, opts)
    perm_t = torch.as_tensor(perm, dtype=torch.int64)
    plain = tpba._marginalize_plain(wt, h_pts, b_pts, e_land, perm_t, opts)
    model = fold_model(wt, to_np(h_pts), to_np(b_pts), float(e_land), perm, opts)
    _assert_ledger(model, plain, f"model {name}")

    # the pseudo-inverse alone: the compact block's model against the padded
    # matrix's torch.linalg.pinv, on the rows the elimination reads
    fv, fm = to_np(wt.frame_valid), to_np(wt.frame_marg)
    marg_rows = [i * 8 + c for i in range(len(fv)) if fv[i] and fm[i] for c in range(8)]
    if not marg_rows:
        return
    s = to_np(wt.eps).reshape(-1)
    h = to_np(h_pts)
    d, _ = prior_vectors(to_np(wt.eps), to_np(wt.affine0), fv, to_np(wt.frame_fixed), fm, opts)
    hm = to_np(wt.h_marg) + 0.5 * (h + h.T) + np.diag(d)
    rows = hm.shape[0]
    mask = np.zeros(rows, bool)
    mask[marg_rows] = True
    padded = np.where(mask[:, None] & mask[None, :], hm, np.eye(rows))
    ref0 = to_np(torch.linalg.pinv(to_torch(padded), rtol=pinv_rtol(rows, torch.float64), hermitian=True))
    ref0 = ref0[np.ix_(marg_rows, marg_rows)]
    a = hm[np.ix_(marg_rows, marg_rows)]
    x0, x, lam, cutoff = pinv_model(a, rows)
    kept = np.abs(lam) > cutoff
    ref_lam = np.linalg.eigvalsh(a)
    assert int(kept.sum()) == int((np.abs(ref_lam) > cutoff).sum())
    if name == "dead":
        assert int(kept.sum()) == 2            # the two affine priors
    ref = ref0 + ref0 @ (np.eye(len(a)) - a @ ref0)
    err = float(np.max(np.abs(x - ref))) / float(np.max(np.abs(ref)))
    assert err <= LEDGER_RTOL, f"{name}: X differs by {err:.3g} of its largest entry"


@pytest.mark.parametrize("wrapper", ["marg_policy", "marg_fold"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """The CUDA wrappers of K15p and K15 launch nothing on CPU tensors."""
    w = tpba.empty_window(3, 4, (3, 8, 8), device="cpu")
    before = kernels.counts()
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "marg_policy":
            tmarg.flags_device_cuda(w, torch.zeros((3, 8), dtype=torch.bool), 1, 2, 0.95)
        else:
            tpba._marginalize_cuda(w, torch.zeros(24, 24), torch.zeros(24), torch.zeros(24, 24),
                                   torch.zeros(24), torch.zeros(()), torch.arange(3),
                                   tpba.PBAOptions())
    assert kernels.counts() == before


@pytest.mark.parametrize("name", ["one", "two"])
def test_ledger_check_excuses_only_cutoff_ties(seq, filled, name):
    """A fold that dropped the least eigenvalue above the cutoff differs from
    the plain fold; ``ledger_check`` passes it only with a tie band that
    reaches that eigenvalue, and a perturbed ledger with no band."""
    _, wt, perm = _case(filled, name)
    opts = tpba.PBAOptions()
    h_pts, b_pts, e_land = tpba._marg_system_kernel(wt, _cam(seq), opts)
    fold = (wt, h_pts, b_pts, e_land, torch.as_tensor(perm, dtype=torch.int64), opts)
    plain = tpba._marginalize_plain(*fold)
    check = parity.ledger_check(plain, fold)
    assert check["within"] and check["ties"] == 0, check

    hm, rows = parity.folded_ledger(wt, h_pts, opts)
    lam = torch.linalg.eigvalsh(hm[rows][:, rows]).abs()
    least = float(lam[lam > check["cutoff"]].min())
    dropped = tpba._marginalize_plain(*fold, pinv=parity.pinv_cut(least * (1 + 1e-9)))
    assert max(parity.ledger_errors(dropped, plain).values()) > parity.LEDGER_TOL
    assert not parity.ledger_check(dropped, fold)["within"]
    reach = (least / check["cutoff"] - 1) * (1 + 1e-6)
    wide = parity.ledger_check(dropped, fold, band=reach)
    assert wide["within"] and wide["ties"] >= 1, wide

    h = plain[0].clone()
    h[0, 0] = h[0, 0] * (1 + 1e-6) + 1e-6 * h.abs().max()
    assert not parity.ledger_check((h, *plain[1:]), fold, band=reach)["within"]


def test_policy_errors_excuse_only_score_ties(filled):
    """Rule 2's flag moved from the best to the second-best eq (20) score:
    explained under a band that makes the two a tie, not without one, and
    never with a landmark flag or a third frame flag that the kernel's frame
    flags do not explain."""
    w = convert.window(window_fields(filled))
    frames = int(w.frame_valid.sum())
    imm = torch.zeros((w.num_slots, 8), dtype=torch.bool)
    lo, hi = 2, frames - 1
    out_p = tmarg.flags_device_plain(w, imm, lo, hi, 0.95)
    top = torch.topk(tmarg.eq20_scores(w), 2).indices
    assert bool(out_p[0][top[0]]) and int(out_p[0].sum()) == 1
    flags = torch.zeros_like(out_p[0])
    flags[top[1]] = True
    moved = (flags, *tmarg.landmark_triage(w, flags, lo, hi),
             tmarg.kept_first_perm(w.frame_valid, flags))
    assert parity.policy_errors(out_p, out_p, w, lo, hi)["explained"]
    assert not parity.policy_errors(moved, out_p, w, lo, hi)["explained"]
    err = parity.policy_errors(moved, out_p, w, lo, hi, band=1.0)
    assert err["score_tie"] and err["explained"], err

    lm = moved[1].clone()
    lm.view(-1)[int(torch.nonzero(~lm.view(-1))[0])] = True
    assert not parity.policy_errors((moved[0], lm, *moved[2:]), out_p, w, lo, hi,
                                    band=1.0)["explained"]
    third = flags.clone()
    third[[i for i in range(frames - 2) if i not in top.tolist()][0]] = True
    assert not parity.policy_errors((third, *moved[1:]), out_p, w, lo, hi,
                                    band=1.0)["explained"]
