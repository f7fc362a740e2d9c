"""Port parity: the windowed BA's solve step, LM loop and point status (the
functions that hold the kernels K9, K10, K11) and the flow statistic (K5), in
plain PyTorch (f64 on the CPU) against the JAX package on the same inputs, at
a small window (5 slots, 4 frames, 32 landmarks) and at the dense operating
point's 17 slots (13 frames, 24 landmarks), 120×160:

* ``_solve_step`` from the same converted ``LinearSystem``, λ in {1e-5, 1e-2,
  10}, with an empty and a filled ledger, dead slots included: step 1e-7
  relative to its norm;
* ``_solve_loop_device``: eps, poses, idepths, baselines and energy 1e-7
  relative, statuses, flags and counts exact;
* ``_point_status_kernel`` and ``mean_square_flows`` (1e-12);
* the staged algorithms of two kernels, modelled on the host before their
  first build: K10's predicated loop (a fixed number of iterations, every part
  skipped once done, the trial written into the evaluation buffer that does
  not hold the carried evaluation, an accept flipping the carried-buffer word
  and committing the small state by selection) against the host-driven
  ``_solve_loop_plain``, state by state; K11's radix select on float bits
  against sorted order statistics and ``np.nanquantile``;
* the launch counts of the one-call solve's fixed sequence
  (``solve_loop_launches``) at several ``max_iterations``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.core.lie import SE3 as JSE3
from dsopp_tpu.solvers import pba as jpba
from dsopp_tpu.solvers.pose_alignment import LevelPoints as JLevelPoints
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.testing.fixtures import build_test_window
from dsopp_tpu.tracker import depth_map as jdm
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.solvers import pba as tpba
from dsopp_tpu_torch.tracker import depth_map as tdm

from tests._torch_port import assert_close, assert_equal, to_np, to_torch, window_fields

# name -> (slots, frames, landmarks per frame)
SIZES = {"small": (5, [0, 2, 4, 6], 32), "k17": (17, list(range(13)), 24)}


def _filled_ledger(window, rng):
    """The window with a positive semi-definite ledger on its valid frames."""
    kb = window.num_slots * jpba.BLOCK
    live = np.repeat(np.asarray(window.frame_valid), jpba.BLOCK)
    a = rng.normal(size=(kb, kb)) * live[None, :]
    h = 1e2 * (a.T @ a)
    b = 10.0 * rng.normal(size=kb) * live
    zero = jnp.zeros_like
    return dataclasses.replace(
        window, h_marg=jnp.asarray(h), h_marg_lo=zero(window.h_marg),
        b_marg=jnp.asarray(b), b_marg_lo=zero(window.b_marg),
        energy_marg=jnp.asarray(5.0), energy_marg_lo=zero(window.energy_marg))


@pytest.fixture(scope="module", params=list(SIZES))
def problem(request):
    slots, frames, n_lm = SIZES[request.param]
    seq = render_sequence(num_frames=max(frames) + 1, height=120, width=160)
    window = build_test_window(seq, frames, num_landmarks=n_lm, slots=slots,
                               pose_noise=3e-3, idepth_noise=0.05, seed=5)
    assert int(window.frame_valid.sum()) == len(frames) < slots      # dead slots
    rng = np.random.default_rng(17)
    cam = seq.camera
    tcam = convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size)
    windows = {"empty": window, "filled": _filled_ledger(window, rng)}
    # a state off the linearization point, for the solve step
    eps = rng.normal(size=(slots, 8)) * np.array([2e-3] * 6 + [1e-2, 0.5])
    eps *= np.asarray(window.frame_valid & ~window.frame_fixed)[:, None]
    idepth = window.lm_idepth * jnp.asarray(1.0 + 0.02 * rng.normal(size=(slots, n_lm)))
    opts = jpba.PBAOptions()
    moved = dataclasses.replace(window, eps=jnp.asarray(eps))
    fej = jpba._fej_cache(moved, cam)
    ev = jpba._evaluate(moved, cam, moved.eps, idepth, jpba.active_lm_mask(moved), opts)
    sys = jpba._linearize_from_ev(moved, fej, ev, moved.eps, opts)
    return dict(seq=seq, cam=cam, tcam=tcam, windows=windows, eps=jnp.asarray(eps),
                idepth=idepth, sys=sys, slots=slots)


def _port(window):
    return convert.window(window_fields(window))


def _rel(actual, expected):
    a, b = to_np(actual).astype(np.float64), to_np(expected).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("ledger", ["empty", "filled"])
@pytest.mark.parametrize("lam", [1e-5, 1e-2, 10.0])
def test_solve_step_matches(problem, lam, ledger):
    window = dataclasses.replace(problem["windows"][ledger], eps=problem["eps"])
    opts = jpba.PBAOptions()
    ref = convert.solve_step(jpba._solve_step(window, problem["sys"], window.eps,
                                              problem["idepth"], lam, opts))
    tw = _port(window)
    sys = convert.linear_system({k: np.asarray(v) for k, v in problem["sys"]._asdict().items()})
    out = tpba._solve_step(tw, sys, tw.eps, to_torch(problem["idepth"]), lam,
                           tpba.PBAOptions())
    step_ref, step_out = ref[0] - tw.eps, out[0] - tw.eps
    assert float(step_ref.abs().max()) > 0
    assert _rel(step_out, step_ref) <= 1e-7
    assert _rel(out[1] - to_torch(problem["idepth"]),
                ref[1] - to_torch(problem["idepth"])) <= 1e-7
    assert_close(out[2], ref[2], rtol=1e-7)
    assert_close(out[3], ref[3], rtol=1e-7)
    dead = ~to_np(tw.frame_valid)
    assert dead.any() and not to_np(step_out)[dead].any()
    if ledger == "filled":       # the ledger moves the step
        bare = tpba._solve_step(_port(dataclasses.replace(problem["windows"]["empty"],
                                                          eps=problem["eps"])),
                                sys, tw.eps, to_torch(problem["idepth"]), lam,
                                tpba.PBAOptions())
        assert _rel(bare[0] - tw.eps, step_ref) > 1e-4


@pytest.fixture(scope="module", params=["empty", "filled"])
def solved(request, problem):
    window = problem["windows"][request.param]
    out_j, e_j, n_j = jpba._solve_loop_device(window, problem["cam"], jpba.PBAOptions())
    log = []
    out_t, e_t, n_t = tpba._solve_loop_plain(_port(window), problem["tcam"],
                                             tpba.PBAOptions(), log=log)
    return dict(window=window, jax=(out_j, e_j, n_j), port=(out_t, e_t, n_t), log=log,
                ledger=request.param)


def test_solve_loop_matches(solved):
    """P7's gate: the whole solve, point statuses included."""
    (out_j, e_j, n_j), (out_t, e_t, n_t) = solved["jax"], solved["port"]
    assert int(n_t) == int(n_j) > 0
    assert_close(e_t, e_j, rtol=1e-7)
    if solved["ledger"] == "filled":     # frozen linearization: eps carries the solve
        assert float(out_t.eps.abs().max()) > 0
    poses_j = out_j.poses()
    assert_close(out_t.poses().q, poses_j.q, rtol=1e-7, atol=1e-10)
    assert_close(out_t.poses().t, poses_j.t, rtol=1e-7, atol=1e-10)
    for name in ("eps", "affine0", "lm_idepth", "lm_baseline"):
        assert_close(getattr(out_t, name), getattr(out_j, name), rtol=1e-7, atol=1e-12,
                     err_msg=name)
    for name in ("res_status", "lm_outlier", "lm_inliers", "lm_opt_count"):
        assert_equal(getattr(out_t, name), getattr(out_j, name), err_msg=name)
    assert solved["log"][-1]["it"] >= tpba.PBAOptions().min_iterations or \
        solved["log"][-1]["done"]


def _predicated_loop(window, model, opts):
    """K10's staged algorithm on the host: ``opts.max_iterations`` iterations
    whatever happens, every part skipped once done (the FEJ cache also unless
    the last step relinearized).  Two evaluation buffers and the carried-buffer
    word (``LM_CARRIED``): the trial goes into the buffer the word does not
    name, K8's input is read through the word, and an accept flips it; the
    small state (eps, idepth, lin_idepth, statuses) is committed by selection.
    At every iteration the carried buffer must equal the evaluation that a
    select-commit of the whole trial (the design before the word) carries."""
    lm_mask = tpba.active_lm_mask(window)
    ledger_empty = bool(torch.max(torch.abs(window.h_marg)) == 0.0)
    tq, tt, ab0 = window.t_lin_q.clone(), window.t_lin_t.clone(), window.affine0.clone()
    eps, idepth, lin_idepth = window.eps.clone(), window.lm_idepth.clone(), window.lm_idepth.clone()
    status = window.res_status.clone()

    def win():
        return window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0, lm_idepth=lin_idepth,
                              res_status=status)

    ev = tpba._evaluate_plain(win(), model, eps, idepth, lm_mask, opts)
    buffers, carried = [ev, None], 0        # the initial evaluation is buffer 0's
    fej = tpba._fej_cache_plain(win(), model)
    e, n = tpba._energy_from_ev(win(), ev, eps, opts)
    st = dict(energy=e, lam=opts.initial_regularizer, count=n, it=0, accept=False,
              done=bool(n == 0), relin=False)
    log = [dict(st, energy=float(e), count=int(n))]
    for _ in range(opts.max_iterations):
        if st["done"]:
            st["accept"] = st["relin"] = False
            continue
        if st["relin"]:
            fej = tpba._fej_cache_plain(win(), model)
        sys = tpba._linearize_from_ev_plain(win(), fej, buffers[carried], eps, opts)
        eps_new, idepth_new, pose_sq, d_sq = tpba._solve_step_plain(
            win(), sys, eps, idepth, st["lam"], opts)
        ev_new = tpba._evaluate_plain(win(), model, eps_new, idepth_new, lm_mask, opts)
        buffers[1 - carried] = ev_new
        e_new, n_new = tpba._energy_from_ev(win(), ev_new, eps_new, opts)
        ftol = bool(torch.abs(st["energy"] - e_new) / torch.clamp(st["energy"], min=1e-30)
                    < opts.function_tolerance)
        ok = bool((n_new > 0) & torch.isfinite(e_new))
        forced = opts.force_accept and st["it"] < opts.min_iterations
        accept = (bool(e_new < st["energy"]) or forced) and ok
        ptol = bool((pose_sq + d_sq) < opts.parameter_tolerance * (
            torch.sum(eps_new * eps_new) + opts.parameter_tolerance))
        done = ftol or (accept and ptol)
        if opts.force_accept:
            done = done or not accept
        relin = accept and ledger_empty and not done
        acc = torch.tensor(accept)
        # decide: the state and, on a relinearizing step, the fold of the trial eps
        st = dict(energy=torch.where(acc, e_new, st["energy"]),
                  count=torch.where(acc, n_new, st["count"]),
                  lam=st["lam"] / opts.reg_decrease if accept else st["lam"] * opts.reg_increase,
                  it=st["it"] + 1, accept=accept, done=done, relin=relin)
        if relin:
            t_new = SE3(tq, tt) @ SE3.exp(eps_new[:, :6])
            tq, tt, ab0 = t_new.q, t_new.t, ab0 + eps_new[:, 6:]
        if accept:
            carried = 1 - carried
        # commit: select the trial's small state over the carried one; the
        # statuses are the candidates of the buffer the word now names
        eps = torch.where(acc, torch.zeros_like(eps) if relin else eps_new, eps)
        idepth = torch.where(acc, idepth_new, idepth)
        lin_idepth = torch.where(torch.tensor(relin), idepth_new, lin_idepth)
        status = torch.where(acc, buffers[carried].status_candidate, status)
        ev = tpba.Evaluation(*(torch.where(acc, new, old) for new, old in zip(ev_new, ev)))
        for name, a, b in zip(tpba.Evaluation._fields, buffers[carried], ev):
            assert torch.equal(a, b), name
        log.append(dict(st, energy=float(st["energy"]), count=int(st["count"])))
    out = window.replace(t_lin_q=tq, t_lin_t=tt, affine0=ab0, eps=eps, lm_idepth=idepth,
                         res_status=status)
    out = tpba._relinearize_last(out)
    out = tpba._with_point_status(out, tpba._point_status_plain(out, model, opts))
    return out, st["energy"], st["count"], log


def test_predicated_loop_matches_the_host_driven_loop(problem, solved):
    opts = tpba.PBAOptions()
    out_p, e_p, n_p, log_p = _predicated_loop(_port(solved["window"]), problem["tcam"], opts)
    out_t, e_t, n_t = solved["port"]
    assert log_p == solved["log"]
    assert float(e_p) == float(e_t) and int(n_p) == int(n_t)
    for field in dataclasses.fields(out_t):
        assert_equal(getattr(out_p, field.name), getattr(out_t, field.name),
                     err_msg=field.name)
    its = [row["it"] for row in log_p]
    assert its == list(range(len(its))) and len(its) <= opts.max_iterations + 1
    if solved["ledger"] == "empty":
        assert any(row["relin"] for row in log_p)
    else:
        assert not any(row["relin"] for row in log_p)


@pytest.mark.parametrize("max_iterations", [0, 1, 3, 7, 12])
def test_solve_loop_launch_counts(max_iterations):
    """The one-call solve's fixed sequence: K7 on the initial state, once an
    iteration and at the solved state; K8 and K9 once an iteration; K10's
    init, steps and finish; K11 once.  The tracker's marginalization pass
    adds one K7 and one K8 a keyframe outside the call: at the standart path
    (12 keyframes, 7 iterations) 120, 96, 84, 108 and 12."""
    m = max_iterations
    got = tpba.solve_loop_launches(m)
    assert got == {"ba_evaluate": m + 2, "ba_linearize_schur": m, "ba_solve_step": m,
                   "ba_lm": m + 2, "ba_point_status": 1}
    if m == tpba.PBAOptions().max_iterations:
        marg = {"ba_evaluate": 1, "ba_linearize_schur": 1}
        path = {name: 12 * (n + marg.get(name, 0)) for name, n in got.items()}
        assert path == {"ba_evaluate": 120, "ba_linearize_schur": 96, "ba_solve_step": 84,
                        "ba_lm": 108, "ba_point_status": 12}


def test_forced_reject_ends_the_loop(problem):
    """A trial that cannot be accepted (no residual left) ends the loop under
    ``force_accept``; both loops log the same single iteration."""
    window = problem["windows"]["empty"]
    tw = _port(window)
    tw = tw.replace(lm_valid=torch.zeros_like(tw.lm_valid))
    log = []
    out, e, n = tpba._solve_loop_plain(tw, problem["tcam"], tpba.PBAOptions(), log=log)
    _, e_p, n_p, log_p = _predicated_loop(tw, problem["tcam"], tpba.PBAOptions())
    assert int(n) == int(n_p) == 0 and log == log_p
    assert len(log) == 1 and log[0]["done"]
    assert_equal(out.lm_idepth, tw.lm_idepth)


def test_point_status_matches(problem, solved):
    out_j = solved["jax"][0]
    # statuses off their solved values: a tighter Huber scale moves the threshold
    opts_j, opts_t = jpba.PBAOptions(huber_sigma=4.0), tpba.PBAOptions(huber_sigma=4.0)
    ref = convert.point_status(jpba._point_status_kernel(out_j, problem["cam"], opts_j))
    out = tpba._point_status_kernel(_port(out_j), problem["tcam"], opts_t)
    assert int((out.res_status == tpba.RES_OUTLIER).sum()) > 0
    assert float(out.threshold) > 0.5 * 4.0 ** 2
    for name in ("res_status", "lm_inliers", "lm_outlier", "lm_opt_count"):
        assert_equal(getattr(out, name), getattr(ref, name), err_msg=name)
    assert_close(out.lm_baseline, ref.lm_baseline, rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("seed", [0, 1])
def test_mean_square_flows_matches(seed):
    rng = np.random.default_rng(seed)
    n = 700
    seq = render_sequence(num_frames=2, height=120, width=160)
    cam = seq.camera
    tcam = convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size)
    uv = rng.uniform([-2.0, -2.0], [162.0, 122.0], size=(n, 2))
    idepth = rng.uniform(-0.1, 1.5, size=n) * (rng.random(n) < 0.9)
    valid = rng.random(n) < 0.85
    xi = rng.normal(size=6) * np.array([0.05] * 3 + [0.02] * 3)
    pose = JSE3.exp(jnp.asarray(xi))
    pts = (uv, idepth, rng.random(n), valid)
    ref = jdm.mean_square_flows(JLevelPoints(*map(jnp.asarray, pts)), cam, pose)
    out = tdm.mean_square_flows(convert.level_points(*pts), tcam, convert.se3(pose.q, pose.t))
    assert float(ref[0]) > 0 and float(ref[1]) > 0 and float(ref[0]) != float(ref[1])
    assert_close(out[0], ref[0], rtol=1e-12)
    assert_close(out[1], ref[1], rtol=1e-12)


# ---------------------------------------------------------------------------
# K11's radix select, modelled in numpy as csrc/ba_status.cu runs it


def _radix_select(values, ok, rank):
    """The rank-th smallest (0-based) of ``values[ok]`` (f32, >= 0) by four
    8-bit passes over the float bits, most significant first."""
    bits = values.astype(np.float32).view(np.uint32)
    prefix, mask = np.uint32(0), np.uint32(0)
    for shift in (24, 16, 8, 0):
        live = ok & ((bits & mask) == prefix)
        hist = np.bincount((bits[live] >> np.uint32(shift)) & np.uint32(255), minlength=256)
        bin_, below = 0, 0
        while bin_ < 255 and below + hist[bin_] <= rank:
            below += hist[bin_]
            bin_ += 1
        prefix |= np.uint32(bin_ << shift)
        mask |= np.uint32(255 << shift)
        rank -= below
    return np.array(prefix, np.uint32).view(np.float32)


def _threshold_model(values, ok, sigma, quantile=0.75):
    m = int(ok.sum())
    if m == 0:
        return np.float32(0.5 * sigma * sigma)
    pos = np.float32(quantile) * np.float32(m - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w = np.float32(pos - np.floor(pos))
    v_lo = _radix_select(values, ok, lo)
    v_hi = v_lo if hi == lo else _radix_select(values, ok, hi)
    diff = v_hi - v_lo
    q = v_lo + w * diff if w < 0.5 else v_hi - diff * (np.float32(1.0) - w)
    return np.float32(q + np.float32(0.5 * sigma * sigma))


def _energies(case):
    rng = np.random.default_rng(3)
    if case == "random":
        v = rng.gamma(2.0, 150.0, size=5000)
        return v, rng.random(5000) < 0.7
    if case == "ties":
        v = rng.integers(0, 12, size=4001) * 25.0
        return v, rng.random(4001) < 0.8
    if case == "wide":      # every exponent byte, zeros, a subnormal
        v = np.concatenate([10.0 ** rng.uniform(-30, 30, size=3000), np.zeros(40), [1e-42]])
        return v, np.ones(v.size, bool)
    if case == "one":
        return np.array([3.0, 7.5, 1.0]), np.array([False, True, False])
    if case == "two":
        return np.array([9.0, 2.0]), np.array([True, True])
    return rng.gamma(2.0, 150.0, size=64), np.zeros(64, bool)      # "none"


@pytest.mark.parametrize("case", ["random", "ties", "wide", "one", "two", "none"])
def test_radix_select_matches_nanquantile(case):
    values, ok = _energies(case)
    values = values.astype(np.float32)
    ordered = np.sort(values[ok])
    ranks = {0, ordered.size // 3, (3 * (ordered.size - 1)) // 4, ordered.size - 1}
    for rank in sorted(r for r in ranks if 0 <= r < ordered.size):
        assert _radix_select(values, ok, rank) == ordered[rank], rank
    sigma = 20.0
    got = _threshold_model(values, ok, sigma)
    flat = torch.where(torch.tensor(ok), torch.tensor(values), torch.tensor(float("nan")))
    q = torch.nanquantile(flat, tpba.OUTLIER_QUANTILE)
    want = torch.where(torch.isnan(q), torch.zeros_like(q), q) + 0.5 * sigma ** 2
    assert got == np.float32(want)          # the plain version's own arithmetic, bit for bit
    if ok.any():
        exact = np.nanquantile(np.where(ok, values, np.nan).astype(np.float64), 0.75)
        np.testing.assert_allclose(got, exact + 0.5 * sigma ** 2, rtol=1e-6)
