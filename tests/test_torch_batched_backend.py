"""Port parity: the keyframe backend over a sequence axis — its solver half
(``solvers/pba.py``'s ``solve_loop_sequences`` and ``marginalize_sequences``,
``tracker/marginalization.py::flags_sequences`` and
``parallel/sharded.py::solve_and_marginalize_sequences``), and, below, its
front half and depth maps (``pba.push_frame_sequences``,
``features/extractor.py::select_candidates_sequences``,
``tracker/fused_keyframe.py``'s ``immature_bank_sequences``,
``set_bank_sequences`` and ``keyframe_front_sequences``,
``tracker/activation.py``'s ``activation_sequences``,
``refine_idepth_sequences`` and ``activation_scatter_sequences``,
``tracker/depth_map.py::build_frontend_state_sequences``).

The JAX package runs B windows' solve and fold as ``jax.vmap`` of one
program (``tests/parallel/test_sharded_solver.py``'s ``solve_and_marginalize``:
the LM solve, then slot 1 and its live landmarks folded into the ledger).  The
port takes S of B stacked windows, named by a host list, in one call a step
(on the card one launch a kernel for the S sequences); on the CPU each step
runs its plain version once per sequence.  The problems are
``__graft_entry__._tiny_problem``'s (4 frames, 64 landmarks, 48×48, f64), B =
3 with the inverse depths scaled by 1, 1.01 and 1.02, and S = 2 of them in
the order (2, 0).

Tolerances: against JAX's vmap those of ``tests/test_torch_parallel.py``'s
single-process solve and fold (``test_solve_loop_matches``'s 1e-7 relative,
1e-12 of the largest entry absolute, counts and statuses equal); against the
port's own per-window calls equal to the bit.  The whole file takes ~40 s on
one worker, most of it the three JAX vmaps' compiles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu_torch import convert
from dsopp_tpu_torch.features import extractor
from dsopp_tpu_torch.parallel.sharded import (solve_and_marginalize,
                                              solve_and_marginalize_sequences)
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.tracker import activation as tact
from dsopp_tpu_torch.tracker import depth_map as tdm
from dsopp_tpu_torch.tracker import fused_keyframe as fk
from dsopp_tpu_torch.tracker import marginalization as tmarg
from dsopp_tpu_torch.tracker.depth_estimation import ImmaturePoints

from tests._torch_port import (assert_close, assert_equal, np_tree, to_np, to_torch,
                               window_fields)

F64 = torch.float64

SCALES = (1.0, 1.01, 1.02)      # each sequence's inverse depths
SEQS = (2, 0)                   # S = 2 of the B = 3 sequences
SOLVE_RTOL = 1e-7
STATUS_FIELDS = ("res_status", "lm_outlier", "lm_inliers", "lm_opt_count")
CLOSE_FIELDS = ("eps", "affine0", "t_lin_q", "t_lin_t", "lm_idepth", "lm_baseline", "h_marg",
                "b_marg", "energy_marg")


def _jax_solve_and_marginalize(cam):
    """``tests/parallel/test_sharded_solver.py``'s ``solve_and_marginalize``."""
    from dsopp_tpu.solvers.pba import PBAOptions, _marginalize_device, _solve_loop_device
    from dsopp_tpu.tracker.marginalization import kept_first_perm

    opts = PBAOptions()

    def fn(w):
        w, e, n = _solve_loop_device(w, cam, opts)
        frame_flags = jnp.zeros(w.frame_valid.shape, bool).at[1].set(True)
        w = dataclasses.replace(w, frame_marg=frame_flags,
                                lm_marg_flag=w.lm_valid & frame_flags[:, None])
        perm = kept_first_perm(w.frame_valid, frame_flags)
        return _marginalize_device(w, cam, perm, opts, True, True), e, n
    return fn


@pytest.fixture(scope="module")
def problem():
    """The JAX windows, their port counterparts stacked [B], the camera, and
    JAX's vmap of the solve and fold over the S selected windows."""
    import __graft_entry__ as ge
    from dsopp_tpu.parallel.sharded import stack_windows as jax_stack

    window, cam = ge._tiny_problem(dtype=jnp.float64, landmarks=64, size=48)
    jax_windows = [dataclasses.replace(window, lm_idepth=window.lm_idepth * s) for s in SCALES]
    ref = jax.jit(jax.vmap(_jax_solve_and_marginalize(cam)))(
        jax_stack([jax_windows[b] for b in SEQS]))
    windows = pba.stack_windows([convert.window(window_fields(w)) for w in jax_windows])
    tcam = convert.pinhole(*(float(getattr(cam, k)) for k in ("fx", "fy", "cx", "cy")),
                           np.asarray(cam.image_size))
    return dict(windows=windows, cam=tcam, ref=ref, opts=pba.PBAOptions())


@pytest.fixture(scope="module")
def batched(problem):
    return solve_and_marginalize_sequences(problem["windows"], problem["cam"], problem["opts"],
                                           SEQS)


def test_batched_solve_and_fold_matches_jax(problem, batched):
    """S = 2 of B = 3 stacked windows solved and folded in one call each
    against JAX's vmap over the same two windows."""
    w_j, e_j, n_j = problem["ref"]
    w_t, e_t, n_t = batched
    assert_equal(n_t, np.asarray(n_j))
    assert int(n_t.min()) > 0
    assert_close(e_t, np.asarray(e_j), rtol=SOLVE_RTOL)
    for z in range(len(SEQS)):
        want = convert.window({k: v[z] for k, v in window_fields(w_j).items()})
        got = pba.window_at(w_t, z)
        for name in CLOSE_FIELDS:
            assert_close(getattr(got, name), getattr(want, name), rtol=SOLVE_RTOL,
                         atol=1e-12 * max(1.0, float(getattr(want, name).abs().max())),
                         err_msg=f"{z} {name}")
        for name in STATUS_FIELDS + ("lm_valid", "frame_valid", "frame_id"):
            assert_equal(getattr(got, name), getattr(want, name), err_msg=f"{z} {name}")
        assert float(got.h_marg.abs().max()) > 0
    assert not torch.equal(w_t.lm_idepth[0], w_t.lm_idepth[1])


def _assert_windows_equal(got: pba.Window, want: pba.Window, msg):
    for f in dataclasses.fields(pba.Window):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), (msg, f.name)
        if a is not None:
            assert a.shape == b.shape and torch.equal(a, b), (msg, f.name)


def test_batched_call_equals_the_per_window_loop(problem, batched):
    """The same call on the CPU equals the per-window loop of
    ``solve_and_marginalize`` to the bit: every window field, energy, count."""
    windows, cam, opts = problem["windows"], problem["cam"], problem["opts"]
    w_t, e_t, n_t = batched
    for z, b in enumerate(SEQS):
        w, e, n = solve_and_marginalize(pba.window_at(windows, b), cam, opts)
        _assert_windows_equal(pba.window_at(w_t, z), w, b)
        assert torch.equal(e_t[z], e) and int(n_t[z]) == int(n), b


def test_each_step_equals_its_solo_call(problem):
    """The solve (with its LM log), the policy and the fold over S
    sequences, each against its solo plain call, to the bit."""
    windows, cam, opts = problem["windows"], problem["cam"], problem["opts"]
    logs = []
    solved, energy, count = pba.solve_loop_sequences(windows, cam, opts, SEQS, log=logs)
    solo = []
    for z, b in enumerate(SEQS):
        log = []
        w, e, n = pba._solve_loop_plain(pba.window_at(windows, b), cam, opts, log=log)
        solo.append(w)
        for name in pba.SOLVED_FIELDS:
            assert torch.equal(solved[name][z], getattr(w, name)), (b, name)
        assert torch.equal(energy[z], e) and int(count[z]) == int(n)
        assert logs[z] == log
    stack = pba.stack_windows(solo)
    k, m = stack.t_lin_q.shape[1], 24
    valid = torch.Generator().manual_seed(3)
    imm_valid = torch.rand((len(SEQS), k, m), generator=valid, dtype=torch.float64) < 0.5
    flags = tmarg.flags_sequences(stack, imm_valid, 1, 2, 0.5)
    for z in range(len(SEQS)):
        want = tmarg.flags_device_plain(solo[z], imm_valid[z], 1, 2, 0.5)
        for x, y in zip(flags, want):
            assert torch.equal(x[z], y), z
    frame_flags, lm_flags, new_outliers, perm = flags
    assert bool(frame_flags.any())
    flagged = stack.replace(lm_outlier=stack.lm_outlier | new_outliers, frame_marg=frame_flags,
                            lm_marg_flag=lm_flags)
    folded = pba.marginalize_sequences(flagged, cam, perm, opts)
    for z in range(len(SEQS)):
        want = pba._marginalize_device(pba.window_at(flagged, z), cam, perm[z], opts)
        _assert_windows_equal(pba.window_at(folded, z), want, z)


@pytest.mark.parametrize("seqs,what", [((3,), "out of range"), ((-1, 0), "out of range"),
                                       ((1, 1), "twice"), ((), "empty")])
@pytest.mark.parametrize("step", ["solve", "policy", "fold"])
def test_sequence_list_is_checked(problem, seqs, what, step):
    """Each batched step refuses a list with a sequence out of range, a
    duplicate, or no sequence."""
    windows, cam, opts = problem["windows"], problem["cam"], problem["opts"]
    k = windows.t_lin_q.shape[1]
    with pytest.raises(ValueError, match=what):
        if step == "solve":
            pba.solve_loop_sequences(windows, cam, opts, seqs)
        elif step == "policy":
            tmarg.flags_sequences(windows, torch.zeros((3, k, 8), dtype=torch.bool), 1, 2, 0.5,
                                  seqs)
        else:
            perm = torch.arange(k).expand(max(len(seqs), 1), k)
            pba.marginalize_sequences(windows, cam, perm, opts, seqs)


def test_mixed_shapes_are_refused(problem):
    """Windows of different landmark slots do not stack, and a stack whose
    fields disagree on the sequence axis or a sequence's shape is refused."""
    windows, cam, opts = problem["windows"], problem["cam"], problem["opts"]
    one = pba.window_at(windows, 0)
    narrow = one.replace(**{name: getattr(one, name)[..., :32] for name in (
        "lm_idepth", "lm_valid", "lm_marg_flag", "lm_outlier", "lm_inliers", "lm_opt_count",
        "lm_baseline", "res_status")}, lm_uv=one.lm_uv[:, :32], lm_patch=one.lm_patch[:, :32])
    with pytest.raises(ValueError, match="shape"):
        pba.stack_windows([one, narrow])
    with pytest.raises(ValueError, match="mixed shapes"):
        pba.solve_loop_sequences(windows.replace(lm_idepth=windows.lm_idepth[:2]), cam, opts,
                                 (0,))
    with pytest.raises(ValueError, match="mixed shapes"):
        pba.marginalize_sequences(windows.replace(res_status=windows.res_status[..., :32]), cam,
                                  torch.zeros((1, 4), dtype=torch.int64), opts, (0,))


# ---------------------------------------------------------------------------
# The front half (the push, K12 and the bank, K13, K14) and K16 over a
# sequence axis.  Three windows of ``tests/test_torch_keyframe.py``'s kind
# (4 keyframes of a 120×160 render in 6 slots, 96 landmarks, two banks of 64
# ready points; window seeds 1, 2, 3), each taking a keyframe from its own
# frame; S = 2 of them, (2, 0).  Against JAX: one ``jax.vmap`` of the JAX
# package's front (``fused_keyframe_push``'s lines up to the solve, with and
# without the refinement) and one of ``build_frontend_state``, at the
# tolerances of ``tests/test_torch_keyframe.py`` (candidates, masks, slots
# and counts exact, grad2 1e-12 relative, which this file also holds the
# bank's sampled patches and gradients to; refined idepths 1e-9) and of
# ``tests/test_torch_depth_maps.py`` (weights and selections exact, idepth
# 1e-12).  Against the port's solo calls: equal to the bit.

FRONT_FRAMES = [0, 2, 4, 6]
FRONT_SLOTS, FRONT_LM, FRONT_IMM = 6, 96, 64
FRONT_M = FRONT_IMM              # a fresh bank holds as many points as the others
KEYFRAME_IMAGES = (7, 8, 7)     # each sequence's new keyframe
MIN_DISTANCES = (2.0, 1.5, 2.5)
EXPOSURES = (1.0, 0.9, 1.1)
SIGMA = 20.0
H, W, LEVELS, MAX_POINTS = 120, 160, 5, 300
IDEPTH_RTOL = 1e-9              # tests/test_torch_keyframe.py's refined idepths
GRAD2_RTOL = 1e-12              # tests/test_torch_keyframe.py's grad2
DEPTH_RTOL = 1e-12              # tests/test_torch_depth_maps.py's idepth


def _jax_front(cam):
    """``dsopp_tpu/tracker/fused_keyframe.py::fused_keyframe_push`` up to its
    solve (the push, the bank, K13, K14 and the glue), with the pairing also
    without the refinement, returning every step's outputs."""
    from dsopp_tpu.core.interpolate import sample
    from dsopp_tpu.core.pattern import shift_pattern
    from dsopp_tpu.features import extractor as jext
    from dsopp_tpu.solvers.pba import _push_frame_kernel
    from dsopp_tpu.tracker import activation as jact
    from dsopp_tpu.tracker.depth_estimation import make_immature_points

    def fn(window, imm, pm0, pose_q, pose_t, affine, frame_id, md, exposure):
        n, dtype = window.num_landmark_slots, window.lm_uv.dtype
        slot = jnp.sum(window.frame_valid).astype(jnp.int32)
        window = _push_frame_kernel(
            window, slot, pose_q, pose_t, affine, exposure, jnp.asarray(False), frame_id,
            jnp.zeros((n, 2), dtype), jnp.zeros((n, window.lm_patch.shape[-1]), dtype),
            jnp.zeros((n,), dtype), jnp.asarray(0, jnp.int32), pm0, pm0[:1])
        cands = jext.select_candidates(pm0, FRONT_M)
        patches, _ = sample(pm0, shift_pattern(cands.uv))
        grads, _ = sample(pm0, cands.uv)
        bank = make_immature_points(cands.uv, patches[..., 0], grads[..., 1:], dtype=dtype)
        bank = bank._replace(valid=bank.valid & cands.valid)
        imm = jax.tree_util.tree_map(lambda b, new: b.at[slot].set(new), imm, bank)
        act, dele, n_active = jact._activation_kernel(window, cam, imm, md)
        plain = jact._activation_scatter(window, imm, act, dele)
        idep, act2, sel = jact._refine_idepth_kernel(window, cam, imm, act, SIGMA)
        imm2 = imm._replace(idepth_min=jnp.where(act2, idep, imm.idepth_min),
                            idepth_max=jnp.where(act2, idep, imm.idepth_max))
        refined = jact._activation_scatter(window, imm2, act2, dele | (sel & ~act2))
        return dict(pushed=window, cands=cands, banked=imm, act=act, dele=dele,
                    n_active=n_active, idep=idep, act2=act2, sel=sel, plain=plain,
                    refined=refined)
    return fn


def _port_stack(jax_windows):
    return pba.stack_windows([convert.window(window_fields(w)) for w in jax_windows])


@pytest.fixture(scope="module")
def front():
    """The three JAX windows and banks, the keyframes' maps, their port
    counterparts stacked [B], and JAX's vmaps of the front and of K16 over
    the S selected sequences."""
    from dsopp_tpu.features.pyramid import build_pyramid_maps
    from dsopp_tpu.parallel.sharded import stack_windows as jax_stack
    from dsopp_tpu.testing import render_sequence
    from dsopp_tpu.testing.fixtures import build_test_window
    from dsopp_tpu.tracker import depth_map as jdm

    from tests.test_torch_keyframe import _ready_banks

    seq = render_sequence(num_frames=max(KEYFRAME_IMAGES) + 1, height=H, width=W)
    windows, banks, levels = [], [], []
    for b in range(3):
        w = build_test_window(seq, FRONT_FRAMES, num_landmarks=FRONT_LM, slots=FRONT_SLOTS,
                              seed=1 + b)
        w = dataclasses.replace(
            w, lm_valid=w.lm_valid & (jnp.arange(FRONT_LM) % 3 == b % 3)[None])
        windows.append(w)
        banks.append(_ready_banks(seq, w, FRONT_FRAMES, ready=2, n_imm=FRONT_IMM))
        levels.append(build_pyramid_maps(jnp.asarray(seq.images[KEYFRAME_IMAGES[b]]), LEVELS))
    poses = [seq.pose_t_wc(i) for i in KEYFRAME_IMAGES]
    affine = np.asarray([[0.0, 0.0], [0.01, -0.02], [-0.01, 0.03]])
    cam = seq.camera
    pick = list(SEQS)
    args = (jax_stack([windows[b] for b in pick]),
            jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[banks[b] for b in pick]),
            jnp.stack([levels[b][0] for b in pick]),
            jnp.stack([jnp.asarray(poses[b].q) for b in pick]),
            jnp.stack([jnp.asarray(poses[b].t) for b in pick]), jnp.asarray(affine[pick]),
            jnp.asarray([KEYFRAME_IMAGES[b] for b in pick], jnp.int32),
            jnp.asarray([MIN_DISTANCES[b] for b in pick]),
            jnp.asarray([EXPOSURES[b] for b in pick]))
    ref = jax.jit(jax.vmap(_jax_front(cam)))(*args)
    maps_j = tuple(jnp.stack([levels[b][lvl] for b in pick]) for lvl in range(LEVELS))
    depth = jax.jit(jax.vmap(lambda w, m: jdm.build_frontend_state(w, cam, m, H, W, LEVELS,
                                                                   MAX_POINTS)))(
        ref["refined"][0], maps_j)
    model = convert.pinhole(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_size)
    imm = ImmaturePoints(*(torch.stack(xs) for xs in zip(
        *(convert.immature_points(np_tree(bank._asdict())) for bank in banks))))
    maps = tuple(torch.stack([to_torch(levels[b][lvl]) for b in range(3)])
                 for lvl in range(LEVELS))
    kf = dict(pose_q=torch.stack([to_torch(poses[b].q) for b in range(3)]),
              pose_t=torch.stack([to_torch(poses[b].t) for b in range(3)]),
              affine=torch.as_tensor(affine), exposure=torch.tensor(EXPOSURES, dtype=F64),
              min_distance=torch.tensor(MIN_DISTANCES, dtype=F64))
    return dict(windows=_port_stack(windows), imm=imm, maps=maps, kf=kf, model=model, ref=ref,
                depth=depth, refined_j=ref["refined"][0])


def _clone(tree):
    if isinstance(tree, pba.Window):
        return tree.replace(**{f.name: getattr(tree, f.name).clone()
                               for f in dataclasses.fields(pba.Window)
                               if getattr(tree, f.name) is not None})
    return type(tree)(*(x.clone() for x in tree))


def _rows(x, seqs=SEQS):
    return torch.stack([x[b] for b in seqs])


def _front_args(front, seqs=SEQS):
    kf = front["kf"]
    return dict(pose_q=_rows(kf["pose_q"], seqs), pose_t=_rows(kf["pose_t"], seqs),
                affine=_rows(kf["affine"], seqs), exposure=_rows(kf["exposure"], seqs),
                frame_ids=tuple(KEYFRAME_IMAGES[b] for b in seqs))


def _port_front_steps(front):
    """The port's front over S = 2 of the B = 3 stack, step by step with the
    sequence functions (the stack copied first: only some sequences
    keyframe, so the push and the bank write it in place)."""
    windows, imm, model = _clone(front["windows"]), _clone(front["imm"]), front["model"]
    maps0, a = front["maps"][0], _front_args(front)
    slots = torch.stack([windows.frame_valid[b].sum() for b in SEQS])
    pushed = pba.push_frame_sequences(windows, SEQS, slots, a["pose_q"], a["pose_t"],
                                      a["affine"], a["exposure"], False, a["frame_ids"], maps0)
    cands = extractor.select_candidates_sequences(maps0, SEQS, FRONT_M)
    bank = fk.immature_bank_sequences(maps0, SEQS, FRONT_M)
    banked = fk.set_bank_sequences(imm, SEQS, slots, bank)
    md = front["kf"]["min_distance"]
    act, dele, n_active = tact.activation_sequences(pushed, model, banked, md, SEQS)
    plain = tact.activation_scatter_sequences(pushed, banked, act, dele, seqs=SEQS)
    idep, act2, sel = tact.refine_idepth_sequences(pushed, model, banked, act, SIGMA, SEQS)
    refined = tact.activation_scatter_sequences(pushed, banked, act2, dele, idep, sel, SEQS)
    return dict(pushed=pushed, cands=cands, bank=bank, banked=banked, act=act, dele=dele,
                n_active=n_active, idep=idep, act2=act2, sel=sel, plain=plain, refined=refined,
                slots=slots)


@pytest.fixture(scope="module")
def port_front(front):
    return _port_front_steps(front)


def _jax_rows(tree, z):
    return {k: np.asarray(v)[z] for k, v in window_fields(tree).items()}


def test_front_half_matches_jax(front, port_front):
    """The push, K12 and the bank, K13, K14's refinement and the pairing
    (with and without the refinement) over S = 2 of 3 stacked sequences
    against JAX's vmap of its front over the same two."""
    ref, got = front["ref"], port_front
    for z, b in enumerate(SEQS):
        want = convert.window(_jax_rows(ref["pushed"], z))
        for f in dataclasses.fields(pba.Window):
            x = getattr(got["pushed"], f.name)
            if x is not None:
                assert_equal(x[b], getattr(want, f.name), err_msg=f"{b} push {f.name}")
        cands = ref["cands"]
        assert_equal(got["cands"].uv[z], np.asarray(cands.uv)[z])
        assert_equal(got["cands"].valid[z], np.asarray(cands.valid)[z])
        assert_close(got["cands"].grad2[z], np.asarray(cands.grad2)[z], rtol=GRAD2_RTOL)
        banked = ref["banked"]
        for name in ImmaturePoints._fields:
            w = np.asarray(getattr(banked, name))[z]
            x = getattr(got["banked"], name)[b]
            if x.dtype.is_floating_point:
                assert_close(x, w, rtol=GRAD2_RTOL, atol=0.0, err_msg=f"{b} bank {name}")
            else:
                assert_equal(x, w, err_msg=f"{b} bank {name}")
        assert_equal(got["act"][z], np.asarray(ref["act"])[z])
        assert_equal(got["dele"][z], np.asarray(ref["dele"])[z])
        assert int(got["n_active"][z]) == int(np.asarray(ref["n_active"])[z])
        assert_equal(got["act2"][z], np.asarray(ref["act2"])[z])
        assert_equal(got["sel"][z], np.asarray(ref["sel"])[z])
        assert_close(got["idep"][z], np.asarray(ref["idep"])[z], rtol=IDEPTH_RTOL)
        for key in ("plain", "refined"):
            win_j, imm_j, n_j = ref[key]
            part, bank, n_t = got[key]
            want = convert.window(_jax_rows(win_j, z))
            assert int(n_t[z]) == int(np.asarray(n_j)[z]), key
            for name in ("lm_valid", "res_status", "lm_uv", "lm_patch"):
                assert_equal(part[name][z], getattr(want, name), err_msg=f"{b} {key} {name}")
            assert_close(part["lm_idepth"][z], want.lm_idepth, rtol=IDEPTH_RTOL)
            assert_equal(bank["valid"][z], np.asarray(imm_j.valid)[z])
            if key == "refined":
                for name in ("idepth_min", "idepth_max"):
                    assert_close(bank[name][z], np.asarray(getattr(imm_j, name))[z],
                                 rtol=IDEPTH_RTOL)
    assert int(got["act"].sum()) > 0 and int(got["refined"][2].min()) > 0
    assert not torch.equal(got["act"][0], got["act"][1])


def test_depth_maps_match_jax(front):
    """K16 over S = 2 of 3 stacked windows (JAX's fronts' windows, converted)
    against JAX's vmap of ``build_frontend_state``."""
    windows = _clone(front["windows"])
    pba.put_sequences(windows, SEQS, _port_stack(
        [jax.tree_util.tree_map(lambda x: x[z], front["refined_j"]) for z in range(len(SEQS))]))
    idep_t, wei_t, pts_t, flow_t = tdm.build_frontend_state_sequences(
        windows, front["model"], front["maps"], SEQS, H, W, LEVELS, MAX_POINTS)
    idep_j, wei_j, pts_j, flow_j = front["depth"]
    assert int((wei_t[0] > 0).sum()) > 100
    for level in range(LEVELS):
        assert_equal(wei_t[level], np.asarray(wei_j[level]))
        assert_close(idep_t[level], np.asarray(idep_j[level]), rtol=DEPTH_RTOL)
    for got, ref in list(zip(pts_t, pts_j)) + [(flow_t, flow_j)]:
        valid = np.asarray(ref.valid)
        assert_equal(got.valid, valid)
        assert_equal(to_np(got.uv)[valid], np.asarray(ref.uv)[valid])
        assert_close(to_np(got.idepth)[valid], np.asarray(ref.idepth)[valid], rtol=DEPTH_RTOL)
        assert_equal(to_np(got.intensity)[valid], np.asarray(ref.intensity)[valid])


def _equal_trees(got, want, msg):
    a, w = _tensor_leaves(got), _tensor_leaves(want)
    assert len(a) == len(w), msg
    for i, (x, y) in enumerate(zip(a, w)):
        assert x.shape == y.shape and torch.equal(x, y), (msg, i)


def _tensor_leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, pba.Window):
        return [getattr(x, f.name) for f in dataclasses.fields(pba.Window)
                if getattr(x, f.name) is not None]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensor_leaves(v)]
    return [t for v in x for t in _tensor_leaves(v)]


def _solo_bank(imm, b):
    return ImmaturePoints(*(x[b] for x in imm))


@pytest.mark.parametrize("refine", [True, False])
def test_front_half_equals_its_solo_calls(front, refine):
    """``keyframe_front_sequences`` over S = 2 of 3 (written into the stack in
    place) against the solo front of each sequence (S = 1 on a stack of one,
    the solo ``keyframe_update``'s): every window field, bank, slot,
    n_active and n_activated equal to the bit; sequence 1's rows untouched,
    the stacked ``maps`` keeping its storage."""
    windows, imm, model, maps0 = (_clone(front["windows"]), _clone(front["imm"]),
                                  front["model"], front["maps"][0])
    ptr = windows.maps.data_ptr()
    a = _front_args(front)
    md = front["kf"]["min_distance"]
    out = fk.keyframe_front_sequences(windows, model, imm, maps0, SEQS, a["pose_q"],
                                      a["pose_t"], a["affine"], a["frame_ids"], md,
                                      a["exposure"], refine, SIGMA, FRONT_M)
    assert out.window.maps.data_ptr() == ptr
    for z, b in enumerate(SEQS):
        s = _front_args(front, (b,))
        solo = fk.keyframe_front_sequences(
            pba._as_stack(_clone(pba.window_at(front["windows"], b))), model,
            ImmaturePoints(*(x[b:b + 1].clone() for x in front["imm"])), maps0[b:b + 1], (0,),
            s["pose_q"], s["pose_t"], s["affine"], s["frame_ids"], md[b:b + 1], s["exposure"],
            refine, SIGMA, FRONT_M)
        _equal_trees(pba.window_at(out.window, b), pba.window_at(solo.window, 0), b)
        _equal_trees(_solo_bank(out.immature, b), _solo_bank(solo.immature, 0), b)
        for name in ("slot", "n_active", "n_activated"):
            assert torch.equal(getattr(out, name)[z], getattr(solo, name)[0]), (b, name)
    assert int(out.n_activated.min()) > 0
    _equal_trees(pba.window_at(out.window, 1), pba.window_at(front["windows"], 1), "untouched")
    _equal_trees(_solo_bank(out.immature, 1), _solo_bank(front["imm"], 1), "untouched")


def test_front_half_over_every_sequence_writes_nothing(front):
    """With every sequence of the stack keyframing the front returns new
    tensors: the stack it was given stays as it was."""
    windows, imm = front["windows"], front["imm"]
    before = (_clone(windows), _clone(imm))
    seqs = (0, 1, 2)
    a = _front_args(front, seqs)
    out = fk.keyframe_front_sequences(windows, front["model"], imm, front["maps"][0], seqs,
                                      a["pose_q"], a["pose_t"], a["affine"], a["frame_ids"],
                                      front["kf"]["min_distance"], a["exposure"], True, SIGMA,
                                      FRONT_M)
    _equal_trees(windows, before[0], "window")
    _equal_trees(imm, before[1], "banks")
    assert out.window.maps.data_ptr() != windows.maps.data_ptr()


def _solo_steps(front, port_front, b, z):
    """Each step of the front for sequence ``b`` by its solo call, on the
    same inputs as the batched step."""
    model, maps0, a = front["model"], front["maps"][0], _front_args(front, (b,))
    got = port_front
    window = pba.window_at(front["windows"], b)
    pushed = pba.window_at(got["pushed"], b)
    banked = _solo_bank(got["banked"], b)
    md = front["kf"]["min_distance"][b]
    return dict(
        push=(pba.push_frame_slot(window, int(got["slots"][z]), a["pose_q"][0], a["pose_t"][0],
                                  a["affine"][0], a["exposure"][0], False, a["frame_ids"][0],
                                  maps0[b]), pushed),
        candidates=(extractor.select_candidates_plain(maps0[b], FRONT_M),
                    [x[z] for x in got["cands"]]),
        bank=(fk.immature_bank(maps0[b], FRONT_M), [x[z] for x in got["bank"]]),
        activation=(tact._activation_plain(pushed, model, banked, md),
                    [x[z] for x in (got["act"], got["dele"], got["n_active"])]),
        refine=(tact._refine_idepth_plain(pushed, model, banked, got["act"][z], SIGMA),
                [x[z] for x in (got["idep"], got["act2"], got["sel"])]),
        pairing=(tact._activation_scatter_plain(pushed, banked, got["act2"][z], got["dele"][z],
                                                got["idep"][z], got["sel"][z]),
                 None))


@pytest.mark.parametrize("step", ["push", "candidates", "bank", "activation", "refine",
                                  "pairing"])
def test_each_front_step_equals_its_solo_call(front, port_front, step):
    """Each sequence function of the front over S = 2 of 3 against the solo
    call of each sequence on the same inputs, to the bit."""
    for z, b in enumerate(SEQS):
        solo, batched = _solo_steps(front, port_front, b, z)[step]
        if step == "pairing":
            part, bank, n = port_front["refined"]
            win, imm, n_solo = solo
            solo = [getattr(win, name) for name in tact.PAIRED_FIELDS] + [
                getattr(imm, name) for name in tact.PAIRED_BANK_FIELDS] + [n_solo]
            batched = [part[name][z] for name in tact.PAIRED_FIELDS] + [
                bank[name][z] for name in tact.PAIRED_BANK_FIELDS] + [n[z]]
        _equal_trees(batched, solo, (step, b))


def test_depth_maps_equal_their_solo_calls(front, port_front):
    """K16's sequence function over S = 2 of 3 against the solo call of each
    sequence, to the bit."""
    windows = port_front["pushed"]
    out = tdm.build_frontend_state_sequences(windows, front["model"], front["maps"], SEQS, H, W,
                                             LEVELS, MAX_POINTS)
    for z, b in enumerate(SEQS):
        solo = tdm.build_frontend_state(pba.window_at(windows, b), front["model"],
                                        tuple(m[b] for m in front["maps"]), H, W, LEVELS,
                                        MAX_POINTS)
        _equal_trees([x[z] for x in _tensor_leaves(out)], _tensor_leaves(solo), b)


def _front_step(front, step, seqs):
    """Call the sequence function of ``step`` with the list ``seqs``."""
    w, imm, model, maps = front["windows"], front["imm"], front["model"], front["maps"]
    n = max(len(seqs), 1)
    k = w.t_lin_q.shape[1]
    flags = torch.zeros((n, k, FRONT_IMM), dtype=torch.bool)
    md = front["kf"]["min_distance"]
    if step == "push":
        pba.push_frame_sequences(_clone(w), seqs, torch.zeros(n, dtype=torch.int64),
                                 torch.zeros((n, 4), dtype=F64), torch.zeros((n, 3), dtype=F64),
                                 torch.zeros((n, 2), dtype=F64), torch.ones(n, dtype=F64),
                                 False, (7,) * n, maps[0])
    elif step == "candidates":
        extractor.select_candidates_sequences(maps[0], seqs, FRONT_M)
    elif step == "bank":
        fk.immature_bank_sequences(maps[0], seqs, FRONT_M)
    elif step == "activation":
        tact.activation_sequences(w, model, imm, md, seqs)
    elif step == "refine":
        tact.refine_idepth_sequences(w, model, imm, flags, SIGMA, seqs)
    elif step == "pairing":
        tact.activation_scatter_sequences(w, imm, flags, flags, seqs=seqs)
    elif step == "depth maps":
        tdm.build_frontend_state_sequences(w, model, maps, seqs, H, W, LEVELS, MAX_POINTS)
    else:
        a = {key: torch.zeros((n,) + x.shape[1:], dtype=x.dtype)
             for key, x in _front_args(front, (0,)).items() if key != "frame_ids"}
        fk.keyframe_front_sequences(w, model, imm, maps[0], seqs, a["pose_q"], a["pose_t"],
                                    a["affine"], (7,) * n, md, a["exposure"], True, SIGMA,
                                    FRONT_M)


@pytest.mark.parametrize("seqs,what", [((3,), "out of range"), ((-1, 0), "out of range"),
                                       ((1, 1), "twice"), ((), "empty")])
@pytest.mark.parametrize("step", ["push", "candidates", "bank", "activation", "refine",
                                  "pairing", "depth maps", "front"])
def test_front_sequence_list_is_checked(front, seqs, what, step):
    """Each sequence function of the front half and K16 refuses a list with
    a sequence out of range, a duplicate, or no sequence."""
    with pytest.raises(ValueError, match=what):
        _front_step(front, step, seqs)


@pytest.mark.parametrize("step", ["push", "activation", "depth maps", "front"])
def test_front_mixed_shapes_are_refused(front, step):
    """A stack whose fields disagree on the sequence axis is refused."""
    bad = dict(front, windows=front["windows"].replace(lm_idepth=front["windows"].lm_idepth[:2]))
    with pytest.raises(ValueError, match="mixed shapes"):
        _front_step(bad, step, (0,))
