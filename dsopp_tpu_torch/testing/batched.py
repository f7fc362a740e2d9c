"""Checks of the batched tick (``tracker/batched_loop.py``) that the card's
tests and ``chip_smoke.py``'s ``[batched]`` phase share.

* :func:`offset_bootstrap`: a tracker bootstrapped on frames ``offset ..
  offset + INIT_FRAMES - 1`` of a sequence (``scripts/bench_batched.py``'s
  offset copies of the corridor: each stream starts at another frame, so
  the keyframes of B streams fall on different ticks);
* :func:`kernel_cases`: K1, K3, K4 and K5 on B trackers' stacked state, each
  as one batched call and as B solo calls on the same inputs, with their
  plain versions (the leading axis) — the batched call must equal the solo
  calls to the bit;
* :func:`stage_diff`: the first stage of the regular tick at which a batched
  tick parts from the solo ticks on the same states;
* :func:`regular_tick_args`: ``fused_regular_tick``'s arguments for B
  states stacked;
* :func:`solver_starts`, :func:`solver_half` and :func:`solver_half_solo`:
  the keyframe backend's solver half (the BA solve, the policy K15p, the
  marginalization pass and the fold K15) over S sequences of a stack of
  moved BA windows in one call a step, and as S solo calls;
  :func:`solver_half_equal` holds one to the other, step by step;
* :func:`front_inputs`, :func:`front_half` and :func:`front_half_solo`: the
  keyframe backend's phases 1 (the push, K12 and the banks, K13, K14) and 3
  (K16) of S sequences of B trackers' stacked state at a forced keyframe in
  one call each, and as S solo calls (a stack of one, as the solo
  ``keyframe_update`` runs them); :func:`front_half_equal` holds one to the
  other.
"""

from __future__ import annotations

import dataclasses

import torch

from dsopp_tpu_torch.core.lie import SE3
from dsopp_tpu_torch.features.pyramid import build_pyramid_maps, build_pyramid_maps_plain
from dsopp_tpu_torch.solvers import pba
from dsopp_tpu_torch.solvers.pba import newest_slot
from dsopp_tpu_torch.solvers.pose_alignment import (LevelPoints, align_level,
                                                    align_level_sequences_plain)
from dsopp_tpu_torch.testing.paths import INIT_FRAMES
from dsopp_tpu_torch.tracker.batched_loop import stack_states
from dsopp_tpu_torch.tracker.depth_estimation import (estimate_depths,
                                                      estimate_depths_sequences_plain)
from dsopp_tpu_torch.tracker.depth_map import frame_statistics, frame_statistics_plain
from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker
from dsopp_tpu_torch.tracker.fused_tick import (CHUNK, _at_slot, _initialization_hypotheses,
                                                _sequence_index)
from dsopp_tpu_torch.tracker.monocular import MonocularTracker

def offset_bootstrap(seq, cfg, offset: int, dtype=torch.float32, device="cuda"):
    """A tracker initialized on frames ``offset .. offset + INIT_FRAMES - 1``
    of ``seq`` at their ground-truth poses."""
    tracker = MonocularTracker(seq.camera, cfg, dtype=dtype, device=device)
    tracker.initialize([(i, float(seq.timestamps[i]), seq.images[i].to(device, dtype),
                         seq.pose(i, dtype, device))
                        for i in range(offset, offset + INIT_FRAMES)])
    return tracker


def flat(out):
    """The tensors of a kernel's output (tuples, named tuples, dicts, SE3), in
    order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, SE3):
        return [out.q, out.t]
    if isinstance(out, dict):
        return [t for x in out.values() for t in flat(x)]
    return [t for x in out for t in flat(x)]


def equal_outputs(batched, solos) -> bool:
    """Whether sequence b's entries of every batched output equal the b-th
    solo call's, to the bit."""
    return all(torch.equal(x[b], y) for b, solo in enumerate(solos)
               for x, y in zip(flat(batched), flat(solo)))


def kernel_cases(trackers, images):
    """{case: (batched call, [solo calls], plain call, sequences)} of K1, K3
    (level 1's chunk 0, 5 hypotheses a sequence; level 0, one a
    sequence; the re-track's 105 at level 1 for every second sequence), K4
    and K5 on the trackers' stacked state and ``images`` [B, H, W].  K3's
    batched outputs are [B·per, ...]; :func:`case_equal` splits them."""
    states = [PipelinedTracker(t).state for t in trackers]
    st = stack_states(states)
    models, cfg = trackers[0].models, trackers[0].loop_config()
    opts, levels = cfg.align_opts, cfg.num_levels
    batch = images.shape[0]
    dev = images.device
    maps = build_pyramid_maps(images, levels)
    poses = st.window.poses()
    slot = newest_slot(st.window)
    kf = SE3(_at_slot(poses.q, slot), _at_slot(poses.t, slot))
    ratio = 1.0 / torch.clamp(_at_slot(st.window.exposure, slot), min=1e-12)
    hyps = _initialization_hypotheses(SE3(st.last_q, st.last_t), SE3(st.prev_q, st.prev_t),
                                      kf, True)
    total = hyps.q.shape[-2]
    pad = torch.cat([torch.arange(total, device=dev),
                     torch.zeros((-total) % CHUNK, dtype=torch.long, device=dev)])
    t_all = SE3(hyps.q[:, pad], hyps.t[:, pad]).inverse().compose(
        SE3(kf.q[:, None].expand(batch, pad.shape[0], 4),
            kf.t[:, None].expand(batch, pad.shape[0], 3)))
    lp = st.level_points
    cases = {}
    rows_all = tuple(range(batch))
    for name, level, rows, first, per in (
            ("align_level chunk 0", min(1, levels - 1), rows_all, 0, CHUNK),
            ("align_level level 0", 0, rows_all, 0, 1),
            ("align_level re-track", min(1, levels - 1), rows_all[1::2] or rows_all, CHUNK,
             21 * CHUNK)):
        idx = list(rows)
        q = t_all.q[idx, first:first + per].reshape(-1, 4).contiguous()
        t = t_all.t[idx, first:first + per].reshape(-1, 3).contiguous()
        aff = st.last_affine[idx][:, None].expand(len(rows), per, 2).reshape(-1, 2).contiguous()
        seq = _sequence_index(rows, per, dev)
        args = (lp[level], maps[level], models[level], SE3(q, t), aff, st.last_affine, ratio,
                opts)
        solo_args = [(LevelPoints(*(x[b] for x in lp[level])), maps[level][b], models[level],
                      SE3(q[j * per:(j + 1) * per], t[j * per:(j + 1) * per]),
                      aff[j * per:(j + 1) * per], st.last_affine[b], ratio[b], opts)
                     for j, b in enumerate(rows)]
        cases[name] = (lambda a=args, s=seq, p=per: align_level(*a, seq=s, per_seq=p),
                       [lambda a=a: align_level(*a) for a in solo_args],
                       lambda a=args, s=seq: align_level_sequences_plain(*a[:7], s, a[7]),
                       (rows, per))
    cases["pyramid_maps"] = (
        lambda: build_pyramid_maps(images, levels),
        [lambda b=b: build_pyramid_maps(images[b], levels) for b in range(batch)],
        lambda: build_pyramid_maps_plain(images, levels), (rows_all, 0))
    pose = SE3(st.last_q, st.last_t)
    exposure = torch.ones((batch,), dtype=images.dtype, device=dev)
    k4 = (st.immature, maps[0], models[0], pose.q, pose.t, poses.q, poses.t, st.window.affine(),
          st.last_affine, exposure, st.window.exposure)

    solo4 = [(s.immature, maps[0][b], models[0], pose.q[b], pose.t[b], poses.q[b], poses.t[b],
              k4[7][b], s.last_affine, exposure[b], s.window.exposure)
             for b, s in enumerate(states)]
    cases["epipolar_update"] = (lambda: estimate_depths(*k4),
                                [lambda a=a: estimate_depths(*a) for a in solo4],
                                lambda: estimate_depths_sequences_plain(*k4), (rows_all, 0))
    t_t_kf = kf.inverse() @ pose
    t_t_kf = SE3(t_t_kf.q.contiguous(), t_t_kf.t.contiguous())
    mat = t_t_kf.inverse().matrix().contiguous()
    rmse = torch.linspace(1.0, 4.0, batch, dtype=images.dtype, device=dev)
    num_valid = torch.full((batch,), 500, dtype=torch.int32, device=dev)
    force = tuple(b == batch - 1 for b in range(batch))
    k5 = (st.flow_points, models[0], t_t_kf, mat, rmse, num_valid, st.rmse_last0, st.kf_rmse,
          cfg.keyframe_factor, force)
    cases["flow_statistic"] = (
        lambda: frame_statistics(*k5),
        [lambda b=b: frame_statistics(states[b].flow_points, models[0],
                                      SE3(t_t_kf.q[b], t_t_kf.t[b]), mat[b], rmse[b],
                                      num_valid[b], states[b].rmse_last0, states[b].kf_rmse,
                                      cfg.keyframe_factor, force[b])
         for b in range(batch)],
        lambda: frame_statistics_plain(*k5), (rows_all, 0))
    return cases


def case_equal(name: str, batched, solos, rows_per) -> bool:
    """Whether a case's batched output equals its solo calls', to the bit."""
    rows, per = rows_per
    if name.startswith("align_level"):
        split = [[x.reshape((len(rows), per) + tuple(x.shape[1:]))[j] for x in flat(batched)]
                 for j in range(len(rows))]
        return all(torch.equal(a, b) for j, solo in enumerate(solos)
                   for a, b in zip(split[j], flat(solo)))
    return equal_outputs(batched, solos)


def regular_tick_args(states, images, models, cfg):
    """``fused_regular_tick``'s arguments for the solo ``states`` stacked, on
    ``images`` [B, H, W] at exposure 1, no keyframe forced."""
    st = stack_states(states)
    poses = st.window.poses()
    exposure = torch.ones(images.shape[:1], dtype=images.dtype, device=images.device)
    return (images, st.level_points, st.flow_points, poses.q, poses.t, st.window.affine(),
            st.window.exposure, exposure, newest_slot(st.window), st.immature,
            st.last_q, st.last_t, st.prev_q, st.prev_t, st.last_affine, models,
            cfg.align_opts, cfg.with_perturbations, cfg.num_levels, cfg.huber_sigma,
            st.rmse_last0, st.kf_rmse, cfg.keyframe_factor, (False,) * images.shape[0])


def stage_diff(states, images, models, cfg) -> str:
    """Run the regular tick's stages on B solo states and on their stack, and
    name the first stage whose outputs part (or "none"): the window's poses
    and the keyframe's, the hypotheses, the pyramid, the tracked poses
    (through the align chain), the epipolar update, the statistics."""
    from dsopp_tpu_torch.tracker.fused_tick import fused_regular_tick

    st = stack_states(states)

    def stages(state, image, force):
        poses = state.window.poses()
        slot = newest_slot(state.window)
        kf = SE3(_at_slot(poses.q, slot), _at_slot(poses.t, slot))
        hyps = _initialization_hypotheses(SE3(state.last_q, state.last_t),
                                          SE3(state.prev_q, state.prev_t), kf,
                                          cfg.with_perturbations)
        exposure = torch.ones(image.shape[:-2], dtype=image.dtype, device=image.device)
        out = fused_regular_tick(
            image, state.level_points, state.flow_points, poses.q, poses.t,
            state.window.affine(), state.window.exposure, exposure, slot, state.immature,
            state.last_q, state.last_t, state.prev_q, state.prev_t, state.last_affine,
            models, cfg.align_opts, cfg.with_perturbations, cfg.num_levels, cfg.huber_sigma,
            state.rmse_last0, state.kf_rmse, cfg.keyframe_factor, force)
        return [("window poses", [poses.q, poses.t, kf.q, kf.t]),
                ("hypotheses", [hyps.q, hyps.t]), ("pyramid", list(out.maps)),
                ("align chain", [out.pose_q, out.pose_t, out.affine, out.rmse]),
                ("epipolar update", list(out.immature)), ("statistics", [out.stats])]

    batched = stages(st, images, (False,) * images.shape[0])
    solos = [stages(s, images[b], False) for b, s in enumerate(states)]
    for i, (name, outs) in enumerate(batched):
        for b, solo in enumerate(solos):
            if not all(torch.equal(x[b], y) for x, y in zip(outs, solo[i][1])):
                return f"{name} (sequence {b})"
    return "none"


# the solver half's steps, in the order they run
SOLVER_STEPS = ("solve", "policy", "pass", "fold")


def solver_starts(window, model, opts):
    """A [4] stack of a BA window on the card moved off its state
    (``bits.solve_starts`` with seeds 0 and 1): for each seed the moved
    window with an empty and with a filled ledger."""
    from dsopp_tpu_torch.testing import bits

    starts = []
    for seed in (0, 1):
        starts.extend(bits.solve_starts(window, model, opts, seed).values())
    return pba.stack_windows(starts)


def immature_valid(windows, points: int, seed: int = 2):
    """A seeded [B, K, ``points``] mask of valid immature points for the
    policy's counts."""
    gen = torch.Generator(device=windows.eps.device).manual_seed(seed)
    shape = tuple(windows.frame_valid.shape) + (points,)
    return torch.rand(shape, generator=gen, device=windows.eps.device) < 0.6


def solver_half(windows, imm_valid, seqs, model, opts, sizes, log=None) -> dict:
    """The solver half of the sequences ``seqs`` of the stack ``windows``,
    one call a step (each kernel one launch for the S sequences): the solve;
    the policy on the stack with the solved fields written (a copy); the
    marginalization pass and the fold on that stack with the policy's flags
    written; the compaction → {step: its [S] outputs, and "stacks": those
    two stacks}.  ``sizes``: the
    policy's (window_min, window_max, max_marg_fraction); ``log`` receives
    each sequence's LM log (it reads the device)."""
    from dsopp_tpu_torch.tracker import marginalization as marg

    solved, energy, count = pba.solve_loop_sequences(windows, model, opts, seqs, log=log)
    w1 = windows.replace(**{f: getattr(windows, f).clone() for f in pba.SOLVED_FIELDS})
    pba.put_sequences(w1, seqs, solved)
    flags = marg.flags_sequences(w1, imm_valid, *sizes, seqs)
    frame_flags, lm_flags, new_outliers, perm = flags
    w2 = w1.replace(**{f: getattr(w1, f).clone()
                       for f in ("lm_outlier", "frame_marg", "lm_marg_flag")})
    pba.put_sequences(w2, seqs, dict(lm_outlier=solved["lm_outlier"] | new_outliers,
                                     frame_marg=frame_flags, lm_marg_flag=lm_flags))
    sys, e_land = pba._marg_pass_sequences(w2, model, opts, tuple(seqs))
    ledger = pba._marginalize_sequences_cuda(w2, tuple(seqs), *sys[:4], e_land, perm, opts)
    return dict(solve=(solved, energy, count), policy=flags, pass_=(sys, e_land),
                fold=(ledger, pba._compact_sequences(w2, tuple(seqs), perm, ledger)),
                stacks=(w1, w2))


def solver_half_solo(windows, imm_valid, b: int, model, opts, sizes, log=None) -> dict:
    """:func:`solver_half`'s steps for sequence ``b`` alone, by the solo calls
    (``_solve_loop_cuda``, ``flags_device_cuda``, ``_marg_pass``,
    ``_marginalize_cuda`` and ``_fold_and_permute``'s compaction, as
    ``_marginalize_device`` runs them)."""
    from dsopp_tpu_torch.tracker import marginalization as marg

    w, energy, count = pba._solve_loop_cuda(pba.window_at(windows, b), model, opts, log=log)
    flags = marg.flags_device_cuda(w, imm_valid[b], *sizes)
    frame_flags, lm_flags, new_outliers, perm = flags
    w2 = w.replace(lm_outlier=w.lm_outlier | new_outliers, frame_marg=frame_flags,
                   lm_marg_flag=lm_flags)
    sys, e_land = pba._marg_pass(w2, model, opts)
    ledger = pba._marginalize_cuda(w2, *sys[:4], e_land, perm, opts)
    compact = pba._fold_and_permute(lambda *_: ledger, w2, *sys[:4], e_land, perm, opts)
    return dict(solve=({f: getattr(w, f) for f in pba.SOLVED_FIELDS}, energy, count),
                policy=flags, pass_=(sys, e_land), fold=(ledger, compact))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, pba.Window):
        return [getattr(x, f.name) for f in dataclasses.fields(pba.Window)
                if getattr(x, f.name) is not None]
    return [t for v in x for t in _leaves(v)]


def solver_half_equal(batched: dict, solos: list) -> dict:
    """{step: whether sequence z of each batched output equals the z-th solo
    call's, to the bit, for every z}."""
    out = {}
    for step, key in zip(SOLVER_STEPS, ("solve", "policy", "pass_", "fold")):
        got = _leaves(batched[key])
        out[step] = all(
            len(got) == len(want) and all(x[z].shape == y.shape and torch.equal(x[z], y)
                                          for x, y in zip(got, want))
            for z, want in enumerate(_leaves(solo[key]) for solo in solos))
    return out


# the front half's outputs :func:`front_half_equal` compares
FRONT_PARTS = ("window", "banks", "counts", "depth maps", "point sets")


def front_inputs(trackers, images):
    """The keyframe backend's inputs of the trackers' stacked state on
    ``images`` [B, H, W] with every sequence forced to keyframe: the state
    after the regular tick (its banks K4's) and the tick's result (the [B]
    pyramid, the poses and affines), the models and the loop's config."""
    from dsopp_tpu_torch.tracker.fused_tick import fused_regular_tick

    states = [PipelinedTracker(t).state for t in trackers]
    models, cfg = trackers[0].models, trackers[0].loop_config()
    args = list(regular_tick_args(states, images, models, cfg))
    args[-1] = (True,) * images.shape[0]
    out = fused_regular_tick(*args)
    st = stack_states(states)._replace(immature=out.immature)
    exposure = torch.ones(images.shape[:1], dtype=images.dtype, device=images.device)
    return dict(state=st, out=out, models=models, cfg=cfg, exposure=exposure,
                mask=trackers[0].mask, frame_ids=tuple(INIT_FRAMES + b
                                                      for b in range(images.shape[0])))


def _copied(tree):
    if isinstance(tree, pba.Window):
        return tree.replace(**{f.name: getattr(tree, f.name).clone()
                               for f in dataclasses.fields(pba.Window)
                               if getattr(tree, f.name) is not None})
    return type(tree)(*(x.clone() for x in tree))


def front_half(inputs, seqs, copy: bool = True, solve: bool = False) -> dict:
    """Phases 1 and 3 of the keyframe backend for the sequences ``seqs`` of
    :func:`front_inputs`' stack, one call each (every kernel one launch for
    the S sequences): ``keyframe_front_sequences`` (on a copy of the stack
    with ``copy``: it writes the S sequences' rows in place unless ``seqs``
    is the whole stack in order), then ``build_frontend_state_sequences`` on
    its window → {"front": KeyframeFront, "depth": (idepth, weight, level
    points, flow points), each [S, ...]}.  ``solve``: phase 2 too
    (``keyframe_solver_sequences``) between them, as a keyframing tick runs
    the three, and K16 on its window."""
    from dsopp_tpu_torch.tracker.depth_map import build_frontend_state_sequences
    from dsopp_tpu_torch.tracker.device_loop import (keyframe_embeddings,
                                                     keyframe_solver_sequences)
    from dsopp_tpu_torch.tracker.fused_keyframe import keyframe_front_sequences

    st, out, cfg = inputs["state"], inputs["out"], inputs["cfg"]
    window, banks = (_copied(st.window), _copied(st.immature)) if copy else (st.window,
                                                                            st.immature)
    rows = pba._device_sequences(tuple(seqs), out.pose_q.device, torch.int64)
    pick = lambda x: x.index_select(0, rows)                              # noqa: E731
    front = keyframe_front_sequences(
        window, inputs["models"][0], banks, out.maps[0], seqs, pick(out.pose_q),
        pick(out.pose_t), pick(out.affine), tuple(inputs["frame_ids"][b] for b in seqs),
        st.min_distance, pick(inputs["exposure"]), cfg.refine, cfg.huber_sigma,
        cfg.immature_per_frame, mask=inputs["mask"],
        embed=keyframe_embeddings(pick(out.maps[0])[:, 0], cfg))
    window = front.window
    if solve:
        window = keyframe_solver_sequences(window, front.immature, st.min_distance, seqs,
                                           front.slot, front.n_active, inputs["models"][0],
                                           cfg).window
    depth = build_frontend_state_sequences(window, inputs["models"][0], out.maps, seqs,
                                           cfg.height, cfg.width, cfg.num_levels,
                                           cfg.frontend_points)
    return dict(front=front, depth=depth)


def front_half_solo(inputs, b: int, copy: bool = True, solve: bool = False) -> dict:
    """:func:`front_half` of sequence ``b`` alone: the same calls on a stack
    of one (a copy of its rows; ``copy=False``: views, which the calls on a
    whole stack do not write), as the solo ``keyframe_update`` runs them."""
    st, out = inputs["state"], inputs["out"]
    one = (lambda x: x[b:b + 1].clone()) if copy else (lambda x: x[b:b + 1])  # noqa: E731
    window = pba.window_at(st.window, b)
    solo_state = st._replace(window=pba._as_stack(_copied(window) if copy else window),
                             immature=type(st.immature)(*(one(x) for x in st.immature)),
                             min_distance=one(st.min_distance))
    solo_out = out._replace(maps=tuple(one(m) for m in out.maps), pose_q=one(out.pose_q),
                            pose_t=one(out.pose_t), affine=one(out.affine))
    return front_half(dict(inputs, state=solo_state, out=solo_out,
                           exposure=one(inputs["exposure"]),
                           frame_ids=(inputs["frame_ids"][b],)), (0,), copy=False,
                      solve=solve)


def _front_parts(half, z: int, b: int) -> dict:
    """{part of :data:`FRONT_PARTS`: sequence ``b``'s tensors (at ``z`` of the
    call's own [S] outputs)}."""
    front, depth = half["front"], half["depth"]
    idep, wei, points, flow = depth
    return {"window": _leaves(pba.window_at(front.window, b)),
            "banks": [x[b] for x in front.immature],
            "counts": [front.slot[z], front.n_active[z], front.n_activated[z]],
            "depth maps": [x[z] for x in idep + wei],
            "point sets": [x[z] for p in points + (flow,) for x in p]}


def front_half_equal(batched: dict, solos: list, seqs) -> dict:
    """{part of :data:`FRONT_PARTS`: whether every sequence's tensors of the
    batched call equal its solo call's, to the bit}."""
    out = {}
    for part in FRONT_PARTS:
        out[part] = all(
            len(got) == len(want) and all(x.shape == y.shape and torch.equal(x, y)
                                          for x, y in zip(got, want))
            for got, want in ((_front_parts(batched, z, b)[part], _front_parts(solo, 0, 0)[part])
                              for z, (b, solo) in enumerate(zip(seqs, solos))))
    return out
