"""Kernel outputs on fixed inputs, held digest by digest to the tree before
each redesign (its parent), and every card path's tracks, to compare two
trees of the port bit for bit on one card.

    python -m dsopp_tpu_torch.testing.bits out.pt [--cases c1,k4,solve,frame,marg,kf]
                                                  [--k4-inputs in.pt] [--kf-inputs in.pt]
                                                  [--paths]
    python -m dsopp_tpu_torch.testing.bits --compare a.pt b.pt

The cases (:data:`CASES`), each a function that makes its inputs and runs
this tree's calls on them → {key: tensor}:

* ``c1``: the single-channel outputs of the kernels that the channel axis
  reaches.  K1's pyramid of frame 6 of the standart corridor; K3 on the 5
  base hypotheses of frame 6 down the levels (each level from the kernel's
  result at the level above); then, on ``chip_smoke.py``'s two BA parity
  windows (``linearize_bits.make_inputs``), K7's evaluation, K8's system
  with and without the marginalization pass, K10's solve with an empty
  ledger and with the window's own, and K11's statuses.  Parent: d43a5d3,
  before the channel axis.
* ``k4``: K4's outputs on the immature banks of the standart and the dense
  window after the bootstrap and 14 known-pose frames, with the next frame
  at its ground-truth pose.  Parent: daee7e5, whose chain composed the
  relative poses and the geometry in torch, then ran the sweep kernel and the
  update in torch.  Its digests also hold that chain on this tree's kernel's
  relative poses (``<window>/kernel_poses/<output>``): an output equal to it
  is a pose tie.  ``--k4-inputs`` shares the case's inputs between two
  trees: a tree with the one-call kernel adds the relative poses it composed,
  a tree before runs its chain from them as well.
* ``solve``: the windowed BA's whole solve (``pba._solve_loop_cuda``) on the
  standart, dense and embedder (C = 3) parity windows, moved off their
  linearization point as ``chip_smoke.py`` moves them, with an empty ledger
  and with their own (``own``) or, where the window never marginalized a
  frame, a tenth of its own Schur-reduced system (``scaled``): the window it
  returns, its energy, count and iteration log.  Parent: 5f501a8, the loop
  launched from Python.
* ``frame``: K5's statistics with the keyframe decision on a grid of the
  decision's inputs, and K14's pairing with and without the refinement's
  glue, on the standart point right after the bootstrap and on the standart,
  dense and embedder points after 14 known-pose frames.  Parent: 13dfe72,
  whose chain ran the flows kernel, then the decision in torch; the glue in
  torch, clones of the window's tensors, then the pairing kernel.  A tree
  without the one-call entries runs that chain (:func:`one_call_tree`).
* ``marg``: the marginalization on the card (``pba._marginalize_device``:
  the marginalization pass's K7 and K8, K15, the permuted window) in every
  flagging case of ``parity.marg_cases`` on the ``solve`` case's windows,
  and K15's Jacobi sweeps.  Parent: ed94bb7, whose K15 took the flagged
  landmarks' system after ``_prior_system`` and four subtractions in torch,
  and solved in one block of 1024 threads.
* ``kf``: the keyframe's candidates (K12, without and with the masked path's
  mask) and the frontend's state (K16) on the window with the next frame
  pushed as its newest keyframe, as it is and with its poses moved off their
  linearization point, on the standart, dense, masked and embedder trackers
  after 14 known-pose frames and on the standart one right after the
  bootstrap.  Parent: c8d285f, whose K16 wrapper composed the relative poses
  and the landmark mask in torch; K12 ranked a tile per thread.  As in
  ``k4``, ``--kf-inputs`` shares the inputs between two trees: a tree whose
  kernel composes the poses adds them (``rel_pose``), a tree before runs its
  K16 on them as well (``<tracker>/<window>/kernel_poses/<output>``: a pose
  tie).

``parent_digests.json`` holds ``case/key`` → sha256 of every case's parent
run, each made on an NVIDIA H100 80GB HBM3; :func:`check` holds a case's
outputs to it, ``chip_smoke.py``'s ``[<case>-bits]`` lines print the result.
``out.pt`` gets every entry, ``out.digests.json`` beside it the digests;
with ``--paths`` ``out.pt`` also holds, for every path of
``testing/paths.py``, each tracked frame's position, keyframe flag,
escalation, rmse, flows and the state's rmse_last0 and kf_rmse after it
(:func:`path_runs`).  ``--compare`` prints the entries whose values differ
(-1: another count) with their pose ties, and exits non-zero when an entry
differs that is no tie.  Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import json
import os
import sys
import tempfile

import torch

BA_FRAMES = 14          # chip_smoke.py's known-pose frames after the bootstrap
PATHS = ("standart", "fast", "dense", "masked", "ledger", "sensor", "embedder")
TIE = "kernel_poses"


@functools.lru_cache(maxsize=None)
def parent_digests() -> dict:
    """``case/key`` → sha256 of every case's parent run."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "parent_digests.json")) as f:
        return json.load(f)


def digests(outputs: dict) -> dict:
    """{name: sha256 of the flattened tensor's bytes}."""
    return {key: hashlib.sha256(v.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
                                .numpy().tobytes()).hexdigest()
            for key, v in sorted(outputs.items())}


def _tie_key(key: str) -> str:
    head, last = key.rsplit("/", 1)
    return f"{head}/{TIE}/{last}"


def check(case: str, outputs: dict) -> tuple:
    """``case``'s outputs ({key: tensor}, keys without the case's name)
    against its parent's digests → (equal, pose ties, differing) keys; a
    key that one side lacks differs."""
    prefix = f"{case}/"
    got = {prefix + key: v for key, v in digests(outputs).items()}
    every = parent_digests()
    parent = {key: v for key, v in every.items()
              if key.startswith(prefix) and f"/{TIE}/" not in key}
    equal, ties, differ = [], [], []
    for key in sorted(set(got) | set(parent)):
        if key in got and got[key] == parent.get(key):
            equal.append(key)
        elif key in got and got[key] == every.get(_tie_key(key)):
            ties.append(key)
        else:
            differ.append(key)
    return equal, ties, differ


def _tracker(seq, path: str, every: int):
    """The bootstrapped tracker of ``path`` after ``BA_FRAMES`` known-pose
    frames, every ``every``-th a forced keyframe (0: the bootstrap alone) →
    (tracker, the next frame's index)."""
    from dsopp_tpu_torch.testing.paths import INIT_FRAMES, bootstrap, path_config, path_mask
    tracker = bootstrap(seq, path_config(path), path_mask(path))
    frame = INIT_FRAMES + (BA_FRAMES if every else 0)
    for i in range(INIT_FRAMES, frame):
        tracker.tick(i, float(seq.timestamps[i]), seq.images[i],
                     known_pose=seq.pose(i, torch.float32),
                     force_keyframe=(i % every == every - 1))
    return tracker, frame


# -- c1 ----------------------------------------------------------------------

def c1_outputs() -> dict:
    """{name: tensor} of the kernels' C = 1 outputs on fixed inputs."""
    from dsopp_tpu_torch.core.camera import Pinhole
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.features.pyramid import build_pyramid_maps_cuda
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.solvers import pose_alignment as pa
    from dsopp_tpu_torch.testing import linearize_bits
    from dsopp_tpu_torch.testing.paths import (INIT_FRAMES, bootstrap, path_config,
                                               render_path)
    from dsopp_tpu_torch.tracker.fused_tick import CHUNK, _initialization_hypotheses

    seq = render_path("standart")
    tracker = bootstrap(seq, path_config("standart"))
    maps = build_pyramid_maps_cuda(seq.images[INIT_FRAMES].contiguous(), 5)
    out = {f"K1/level{lvl}": m for lvl, m in enumerate(maps)}
    kf = tracker._kf_pose()
    hyps = _initialization_hypotheses(tracker.t_w_last, tracker.t_prev_rel, kf, True)
    hyps = SE3(hyps.q[:CHUNK], hyps.t[:CHUNK])
    t = hyps.inverse().compose(SE3(kf.q.expand(CHUNK, 4), kf.t.expand(CHUNK, 3)))
    aff = tracker.last_affine.expand(CHUNK, 2).contiguous()
    ratio = torch.tensor(1.0, device="cuda")
    for lvl in range(4, -1, -1):
        res = pa.align_level_cuda(tracker.level_points[lvl], maps[lvl], tracker.models[lvl],
                                  SE3(t.q.contiguous(), t.t.contiguous()), aff.contiguous(),
                                  tracker.last_affine, ratio, tracker.align_opts)
        for field, v in res._asdict().items():
            for i, x in enumerate((v.q, v.t) if field == "t_t_r" else (v,)):
                out[f"K3/level{lvl}/{field}{i}"] = x
        t, aff = res.t_t_r, res.affine
    # chip_smoke's BA parity windows, moved, with K7's evaluation of them
    for name, case in linearize_bits.make_inputs().items():
        win, model = pba.Window(**case["window"]), Pinhole(**case["model"])
        opts, eps, idepth = pba.PBAOptions(**case["opts"]), case["eps"], case["idepth"]
        lm_mask = pba.active_lm_mask(win)
        for field in ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "res_status", "t_lin_q",
                      "t_lin_t", "affine0", "h_marg"):
            out[f"{name}/window/{field}"] = getattr(win, field)
        for field, v in case["ev"].items():
            out[f"{name}/K7/{field}"] = v
        for run, sys_k in linearize_bits.linearize(case).items():
            for field, v in sys_k.items():
                out[f"{name}/K8/{run}/{field}"] = v
        moved = win.replace(eps=eps, lm_idepth=idepth)
        empty = moved.replace(h_marg=torch.zeros_like(win.h_marg),
                              b_marg=torch.zeros_like(win.b_marg),
                              energy_marg=torch.zeros_like(win.energy_marg))
        for ledger, start in (("empty", empty), ("own", moved)):
            res, energy, count = pba._solve_loop_cuda(start, model, opts)
            for field in ("t_lin_q", "t_lin_t", "affine0", "eps", "lm_idepth", "res_status",
                          "lm_outlier", "lm_inliers", "lm_baseline"):
                out[f"{name}/K10/{ledger}/{field}"] = getattr(res, field)
            out[f"{name}/K10/{ledger}/energy"] = energy.reshape(1)
            out[f"{name}/K10/{ledger}/count"] = count.reshape(1)
        ps = pba._point_status_from_ev_cuda(moved, pba.Evaluation(**case["ev"]), lm_mask, opts)
        for field, v in ps._asdict().items():
            out[f"{name}/K11/{field}"] = v
    return out


# -- k4 ----------------------------------------------------------------------

K4_WINDOWS = {"standart": 2, "dense": 1}   # path -> every how many frames a keyframe
K4_OUTPUTS = ("idepth_min", "idepth_max", "status", "traced", "uniqueness", "search_interval")


def k4_inputs() -> dict:
    """{window: the banks, the next frame's level-0 map and pose, the
    window's poses, affines and exposures, the frame's affine, the camera}."""
    from dsopp_tpu_torch.features.pyramid import build_pyramid_maps
    from dsopp_tpu_torch.testing.paths import render_path
    seq = render_path("standart")
    out = {}
    for name, every in K4_WINDOWS.items():
        tracker, frame = _tracker(seq, name, every)
        win = tracker.window
        poses = win.poses()
        pose = seq.pose(frame, torch.float32, "cuda")
        out[name] = dict(
            points=tracker.immature._asdict(),
            target_map=build_pyramid_maps(seq.images[frame].contiguous(), 1)[0],
            model=tracker.models[0]._asdict(), pose_q=pose.q.contiguous(),
            pose_t=pose.t.contiguous(), window_poses_q=poses.q, window_poses_t=poses.t,
            window_affines=win.affine(), affine_tgt=tracker.last_affine,
            exposure=torch.ones((), device="cuda"), window_exposures=win.exposure)
    return out


def k4_outputs(inputs: dict | None = None) -> dict:
    """{window/output} of this tree's K4, and {window/kernel_poses/output} of
    its chain from a kernel's poses where ``inputs`` holds them and this tree
    has no such kernel.  In a tree with the one-call kernel the relative
    poses it composed go into ``inputs`` (``rel_pose``)."""
    from dsopp_tpu_torch.core.camera import Pinhole
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.tracker import depth_estimation as de

    inputs = k4_inputs() if inputs is None else inputs
    out = {}
    for name, case in inputs.items():
        points = de.ImmaturePoints(**case["points"])
        target_map, model = case["target_map"], Pinhole(**case["model"])
        frame = (case["pose_q"], case["pose_t"], case["window_poses_q"],
                 case["window_poses_t"], case["window_affines"], case["affine_tgt"],
                 case["exposure"], case["window_exposures"])
        if hasattr(de, "estimate_depths_cuda"):
            k, n = points.valid.shape
            dbg = de.debug_buffers(k, n, "cuda")
            res = de.estimate_depths_cuda(points, target_map, model, *frame, 20.0, debug=dbg)
            out.update({f"{name}/{key}": getattr(res, key) for key in K4_OUTPUTS})
            case["rel_pose"] = dbg.rel_pose.clone()
            continue
        # a tree before: the regular tick's composition, then its estimate_depths
        q, t, wq, wt, aff, aff_tgt, exposure, wexp = frame
        ratio = exposure / torch.clamp(wexp, min=1e-12)
        k = wq.shape[0]
        t_inv = SE3(q, t).inverse()
        rel = SE3(t_inv.q.expand(k, 4), t_inv.t.expand(k, 3)).compose(SE3(wq, wt))
        runs = {name: (rel.q, rel.t)}
        if "rel_pose" in case:
            runs[f"{name}/{TIE}"] = (case["rel_pose"][:, :4].contiguous(),
                                     case["rel_pose"][:, 4:].contiguous())
        for key, (rq, rt) in runs.items():
            res = de.estimate_depths(points, target_map, model, rq, rt, aff, aff_tgt, ratio, 20.0)
            out.update({f"{key}/{field}": getattr(res, field) for field in K4_OUTPUTS})
    return out


# -- solve -------------------------------------------------------------------

# window -> (path, every how many frames a keyframe)
SOLVE_WINDOWS = {"standart": ("standart", 2), "dense": ("dense", 1),
                 "embedder": ("embedder", 2)}
LOG_FIELDS = ("energy", "lam", "count", "it", "accept", "done", "relin")


def solve_inputs() -> dict:
    """{window/ledger: (the window to solve, the camera, the options)}."""
    from dsopp_tpu_torch.testing.paths import render_path
    seq = render_path("standart")
    out = {}
    for name, (path, every) in SOLVE_WINDOWS.items():
        tracker, _ = _tracker(seq, path, every)
        model, opts = tracker.models[0], tracker.pba_opts
        for ledger, start in solve_starts(tracker.window, model, opts).items():
            out[f"{name}/{ledger}"] = (start, model, opts)
    return out


def solve_starts(win, model, opts, seed: int = 0) -> dict:
    """{ledger: the window to solve}: ``win`` on the card with its eps and
    idepths moved by a draw of ``seed``, once with an empty ledger ("empty")
    and once with a filled one: its own ("own"), or where it has none, a
    share of its Schur-reduced pose system ("scaled")."""
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing import parity

    k, n = win.num_slots, win.num_landmark_slots
    gen = torch.Generator(device="cuda").manual_seed(seed)
    step = torch.tensor([1e-3] * 6 + [5e-3, 0.3], device="cuda")
    eps = torch.randn((k, 8), generator=gen, device="cuda") * step
    eps = torch.where((win.frame_valid & ~win.frame_fixed)[:, None], eps,
                      torch.zeros_like(eps)).contiguous()
    idepth = (win.lm_idepth
              * (1.0 + 0.01 * torch.randn((k, n), generator=gen, device="cuda"))).contiguous()
    moved = win.replace(eps=eps, lm_idepth=idepth)
    out = {"empty": moved.replace(h_marg=torch.zeros_like(win.h_marg),
                                  b_marg=torch.zeros_like(win.b_marg),
                                  energy_marg=torch.zeros_like(win.energy_marg))}
    if float(win.h_marg.abs().max()) > 0:
        out["own"] = moved
    else:
        ev = pba._evaluate_cuda(moved, model, eps, idepth, pba.active_lm_mask(moved), opts)
        sys_k = pba._linearize_from_ev_cuda(moved, model, ev, eps, opts)
        out["scaled"] = parity.scaled_ledger(moved, sys_k)
    return out


def _fields(window) -> dict:
    return {f.name: getattr(window, f.name) for f in dataclasses.fields(window)
            if getattr(window, f.name) is not None}


def solve_outputs() -> dict:
    """{case/inputs/field, case/field, case/energy, case/count, case/log}: the
    inputs' fields and this tree's solve of each case."""
    from dsopp_tpu_torch.solvers import pba

    out = {}
    for case, (window, model, opts) in solve_inputs().items():
        for field, v in _fields(window).items():
            out[f"{case}/inputs/{field}"] = v
        log = []
        res, energy, count = pba._solve_loop_cuda(window, model, opts, log=log)
        for field, v in _fields(res).items():
            out[f"{case}/{field}"] = v
        out[f"{case}/energy"] = energy.reshape(1)
        out[f"{case}/count"] = count.reshape(1)
        out[f"{case}/log"] = torch.tensor([[float(row[f]) for f in LOG_FIELDS] for row in log],
                                          dtype=torch.float64)
    return out


# -- frame -------------------------------------------------------------------

# tracker -> (path, every how many frames a keyframe; 0: the bootstrap alone)
FRAME_TRACKERS = {"bootstrap": ("standart", 0), "standart": ("standart", 2),
                  "dense": ("dense", 1), "embedder": ("embedder", 2)}
PAIRING = ("standart", "dense", "embedder")
# the decision's inputs: rmse, rmse_last0, kf_rmse, num_valid
RMSE = (1.0, 3.0)
RMSE_LAST0 = (1.0, 0.5)
KF_RMSE = (-1.0, 0.2, 0.25, 0.3)
NUM_VALID = (0, 50)
FACTORS = (1.25, 2.0, 3.0)      # the paths' keyframe factors


def frame_inputs() -> dict:
    """{tracker: dict(flow=(points, camera, T_t_kf, T_kf_t matrix),
    keyframe=(window, banks, camera, spacing) or None)}."""
    from dsopp_tpu_torch.testing import parity
    from dsopp_tpu_torch.testing.paths import render_path
    seq = render_path("standart")
    out = {}
    for name, (path, every) in FRAME_TRACKERS.items():
        tracker, frame = _tracker(seq, path, every)
        t_t_kf = seq.pose(frame, torch.float32, "cuda").inverse() @ tracker._kf_pose()
        t_t_kf = type(t_t_kf)(t_t_kf.q.contiguous(), t_t_kf.t.contiguous())
        case = dict(flow=(tracker.flow_points, tracker.models[0], t_t_kf,
                          t_t_kf.inverse().matrix().contiguous()), keyframe=None)
        if name in PAIRING:
            win, imm, _ = parity.keyframe_case(tracker, seq.images[frame],
                                               seq.pose(frame, torch.float32, "cuda"), frame)
            case["keyframe"] = (win, imm, tracker.models[0], float(tracker.min_distance))
        out[name] = case
    return out


@functools.lru_cache(maxsize=None)
def one_call_tree() -> bool:
    """Whether this tree's K5 and pairing are the one-call entries."""
    from dsopp_tpu_torch.tracker import activation as act
    from dsopp_tpu_torch.tracker import depth_map as dm
    return (hasattr(dm, "frame_statistics_cuda")
            and "selected" in act._activation_scatter_cuda.__code__.co_varnames)


def _decision_chain(pts, model, t_t_kf, mat, rmse, num_valid, rmse_last0, kf_rmse, factor,
                    force):
    """The chain K5's one call replaced: the flows kernel, then the gate and
    the decision in torch as the regular tick ran them → the first 7 entries
    of the packed statistics."""
    from dsopp_tpu_torch.tracker import depth_map as dm
    flow, flow_no_rot = dm.mean_square_flows_cuda(pts, model, t_t_kf)
    reliable = (rmse < 2.5 * rmse_last0) & (num_valid > 0)
    rmse_last0_new = torch.where(reliable, rmse, rmse_last0 * 2.5)
    kf_rmse_eff = torch.where(kf_rmse < 0, rmse, kf_rmse)
    need = ((factor * (dm.MAX_SHIFT_WEIGHT * flow + dm.MAX_SHIFT_NO_ROT_WEIGHT * flow_no_rot)
             > dm.KEYFRAME_THRESHOLD)
            | (rmse / torch.clamp(kf_rmse_eff, min=1e-12) > dm.MAX_EXCESS_ENERGY)) & reliable
    kf_rmse_new = (kf_rmse if force
                   else torch.where(need, torch.full_like(kf_rmse_eff, -1.0), kf_rmse_eff))
    return torch.stack([flow, flow_no_rot, reliable.float(), rmse_last0_new, kf_rmse_new,
                        need.float(), rmse])


def statistics(pts, model, t_t_kf, mat, *decision):
    """K5's flows with the gate and the decision → the first 7 entries of the
    packed statistics: this tree's one call, or the chain it replaced."""
    from dsopp_tpu_torch.tracker import depth_map as dm
    if not one_call_tree():
        return _decision_chain(pts, model, t_t_kf, mat, *decision)
    return dm.frame_statistics_cuda(pts, model, t_t_kf, mat, *decision)[:7]


def pairing_call(win, imm, activate, delete, refined=None):
    """The pairing after the activation, ``refined`` the refinement's
    (idepth, keep, selected) or None: this tree's one call, or the chain it
    replaced (the glue in torch, then the wrapper that clones the window)."""
    from dsopp_tpu_torch.tracker import activation as act
    if refined is None:
        return act._activation_scatter_cuda(win, imm, activate, delete)
    idepth, keep, selected = refined
    if one_call_tree():
        return act._activation_scatter_cuda(win, imm, keep, delete, idepth, selected)
    delete = delete | (selected & ~keep)
    imm = imm._replace(idepth_min=torch.where(keep, idepth, imm.idepth_min),
                       idepth_max=torch.where(keep, idepth, imm.idepth_max))
    return act._activation_scatter_cuda(win, imm, keep, delete)


def pairing_inputs(win, imm, model, spacing, refine):
    """K13's plain activation at ``spacing`` and, with ``refine``, the plain
    refinement → (activate, delete, refined or None)."""
    from dsopp_tpu_torch.tracker import activation as act
    activate, delete, _ = act._activation_plain(win, model, imm, spacing)
    refined = act._refine_idepth_plain(win, model, imm, activate, 20.0) if refine else None
    return activate, delete, refined


def frame_outputs() -> dict:
    """{tracker/inputs/..., tracker/k5, tracker/pairing/<refine>/...}: per
    tracker the flows, the gate, the state's next rmse_last0 and kf_rmse and
    the decision of every case of the grid; the window's five tensors, the
    banks' valid mask and bounds and the count after every pairing; and the
    inputs."""
    out = {}
    f32 = dict(dtype=torch.float32, device="cuda")
    for name, case in frame_inputs().items():
        pts, model, t_t_kf, mat = case["flow"]
        for field, v in zip(("uv", "idepth", "valid"), (pts.uv, pts.idepth, pts.valid)):
            out[f"{name}/inputs/flow_{field}"] = v
        out[f"{name}/inputs/t_t_kf"] = torch.cat([t_t_kf.q, t_t_kf.t])
        flow, flow_no_rot = (float(x) for x in statistics(
            pts, model, t_t_kf, mat, torch.tensor(1.0, **f32),
            torch.tensor(1, dtype=torch.int32, device="cuda"), torch.tensor(1.0, **f32),
            torch.tensor(1.0, **f32), 1.0, False)[:2])
        # the factor that puts the flow term on the threshold, in f64
        on_edge = 1.0 / (4.5 * flow + 9.0 * flow_no_rot)
        rows = []
        for rmse, r0, kf, nv, factor, force in itertools.product(
                RMSE, RMSE_LAST0, KF_RMSE, NUM_VALID, FACTORS + (on_edge,), (False, True)):
            rows.append(statistics(pts, model, t_t_kf, mat, torch.tensor(rmse, **f32),
                                    torch.tensor(nv, dtype=torch.int32, device="cuda"),
                                    torch.tensor(r0, **f32), torch.tensor(kf, **f32), factor,
                                    force))
        out[f"{name}/k5"] = torch.stack(rows)
        if case["keyframe"] is None:
            continue
        win, imm, model, spacing = case["keyframe"]
        for field in ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "res_status"):
            out[f"{name}/inputs/{field}"] = getattr(win, field)
        for field in ("uv", "idepth_min", "idepth_max", "valid"):
            out[f"{name}/inputs/imm_{field}"] = getattr(imm, field)
        for refine in (False, True):
            res_win, res_imm, n_activated = pairing_call(
                win, imm, *pairing_inputs(win, imm, model, spacing, refine))
            key = f"{name}/pairing/{'refined' if refine else 'unrefined'}"
            for field in ("lm_uv", "lm_patch", "lm_idepth", "lm_valid", "res_status"):
                out[f"{key}/{field}"] = getattr(res_win, field)
            for field in ("valid", "idepth_min", "idepth_max"):
                out[f"{key}/imm_{field}"] = getattr(res_imm, field)
            out[f"{key}/n_activated"] = n_activated.reshape(1)
    return out


# -- marg --------------------------------------------------------------------

# fields of the marginalized window that are not digested: the permuted copies
# of the frames' maps (plain indexing, and tens of MB each)
MARG_SKIPPED = ("maps", "channel_maps")


@functools.lru_cache(maxsize=None)
def raw_system_tree() -> bool:
    """Whether this tree's K15 entry takes K8's marginalization-pass system
    raw (the priors and the subtractions inside the kernel)."""
    from dsopp_tpu_torch.solvers import pba
    return "h_schur" in pba._marginalize_cuda.__code__.co_varnames


def marg_fold(window, model, perm, opts, glue: bool = False):
    """K15 alone on the marginalization of ``window``, its marginalization
    pass (K7 and K8) run once → fn(sweeps=None) → the new (H_m, b_m, E_m);
    ``sweeps``, an int32 [1] CUDA tensor, receives the Jacobi sweeps.  In a
    tree before the raw-system entry, fn takes the flagged landmarks' system
    formed once, or, with ``glue``, forms it at every call (the priors and
    the subtractions in torch, as that tree's marginalization did)."""
    from dsopp_tpu_torch.solvers import pba
    lm_mask = window.lm_marg_flag & window.lm_valid & window.frame_valid[:, None]
    ev = pba._evaluate(window, model, window.eps, window.lm_idepth, lm_mask, opts)
    sys_m = pba._linearize_from_ev(window, model, ev, window.eps, opts, marg_pass=True)
    e_land = torch.sum(ev.energy_patch)
    if raw_system_tree():
        args = (window, sys_m.h_pose, sys_m.b_pose, sys_m.h_schur, sys_m.b_schur, e_land)
        return lambda sweeps=None: pba._marginalize_cuda(*args, perm, opts, sweeps)

    def points():
        h_pr, b_pr = pba._prior_system(window, window.eps, opts, marg_pass=True)
        return ((sys_m.h_pose - h_pr - sys_m.h_schur).contiguous(),
                (sys_m.b_pose - b_pr - sys_m.b_schur).contiguous())

    formed = None if glue else points()
    return lambda sweeps=None: pba._marginalize_cuda(window, *(formed or points()), e_land, perm,
                                                      opts, sweeps)


def marg_outputs() -> dict:
    """{window/ledger/case/inputs/..., .../<field>, .../sweeps}: on the
    ``solve`` case's windows (each with an empty and a filled ledger), every
    flagging case of ``parity.marg_cases``: the flags and the permutation,
    the window ``pba._marginalize_device`` returns on the card (the
    marginalization pass's K7 and K8, K15, the permuted window; but
    :data:`MARG_SKIPPED`) and K15's sweeps."""
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing import parity

    out = {}
    for key, (start, model, opts) in solve_inputs().items():
        gen = torch.Generator(device="cuda").manual_seed(1)
        for case, slots in parity.marg_cases(start).items():
            w, perm = parity.marg_case(start, case, slots, gen)
            at = f"{key}/{case}"
            out[f"{at}/inputs/frame_marg"] = w.frame_marg
            out[f"{at}/inputs/lm_marg_flag"] = w.lm_marg_flag
            out[f"{at}/inputs/perm"] = perm
            res = pba._marginalize_device(w, model, perm, opts)
            for field, v in _fields(res).items():
                if field not in MARG_SKIPPED:
                    out[f"{at}/{field}"] = v
            sweeps = torch.zeros(1, dtype=torch.int32, device="cuda")
            marg_fold(w, model, perm, opts)(sweeps)
            out[f"{at}/sweeps"] = sweeps
    return out


# -- kf ----------------------------------------------------------------------

# tracker -> (path, every how many frames a keyframe; 0: the bootstrap alone)
KF_TRACKERS = {"bootstrap": ("standart", 0), "standart": ("standart", 2),
               "dense": ("dense", 1), "masked": ("masked", 2), "embedder": ("embedder", 2)}
# K16's fields of the window (the frames' maps it does not read are not kept)
KF_WINDOW = ("t_lin_q", "t_lin_t", "eps", "frame_valid", "lm_uv", "lm_idepth", "lm_valid",
             "lm_outlier")
# the step of the poses' move (the pose part of the solve case's): rotations
# on both sides of core/lie.py's _SMALL
KF_STEP = (1e-3,) * 6 + (0.0, 0.0)


def kf_inputs() -> dict:
    """{tracker: the window with the next frame pushed as its newest keyframe
    (:data:`KF_WINDOW`, all fields as ``parity.keyframe_case`` gives them),
    its eps moved, the frame's pyramid, the camera and the sizes}."""
    from dsopp_tpu_torch.testing import parity
    from dsopp_tpu_torch.testing.paths import render_path
    seq = render_path("standart")
    out = {}
    for name, (path, every) in KF_TRACKERS.items():
        tracker, frame = _tracker(seq, path, every)
        win, _, maps = parity.keyframe_case(tracker, seq.images[frame],
                                            seq.pose(frame, torch.float32, "cuda"), frame)
        cfg, k = tracker.config, win.num_slots
        gen = torch.Generator(device="cuda").manual_seed(2)
        step = torch.tensor(KF_STEP, device="cuda")
        moved = win.eps + torch.randn((k, 8), generator=gen, device="cuda") * step
        out[name] = dict(
            window={field: getattr(win, field) for field in KF_WINDOW},
            moved_eps=torch.where(win.frame_valid[:, None], moved, win.eps).contiguous(),
            maps=list(maps), model=tracker.models[0]._asdict(), shape=tracker.image_shape,
            levels=cfg.pyramid_levels, frontend_points=cfg.frontend_points,
            num_points=cfg.immature_per_frame)
    return out


@functools.lru_cache(maxsize=None)
def poses_tree() -> bool:
    """Whether this tree's K16 composes the poses in the kernel."""
    from dsopp_tpu_torch.tracker import depth_map as dm
    return "poses_out" in dm.build_frontend_state_cuda.__code__.co_varnames


def _frontend_fields(res) -> dict:
    idep, wei, points, flow = res
    out = {f"idepth{lvl}": x for lvl, x in enumerate(idep)}
    out.update({f"weight{lvl}": x for lvl, x in enumerate(wei)})
    for label, pts in [(f"points{lvl}", p) for lvl, p in enumerate(points)] + [("flow", flow)]:
        out.update({f"{label}_{field}": v for field, v in pts._asdict().items()})
    return out


def _k16_on_poses(args, rel_pose):
    """A tree before: its K16 with the relative poses ``rel_pose`` [K, 7] in
    place of those its wrapper composes."""
    from dsopp_tpu_torch.core.lie import SE3
    from dsopp_tpu_torch.tracker import depth_map as dm
    own = dm._older_landmarks
    dm._older_landmarks = lambda window: (SE3(rel_pose[:, :4].contiguous(),
                                              rel_pose[:, 4:].contiguous()), own(window)[1])
    try:
        return dm.build_frontend_state_cuda(*args)
    finally:
        dm._older_landmarks = own


def kf_outputs(inputs: dict | None = None) -> dict:
    """{tracker/inputs/..., tracker/k12/<mask>/<field>, tracker/<window>/<field>}:
    per tracker K12's candidates and K16's state on the window as it is
    (``k16``) and moved (``k16_moved``), and the inputs; with ``inputs`` from a
    tree before and the kernel's poses in them, also that tree's K16 on them
    (:data:`TIE`).  A tree whose kernel composes the poses puts them into
    ``inputs`` (``rel_pose``)."""
    from dsopp_tpu_torch.core.camera import Pinhole
    from dsopp_tpu_torch.features import extractor
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing.paths import path_mask
    from dsopp_tpu_torch.tracker import depth_map as dm

    inputs = kf_inputs() if inputs is None else inputs
    out = {}
    for name, case in inputs.items():
        fields, maps = case["window"], tuple(case["maps"])
        model = Pinhole(**case["model"])
        for field, v in fields.items():
            out[f"{name}/inputs/{field}"] = v
        out[f"{name}/inputs/moved_eps"] = case["moved_eps"]
        out[f"{name}/inputs/map0"] = maps[0]
        for label, mask in (("unmasked", None), ("masked", path_mask("masked"))):
            cands = extractor.select_candidates_cuda(maps[0], case["num_points"], mask)
            out.update({f"{name}/k12/{label}/{field}": v for field, v in cands._asdict().items()})
        k, n = fields["lm_idepth"].shape
        base = pba.empty_window(k, n, (3, 1, 1)).replace(**fields)
        h, w = case["shape"]
        for variant, eps in (("k16", fields["eps"]), ("k16_moved", case["moved_eps"])):
            args = (base.replace(eps=eps), model, maps, h, w, case["levels"],
                    case["frontend_points"])
            if poses_tree():
                rel_pose = torch.empty((k, dm.POSE_WIDTH), device="cuda")
                res = dm.build_frontend_state_cuda(*args, poses_out=rel_pose)
                case.setdefault("rel_pose", {})[variant] = rel_pose.clone()
            else:
                res = dm.build_frontend_state_cuda(*args)
                if variant in case.get("rel_pose", {}):
                    tied = _k16_on_poses(args, case["rel_pose"][variant])
                    out.update({f"{name}/{variant}/{TIE}/{field}": v
                                for field, v in _frontend_fields(tied).items()})
            out.update({f"{name}/{variant}/{field}": v
                        for field, v in _frontend_fields(res).items()})
    return out


# -- the cases and the paths -------------------------------------------------

CASES = {"c1": c1_outputs, "k4": k4_outputs, "solve": solve_outputs, "frame": frame_outputs,
         "marg": marg_outputs, "kf": kf_outputs}
# the cases whose inputs two trees can share through a file (--<case>-inputs)
SHARED_INPUTS = {"k4": k4_inputs, "kf": kf_inputs}


def run(case: str, **kwargs) -> dict:
    """{key: tensor} of ``case`` in this tree (copies, after a sync)."""
    out = CASES[case](**kwargs)
    torch.cuda.synchronize()
    return {key: v.detach().clone() for key, v in out.items()}


def path_runs(names=PATHS) -> dict:
    """{path/<field>} of every path: the tracked frames' positions, keyframe
    flags, escalations, rmse, flows, and the state's rmse_last0 and kf_rmse
    after each frame."""
    from dsopp_tpu_torch.testing import paths
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker

    out, seqs = {}, {}
    for name in names:
        seq_name = paths.PATHS[name][0]
        if seq_name == "ledger" and seq_name not in seqs:
            # chip_smoke.py renders the ledger path in f64 on the CPU
            s64 = paths.render_path(name, torch.float64, "cpu")
            seqs[seq_name] = dataclasses.replace(s64, images=s64.images.to("cuda", torch.float32))
        elif seq_name not in seqs:
            seqs[seq_name] = paths.render_path(name)
        seq = seqs[seq_name]
        cfg = paths.path_config(name)
        rows = {key: [] for key in ("positions", "keyframes", "escalated", "rmse", "flow",
                                    "flow_no_rot", "rmse_last0", "kf_rmse")}
        with tempfile.TemporaryDirectory() as folder:
            camera = None
            if name == "sensor":
                params, _ = paths.write_sensor_folder(seq, folder)
                camera = paths.sensor_camera(folder, params)
                tracker = paths.sensor_bootstrap(camera, seq, cfg)
            else:
                tracker = paths.bootstrap(seq, cfg, paths.path_mask(name))
            pipe = PipelinedTracker(tracker, flush_every=16)
            for i in range(paths.INIT_FRAMES, paths.path_frames(name)):
                if camera is None:
                    diag = pipe.tick(i, float(seq.timestamps[i]), seq.images[i])
                else:
                    frame = camera.next_frame()
                    diag = pipe.tick(i, frame.timestamp, frame.image,
                                     semantics=frame.semantics, exposure=frame.exposure)
                rows["positions"].append(diag.pose_t)
                rows["keyframes"].append(torch.tensor(bool(diag.is_keyframe)))
                rows["escalated"].append(torch.tensor(bool(diag.escalated)))
                for key in ("rmse", "flow", "flow_no_rot"):
                    rows[key].append(getattr(diag, key).reshape(()))
                rows["rmse_last0"].append(pipe.state.rmse_last0.reshape(()))
                rows["kf_rmse"].append(pipe.state.kf_rmse.reshape(()))
            pipe.finalize()
        for key, values in rows.items():
            out[f"{name}/{key}"] = torch.stack([v.cpu() for v in values])
    return out


def compare(a: dict, b: dict) -> dict:
    """{entry: [values that differ, of which pose ties]} over the entries of
    ``a`` (-1: another count of values or an entry missing from ``b``); a
    pose tie equals ``b``'s entry from the kernel's poses (``TIE``).  Tensors
    compare flat, so a channel axis of size 1 does not count."""
    def differ(x, y):
        x, y = x.reshape(-1), y.reshape(-1)
        same = (x == y) | (torch.isnan(x) & torch.isnan(y)) if x.is_floating_point() else x == y
        return ~same

    report = {}
    for key, x in a.items():
        if f"/{TIE}/" in key:
            continue
        y = b.get(key)
        if y is None or x.numel() != y.numel():
            report[key] = [-1, 0]
            continue
        mask = differ(x, y)
        alt = b.get(_tie_key(key))
        ties = int((mask & ~differ(x, alt)).sum()) if alt is not None and mask.any() else 0
        report[key] = [int(mask.sum()), ties]
    return report


def _option(argv, name):
    return argv[argv.index(name) + 1] if name in argv else None


def main(argv) -> int:
    if argv[1:2] == ["--compare"]:
        report = compare(torch.load(argv[2]), torch.load(argv[3]))
        differ = {key: v for key, v in report.items() if v[0]}
        print(json.dumps(dict(entries=len(report), differ=differ)))
        return 1 if any(n != ties for n, ties in differ.values()) else 0
    if not torch.cuda.is_available():
        print("bits: no CUDA device", file=sys.stderr)
        return 2
    cases = (_option(argv, "--cases") or ",".join(CASES)).split(",")
    out = {}
    for case in cases:
        kwargs = {}
        shared = _option(argv, f"--{case}-inputs")
        if shared is not None:
            if not os.path.exists(shared):
                torch.save(SHARED_INPUTS[case](), shared)
            kwargs["inputs"] = torch.load(shared)
        out.update({f"{case}/{key}": v for key, v in run(case, **kwargs).items()})
        if "inputs" in kwargs:
            torch.save(kwargs["inputs"], shared)
    os.makedirs(os.path.dirname(os.path.abspath(argv[1])), exist_ok=True)
    with open(os.path.splitext(argv[1])[0] + ".digests.json", "w") as f:
        json.dump(digests(out), f, indent=1)
    if "--paths" in argv[2:]:
        out.update({f"paths/{key}": v for key, v in path_runs().items()})
    torch.save({key: v.cpu() for key, v in out.items()}, argv[1])
    print(f"bits: {len(out)} entries of {', '.join(cases)} -> {argv[1]}, digests beside it")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
