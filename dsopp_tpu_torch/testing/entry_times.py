"""The calls of K5 (the flow statistic with the keyframe decision) and of
K14's pairing (with the refinement's glue) on the inputs of
``testing/bits.py``'s ``frame`` case, of K11 (the point status) and K15
(the ledger fold) on the windows of its ``solve`` case, of K12 (the
candidates) and K16 (the frontend's state) on the inputs of its ``kf`` case,
K18 (the camera's frame intake) with the sensor path around it, and the BA
solve's one C call over a sequence axis (K7–K11 at S = 1 and 4), timed on
the card, in this tree or in a tree before their redesigns (copy this file,
``bits.py`` and ``parity.py`` into that tree's ``dsopp_tpu_torch/testing``
and run it there), so that the two can be compared inside one card call.

    python -m dsopp_tpu_torch.testing.entry_times [out.json] [--cases frame,status,marg,kf,sensor,seq]

Per tracker of ``bits.FRAME_TRACKERS`` (the pairing on the three with a
pushed keyframe, with and without the refinement), each the mean of
``REPS`` calls between CUDA events after warm calls
(``parity.cuda_ms``), and the profiler's device time and device kernels of
one call (``profiling.profiled``):

* ``k5_call``: the kernel's wrapper as the regular tick calls it (this tree:
  ``frame_statistics_cuda``; before: ``mean_square_flows_cuda``);
* ``k5_chain``: the flows with the gate and the decision
  (``bits.statistics``; this tree: the call and a view of its
  output; before: the wrapper, its two views, and the decision's torch
  operators);
* ``pairing``: the pairing after the activation and the refinement (this
  tree: one call; before: the glue's five operators and the wrapper, its
  five clones, memset, kernel and indexing);
* ``status`` (per window of the ``solve`` case, its own or scaled ledger):
  K11's wrapper on K7's evaluation of the window, and the library's
  yardstick, ``torch.nanquantile`` of the ok energies (NaN elsewhere);
* ``marg`` (per window and flagging case of ``parity.marg_cases`` that
  flags one to five frames): K15 from the marginalization pass's system
  (``bits.marg_fold`` with the glue: a tree before the raw-system entry
  forms the flagged landmarks' system in torch at every call), the whole
  marginalization (``pba._marginalize_device``: the pass's K7 and K8, K15,
  the permuted window), and the library's yardsticks at the same shapes:
  ``torch.linalg.eigh`` of the compact flagged block and
  ``solvers.linear.pinv_hermitian`` of the identity-padded one;
* ``kf`` (per tracker of ``bits.KF_TRACKERS``): K12's wrapper on the new
  keyframe's map without and with the masked path's mask, and K16's wrapper
  on the window as it is (this tree: checks, the scratch buffer and one C
  call; before: the poses and the mask composed in torch around the call);
* ``sensor`` (the standart corridor written as a camera stores it,
  ``paths.write_sensor_folder``): K18 on a VGA u8 frame on the card with the
  path's vignette (``correct_image_cuda``), the same frame undistorted
  through SimpleRadial VGA tables by ``Undistorter.undistort`` and then
  corrected (the chain the intake replaced), and, where the tree has it, the
  intake (``intake_cuda`` from a pinned buffer) without and with those
  tables; then the sensor path (bootstrap, ``PipelinedTracker`` over frames
  6..119) once under sync debug "warn", counting the host syncs a frame,
  those inside ``next_frame``, and their lines, and ``SENSOR_RUNS`` times
  timed: frames/s, the pinned ring's waits, and ``next_frame``'s host ms a
  frame split into its parts (:func:`next_frame_parts`), over all frames and
  over those at which the stream was still busy;
* ``seq`` (per window of ``bits.SOLVE_WINDOWS``, where the tree has the
  sequence axis): a [4] stack of the window moved four ways
  (``bits.solve_starts`` with seeds 0 and 1, each with an empty and a filled
  ledger), the one C call of the solve (``pba.solve_loop_sequences``) for
  its first sequence (S = 1) and for all four (S = 4), beside one solo call
  (``pba._solve_loop_cuda``) and four: each call's device µs by kernel, from
  a session that kept every launch's device record.

Prints one JSON object with the card's name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time
import warnings
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

from dsopp_tpu_torch.testing import bits
from dsopp_tpu_torch.testing.parity import cuda_ms
from dsopp_tpu_torch.testing.paths import card_line
from dsopp_tpu_torch.testing.profiling import launch_records, profiled

REPS = 200


def device_work(fn, reps: int = 20) -> dict:
    """The profiler's device µs of one call of ``fn``, in all and by the
    name of each device kernel (or copy, memset) it runs."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with profiled(acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
    return dict(device_us=sum(by_name.values()), device_events_per_call=len(events) / reps,
                device_names=sorted(by_name), device_us_by_name=by_name,
                complete=launch_records(prof)["complete"])


STATUS_WINDOWS = ("standart", "dense")
MARG_CASES = ("one free frame", "two frames", "five frames")


def status_rows() -> dict:
    """{window: K11's call and the library's quantile}."""
    from dsopp_tpu_torch.solvers import pba
    out = {}
    for key, (win, model, opts) in bits.solve_inputs().items():
        name, ledger = key.split("/")
        if name not in STATUS_WINDOWS or ledger == "empty":
            continue
        lm_mask = pba.active_lm_mask(win)
        ev = pba._evaluate_cuda(win, model, win.eps, win.lm_idepth, lm_mask, opts)
        flat = torch.where(ev.ok, ev.energy_patch,
                           torch.full_like(ev.energy_patch, float("nan"))).reshape(-1)

        def call():
            return pba._point_status_from_ev_cuda(win, ev, lm_mask, opts)

        out[name] = dict(groups=flat.numel(), ok=int(ev.ok.sum()),
                         call_ms=cuda_ms(call, REPS), call=device_work(call),
                         nanquantile_ms=cuda_ms(lambda: torch.nanquantile(flat, 0.75), REPS),
                         nanquantile=device_work(lambda: torch.nanquantile(flat, 0.75)))
    return out


def marg_rows() -> dict:
    """{window/case: K15's call from the pass's system, the whole
    marginalization, and the library's eigen-solvers}."""
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.solvers.linear import pinv_hermitian
    from dsopp_tpu_torch.testing import parity
    out = {}
    for key, (start, model, opts) in bits.solve_inputs().items():
        name, ledger = key.split("/")
        if name not in STATUS_WINDOWS or ledger == "empty":
            continue
        gen = torch.Generator(device="cuda").manual_seed(1)
        for case, slots in parity.marg_cases(start).items():
            w, perm = parity.marg_case(start, case, slots, gen)
            if case not in MARG_CASES:
                continue
            fold = bits.marg_fold(w, model, perm, opts, glue=True)
            h_pts = pba._marg_system_kernel(w, model, opts)[0]
            hm, rows = parity.folded_ledger(w, h_pts, opts)
            block = hm[rows][:, rows].contiguous()
            kb = hm.shape[0]
            padded = torch.where(rows[:, None] & rows[None, :], hm,
                                 torch.eye(kb, dtype=hm.dtype, device=hm.device))

            def whole():
                return pba._marginalize_device(w, model, perm, opts)

            out[f"{name}/{case}"] = dict(
                k=w.num_slots, flagged_rows=int(rows.sum()),
                fold_ms=cuda_ms(fold, REPS), fold=device_work(fold),
                marginalize_ms=cuda_ms(whole, REPS), marginalize=device_work(whole),
                eigh_ms=cuda_ms(lambda: torch.linalg.eigh(block), REPS),
                pinv_ms=cuda_ms(lambda: pinv_hermitian(padded, w.eps.dtype), REPS))
    return out


def frame_rows() -> dict:
    """{tracker: K5's call and chain, and the pairing's calls}."""
    from dsopp_tpu_torch.tracker import depth_map as dm
    one_call = bits.one_call_tree()
    f32 = dict(dtype=torch.float32, device="cuda")
    decision = (torch.tensor(1.0, **f32), torch.tensor(50, dtype=torch.int32, device="cuda"),
                torch.tensor(1.0, **f32), torch.tensor(0.5, **f32), 1.25, False)

    def k5_call(pts, model, t, mat):
        if one_call:
            return dm.frame_statistics_cuda(pts, model, t, mat, *decision)
        return dm.mean_square_flows_cuda(pts, model, t)

    def k5_chain(pts, model, t, mat):
        return bits.statistics(pts, model, t, mat, *decision)

    out = {}
    for name, case in bits.frame_inputs().items():
        args = case["flow"]
        row = dict(k5_call_ms=cuda_ms(lambda: k5_call(*args), REPS),
                   k5_chain_ms=cuda_ms(lambda: k5_chain(*args), REPS),
                   k5_call=device_work(lambda: k5_call(*args)),
                   k5_chain=device_work(lambda: k5_chain(*args)))
        if case["keyframe"] is not None:
            win, imm, model, spacing = case["keyframe"]
            for refine in (False, True):
                inputs = bits.pairing_inputs(win, imm, model, spacing, refine)
                label = "refined" if refine else "unrefined"
                row[f"pairing_{label}_ms"] = cuda_ms(
                    lambda: bits.pairing_call(win, imm, *inputs), REPS)
                row[f"pairing_{label}"] = device_work(
                    lambda: bits.pairing_call(win, imm, *inputs))
        out[name] = row
    return out


def kf_rows() -> dict:
    """{tracker: K12's and K16's calls}."""
    from dsopp_tpu_torch.core.camera import Pinhole
    from dsopp_tpu_torch.features import extractor
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing.paths import path_mask
    from dsopp_tpu_torch.tracker import depth_map as dm
    out = {}
    for name, case in bits.kf_inputs().items():
        row = dict(k=case["window"]["t_lin_q"].shape[0],
                   n=case["window"]["lm_uv"].shape[1])
        map0 = case["maps"][0]
        for label, mask in (("k12", None), ("k12_masked", path_mask("masked"))):
            def k12():
                return extractor.select_candidates_cuda(map0, case["num_points"], mask)
            row[f"{label}_ms"] = cuda_ms(k12, REPS)
            row[label] = device_work(k12)
        win = pba.empty_window(row["k"], row["n"], (3, 1, 1)).replace(**case["window"])
        h, w = case["shape"]
        args = (win, Pinhole(**case["model"]), tuple(case["maps"]), h, w, case["levels"],
                case["frontend_points"])
        row["k16_ms"] = cuda_ms(lambda: dm.build_frontend_state_cuda(*args), REPS)
        row["k16"] = device_work(lambda: dm.build_frontend_state_cuda(*args))
        out[name] = row
    return out


SENSOR_RUNS = 3


def _is_sync(warning) -> bool:
    """A host synchronisation reported by sync debug mode (not the mode's
    own notice that it is a prototype)."""
    text = str(warning.message)
    return "synchroniz" in text and "debug mode" not in text


def next_frame_parts(camera, stack: ExitStack) -> dict:
    """Wrap, for the life of ``stack``, each part of ``camera.next_frame``
    that the tree has with a host timer → {part: seconds in the current
    frame}: ``read`` (the provider's file read), ``semantics`` (the class-id
    image's), and the upload with K18, this tree's ``stage`` (the copy into
    a pinned buffer) and ``intake`` (the one C call), before them ``upload``
    (the pageable copy, which waits for the stream) and ``correct`` (K18)."""
    from dsopp_tpu_torch.sensors import camera as camera_module
    spent = {}

    def timer(label, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
        return timed

    for owner, name, label in ((camera.provider, "next_frame", "read"),
                               (camera, "_load_semantics", "semantics"),
                               (getattr(camera, "_ring", None), "stage", "stage"),
                               (camera_module, "intake_cuda", "intake"),
                               (camera, "_upload", "upload"),
                               (camera_module, "correct_image", "correct")):
        if owner is not None and hasattr(owner, name):
            stack.enter_context(mock.patch.object(owner, name, timer(label, getattr(owner, name))))
    return spent


def sensor_run(seq, folder, params, count_syncs: bool) -> dict:
    """The sensor path once: bootstrap, then the pipelined tracker over the
    camera's frames; counting the host syncs, or timing ``next_frame``'s
    parts."""
    from dsopp_tpu_torch.testing import paths
    from dsopp_tpu_torch.tracker.device_loop import PipelinedTracker

    camera = paths.sensor_camera(folder, params)
    tracker = paths.sensor_bootstrap(camera, seq, paths.path_config("sensor"))
    pipe = PipelinedTracker(tracker, flush_every=16)
    frames = paths.path_frames("sensor") - paths.INIT_FRAMES
    per_frame, in_frame = [], 0
    stream = torch.cuda.current_stream()
    torch.cuda.synchronize()
    with ExitStack() as stack, warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        spent = {} if count_syncs else next_frame_parts(camera, stack)
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for i in range(paths.INIT_FRAMES, paths.INIT_FRAMES + frames):
                before = len(syncs)
                spent.clear()
                busy = not count_syncs and not stream.query()
                t1 = time.perf_counter()
                frame = camera.next_frame()
                spent["next_frame"] = time.perf_counter() - t1
                per_frame.append(dict(spent, busy=busy))
                in_frame += sum(map(_is_sync, syncs[before:]))
                pipe.tick(i, frame.timestamp, frame.image, semantics=frame.semantics,
                          exposure=frame.exposure)
            pipe.drain()
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out = dict(fps=frames / elapsed, ring_waits=getattr(camera, "ring_waits", None))
    if count_syncs:
        sites = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs
                                    if _is_sync(w))
        out.update(host_syncs_per_frame=sum(sites.values()) / frames,
                   next_frame_syncs_per_frame=in_frame / frames,
                   host_sync_sites=dict(sites.most_common(8)))
        return out
    busy = [f for f in per_frame if f["busy"]]
    for label in per_frame[0]:
        if label != "busy":
            out[f"{label}_ms"] = 1e3 * float(np.mean([f.get(label, 0.0) for f in per_frame]))
            out[f"{label}_median_ms"] = 1e3 * float(np.median([f.get(label, 0.0)
                                                               for f in per_frame]))
            if busy:
                out[f"{label}_busy_ms"] = 1e3 * float(np.mean([f.get(label, 0.0) for f in busy]))
    out["busy_frames"] = len(busy)
    return out


def sensor_rows() -> dict:
    """K18, the remap chain it replaced and the intake on a VGA u8 frame of
    the standart corridor; the sensor path's syncs, frames/s and
    ``next_frame``'s parts."""
    import tempfile

    from dsopp_tpu_torch.core.camera import SimpleRadial
    from dsopp_tpu_torch.sensors import photometric as ph
    from dsopp_tpu_torch.sensors.undistorter import build_remaps
    from dsopp_tpu_torch.testing import paths

    seq = paths.render_path("standart")
    h, w = seq.images.shape[1:]
    raw = seq.images[10].clamp(0.0, 255.0).round().to(torch.uint8)
    lut = torch.as_tensor(paths.inverse_response(), device="cuda")
    vignette = torch.as_tensor(paths.sensor_vignette(h, w), device="cuda")
    source = SimpleRadial.create((float(w), float(h)), 500.0, ((w - 1) / 2.0, (h - 1) / 2.0),
                                 -0.12, 0.02)
    und = build_remaps(source, "cuda")

    def k18():
        return ph.correct_image_cuda(raw, lut, vignette)

    def chain():
        return ph.correct_image_cuda(und.undistort(raw), lut, vignette)

    out = dict(intake_tree=hasattr(ph, "intake_cuda"), k18_ms=cuda_ms(k18, REPS),
               k18=device_work(k18), remap_chain_ms=cuda_ms(chain, REPS),
               remap_chain=device_work(chain))
    if out["intake_tree"]:
        pinned = torch.empty((h, w), dtype=torch.uint8, pin_memory=True)
        pinned.copy_(raw.cpu())
        copied = torch.cuda.Event()
        copied.record()
        maps = und.maps32()

        def intake():
            return ph.intake_cuda(pinned, copied, lut, vignette)

        def intake_tables():
            return ph.intake_cuda(pinned, copied, lut, vignette, maps)

        out.update(intake_ms=cuda_ms(intake, REPS), intake=device_work(intake),
                   intake_tables_ms=cuda_ms(intake_tables, REPS),
                   intake_tables=device_work(intake_tables),
                   intake_tables_equal_chain=bool(torch.equal(intake_tables(), chain())))
    with tempfile.TemporaryDirectory(prefix="dsopp_entry_times_") as folder:
        params, _ = paths.write_sensor_folder(seq, folder)
        out["counted"] = sensor_run(seq, folder, params, count_syncs=True)
        out["timed"] = [sensor_run(seq, folder, params, count_syncs=False)
                        for _ in range(SENSOR_RUNS)]
    return out


def sequence_rows() -> dict:
    """{window: {call: ms and device work}} of the solve's one C call over a
    sequence axis at S = 1 and S = 4 beside one and four solo calls."""
    from dsopp_tpu_torch.solvers import pba
    from dsopp_tpu_torch.testing.paths import render_path
    if not hasattr(pba, "solve_loop_sequences"):
        return {}
    seq = render_path("standart")
    out = {}
    for name, (path, every) in bits.SOLVE_WINDOWS.items():
        tracker, _ = bits._tracker(seq, path, every)
        model, opts = tracker.models[0], tracker.pba_opts
        starts = []
        for seed in (0, 1):
            starts.extend(bits.solve_starts(tracker.window, model, opts, seed).values())
        stack = pba.stack_windows(starts)
        singles = [pba.window_at(stack, b) for b in range(len(starts))]
        calls = dict(
            s1=lambda: pba.solve_loop_sequences(stack, model, opts, (0,)),
            s4=lambda: pba.solve_loop_sequences(stack, model, opts),
            solo=lambda: pba._solve_loop_cuda(singles[0], model, opts),
            solo4=lambda: [pba._solve_loop_cuda(w, model, opts) for w in singles])
        out[name] = {key: dict(ms=cuda_ms(fn, REPS), **device_work(fn))
                     for key, fn in calls.items()}
    return out


CASES = {"frame": frame_rows, "status": status_rows, "marg": marg_rows, "kf": kf_rows,
         "sensor": sensor_rows, "seq": sequence_rows}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("entry_times: no CUDA device", file=sys.stderr)
        return 2
    cases = (argv[argv.index("--cases") + 1] if "--cases" in argv else ",".join(CASES)).split(",")
    out = dict(tree=dict(one_call=bits.one_call_tree(), raw_system=bits.raw_system_tree(),
                         poses=bits.poses_tree()),
               card=card_line())
    out.update({case: CASES[case]() for case in cases})
    print(json.dumps(out), flush=True)
    paths = [a for a in argv[1:] if a.endswith(".json")]
    if paths:
        with open(paths[0], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
