"""Where a tracked frame's time goes on the card, for the paths of
``dsopp_tpu_torch.testing.paths`` (the ones ``chip_smoke.py`` drives).

    python -m dsopp_tpu_torch.testing.profile_track [--parent-tree] [out.json] [path ...]

``path`` is ``standart``, ``fast``, ``dense``, ``masked``, ``ledger`` or
``embedder`` (default: all six).  ``--parent-tree``: the package imported is
another tree's (this file run with that tree first on ``PYTHONPATH``); a
stage whose function that tree lacks is not timed and is listed under
``untimed_stages``.  Without it a missing function is an error.  Per
path, after the 6-frame known-pose bootstrap:

1. ``REPEATS`` plain runs over all frames: frames/s of each (host clock
   around work that ends in a device synchronisation), keyframes,
   escalations, K3 iterations per launch;
2. one run with synchronised stage timers around the align chain, the
   epipolar update, the flow statistic, the pyramid, the whole frontend and
   the keyframe backend with its parts (push, the new bank with its candidate
   selection, activation, refinement, pairing, BA solve down to its one C
   call (``ba_solve_loop``: K7–K11, the iterations issued from C), the
   marginalization policy and the ledger fold each with its kernel's call,
   depth maps; each timer synchronises the device
   before and after, so the stages do not overlap and their sum exceeds an
   untimed frame).  The timers are hung on the modules' functions from here,
   so the tracker itself carries no instrumentation;
3. in that run, ``torch.profiler`` over ``WINDOW`` steady frames (device
   busy time per frame; idle share against the plain runs' frame time;
   device time per launch of each hand-written kernel; K3's device time and
   longest LM iteration count per launch by level and number of hypotheses);
4. the last frame once more from the state before it, ``REPEATS`` times as
   it is and ``REPEATS`` times with the re-track gate closed
   (``rmse_last0`` tiny, so the 105 further hypotheses run): the cost of an
   escalated frame;
5. one more run over all frames, untimed, with the stages of 2 reading the
   device memory's peak after each call (each read builds the allocator's
   whole statistics on the host, which is why the timed run makes none): the
   innermost stage in which the run's peak was reached;
6. one more run over all frames, untimed, under PyTorch's sync debug mode
   "warn", the last frames' bookkeeping drained at its end: host
   synchronisations per frame (every tick and every frame's bookkeeping), and
   per keyframe inside the keyframe backend and inside the span from the
   policy through the ledger fold.

Prints one JSON object per path, with the card's name and power limit, and
writes them to ``out.json`` when given.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import math
import sys
import time
import warnings
from collections import defaultdict

import torch

from dsopp_tpu_torch import kernels
from dsopp_tpu_torch.solvers import pba, pose_alignment
from dsopp_tpu_torch.testing.paths import (INIT_FRAMES, PATHS, bootstrap, card_line,
                                           closed_gate, path_config, path_frames, path_mask,
                                           render_path)
from dsopp_tpu_torch.testing.profiling import profiled
from dsopp_tpu_torch.tracker import device_loop, fused_keyframe, fused_tick, marginalization

REPEATS, WINDOW = 3, 10
# __global__ functions of csrc/ by the names the profiler reports (an earlier
# design's names stay, so that a parent tree profiled with this file reads
# them too)
KERNEL_NAMES = ("pyramid_kernel", "pyramid_level_kernel", "align_level_kernel",
                "epipolar_update_kernel", "epipolar_kernel",
                "flow_kernel", "ba_evaluate_kernel", "pair_kernel",
                "landmark_kernel", "schur_kernel", "reduce_kernel", "assemble_kernel",
                "solve_kernel", "backsub_kernel", "norm_kernel", "carry_kernel", "decide_kernel",
                "commit_kernel", "finish_kernel", "quantile_kernel", "count_kernel",
                "collect_kernel", "status_kernel",
                "region_threshold_kernel",
                "tile_argmax_kernel", "rank_tiles_kernel", "activation_landmarks_kernel",
                "activation_walk_kernel", "active_projections_kernel",
                "candidates_kernel", "compact_kernel", "refine_kernel", "pair_slots_kernel",
                "prepare_kernel", "twins_kernel", "chain_kernel", "dilate_hist_kernel",
                "class_rank_kernel", "heavy_write_kernel",
                "project_kernel", "depth_scatter_kernel", "pool_kernel", "dilate_kernel",
                "hist_kernel", "class_threshold_kernel", "tile_count_kernel",
                "select_write_kernel", "heavy_rank_kernel", "policy_kernel", "fold_kernel",
                "marg_solve_kernel", "fold_out_kernel")
# entry point -> its kernels (K13's and K16's current ones, then an earlier
# design's, so that a parent tree profiled with this file is read too): device
# time per call of the entry
KERNEL_GROUPS = {
    "select_candidates": ("region_threshold_kernel", "tile_argmax_kernel", "rank_tiles_kernel"),
    "activation": ("activation_landmarks_kernel", "activation_walk_kernel",
                   "active_projections_kernel", "candidates_kernel"),
    "refine_idepth": ("compact_kernel", "refine_kernel"),
    "flow_statistic": ("flow_kernel",),
    "ba_point_status": ("quantile_kernel", "count_kernel", "collect_kernel", "status_kernel"),
    "marg_fold": ("fold_kernel", "marg_solve_kernel", "fold_out_kernel"),
    "activation_scatter": ("pair_slots_kernel",),
    "ba_linearize_schur": ("pair_kernel", "landmark_kernel", "schur_kernel", "reduce_kernel"),
    "depth_maps": ("prepare_kernel", "twins_kernel", "chain_kernel", "pool_kernel",
                   "dilate_hist_kernel", "class_threshold_kernel", "tile_count_kernel",
                   "select_write_kernel", "class_rank_kernel", "heavy_write_kernel",
                   "project_kernel", "depth_scatter_kernel", "dilate_kernel", "hist_kernel",
                   "heavy_rank_kernel"),
}
# a stage's function -> its name in an earlier design, timed in its place in a
# parent tree that lacks it (K5 was the flows alone, the decision in torch; the
# keyframe backend's steps were one-sequence calls)
EARLIER_NAMES = {"frame_statistics": "mean_square_flows", "flags_sequences": "flags_device",
                 "marginalize_sequences": "_marginalize_device",
                 "_flags_sequences_cuda": "flags_device_cuda",
                 "_marginalize_sequences_cuda": "_marginalize_cuda",
                 "push_frame_sequences": "push_frame_slot",
                 "immature_bank_sequences": "immature_bank",
                 "select_candidates_sequences": "select_candidates",
                 "activation_sequences": "_activation_kernel",
                 "refine_idepth_sequences": "_refine_idepth_kernel",
                 "activation_scatter_sequences": "_activation_scatter",
                 "build_frontend_state_sequences": "build_frontend_state"}
# (module, function) -> stage name
STAGES = {
    (device_loop, "_frontend_core"): "frontend",
    (fused_tick, "build_pyramid_maps"): "pyramid",
    (fused_tick, "_run_chunks"): "align_chain",
    (fused_tick, "estimate_depths"): "epipolar",
    (fused_tick, "frame_statistics"): "flow",     # K5 with the keyframe decision
    (device_loop, "keyframe_update"): "keyframe_backend",
    (fused_keyframe, "push_frame_sequences"): "kf_push",
    (fused_keyframe, "immature_bank_sequences"): "kf_bank",
    (fused_keyframe, "select_candidates_sequences"): "kf_candidates",
    (fused_keyframe, "activation_sequences"): "kf_activation",
    (fused_keyframe, "refine_idepth_sequences"): "kf_refine",
    (fused_keyframe, "activation_scatter_sequences"): "kf_scatter",
    (device_loop, "solve_loop_sequences"): "kf_ba_solve",
    (device_loop, "flags_sequences"): "kf_flags",
    (device_loop, "marginalize_sequences"): "kf_marginalize",
    (marginalization, "_flags_sequences_cuda"): "kf_policy_kernel",   # K15p's call
    (pba, "_marginalize_sequences_cuda"): "kf_fold_kernel",           # K15's call
    (device_loop, "build_frontend_state_sequences"): "kf_depth_maps",
    # the BA solve's one C call (K7-K11 issued from C)
    (kernels, "BA_SOLVE_LOOP"): "ba_solve_loop",
}


def start(seq, name):
    return device_loop.PipelinedTracker(bootstrap(seq, path_config(name), path_mask(name)),
                                        flush_every=16)


def run_frames(pipe, seq, first, last):
    """Ticks first..last-1 → (seconds, keyframes, escalations), synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kf = esc = 0
    for i in range(first, last):
        diag = pipe.tick(i, float(seq.timestamps[i]), seq.images[i])
        kf += int(diag.is_keyframe)
        esc += int(diag.escalated)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, kf, esc


class StageTimers:
    """Wraps the functions of ``STAGES`` with synchronised timers; with
    ``peak``, each call also reads the device memory's peak so far.  A stage
    whose function the package lacks raises, or, with ``missing_ok`` (a
    parent tree), is left untimed and named in ``untimed``."""

    def __init__(self, peak=False, missing_ok=False):
        self.ms = defaultdict(float)
        self.calls = defaultdict(int)
        self.saved = []
        self.untimed = []
        self.track_peak = peak
        self.missing_ok = missing_ok
        self.peak = (None, 0)     # (the innermost stage that reached the run's peak, bytes)

    def __enter__(self):
        for (module, name), stage in STAGES.items():
            fn = getattr(module, name, None)
            if fn is None and self.missing_ok and name in EARLIER_NAMES:
                name = EARLIER_NAMES[name]
                fn = getattr(module, name, None)
            if fn is None:
                if not self.missing_ok:
                    self.__exit__()
                    raise AttributeError(f"stage {stage}: {module.__name__} has no {name}")
                self.untimed.append(stage)
                continue
            self.saved.append((module, name, fn))
            setattr(module, name, self.wrap(fn, stage))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)

    def wrap(self, fn, stage):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[stage] += 1e3 * (time.perf_counter() - t0)
            self.calls[stage] += 1
            if self.track_peak:
                peak = torch.cuda.max_memory_allocated()
                if peak > self.peak[1]:
                    self.peak = (stage, peak)
            return out
        return timed


class SyncCounts:
    """Counts the host synchronisations that sync debug mode reports (into
    ``caught``) inside the keyframe backend and inside the span from the
    marginalization policy through the ledger fold."""

    SPANS = ((device_loop, "keyframe_update", "keyframe_backend"),
             (device_loop, "flags_sequences", "marginalization"),
             (device_loop, "marginalize_sequences", "marginalization"))

    def __init__(self, caught):
        self.caught = caught
        self.syncs = defaultdict(int)
        self.keyframes = 0
        self.saved = []

    def __enter__(self):
        for module, name, span in self.SPANS:
            if not hasattr(module, name) and name in EARLIER_NAMES:
                name = EARLIER_NAMES[name]      # a parent tree's
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            setattr(module, name, self.wrap(fn, span, name == "keyframe_update"))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)

    def wrap(self, fn, span, counts_keyframe):
        def counted(*args, **kwargs):
            before = self.count()
            out = fn(*args, **kwargs)
            self.syncs[span] += self.count() - before
            self.keyframes += int(counts_keyframe)
            return out
        return counted

    def count(self):
        return sum("synchroniz" in str(w.message) for w in self.caught)


class IterationLog:
    """Records the iteration counts K3 returns (device tensors, read at the
    end), with each launch's map width and number of hypotheses."""

    def __init__(self):
        self.results = []
        self.launches = []
        self.fn = pose_alignment.align_level_cuda

    def __enter__(self):
        def logged(pts, pixel_map, *args, **kwargs):
            res = self.fn(pts, pixel_map, *args, **kwargs)
            self.results.append(res.iterations)
            self.launches.append((int(pixel_map.shape[-1]), int(res.iterations.shape[0])))
            return res
        pose_alignment.align_level_cuda = logged
        return self

    def __exit__(self, *exc):
        pose_alignment.align_level_cuda = self.fn

    def summary(self):
        its = torch.cat(self.results).double()
        per_launch = torch.stack([r.max() for r in self.results]).double()
        return dict(launches=len(self.results), mean_per_hypothesis=float(its.mean()),
                    mean_longest_per_launch=float(per_launch.mean()),
                    max=int(its.max()))

    def by_level(self, device_us, width):
        """K3 by (level, hypotheses): launches, the mean device µs of a launch
        (``device_us``: the kernel's device times in launch order, one per
        logged call) and the mean longest LM iteration count of a launch;
        ``width`` is level 0's."""
        groups = defaultdict(lambda: [0, 0.0, 0.0])
        for (w, hyps), us, its in zip(self.launches, device_us, self.results):
            key = f"level {round(math.log2(width / w))}, {hyps} hypotheses"
            groups[key][0] += 1
            groups[key][1] += us
            groups[key][2] += float(its.max())
        return {key: dict(launches=n, device_us=us / n, mean_longest_iterations=it / n)
                for key, (n, us, it) in sorted(groups.items())}


def profile_path(name, parent_tree=False):
    seq = render_path(name)
    last = path_frames(name)
    out = dict(path=name, frames=last - INIT_FRAMES, runs=[])
    for _ in range(REPEATS):
        pipe = start(seq, name)
        kernels.reset_counts()
        with IterationLog() as log:
            seconds, kf, esc = run_frames(pipe, seq, INIT_FRAMES, last)
        out["runs"].append(dict(fps=(last - INIT_FRAMES) / seconds,
                                ms_per_frame=1e3 * seconds / (last - INIT_FRAMES),
                                keyframes=kf, escalations=esc, launches=kernels.counts(),
                                k3_iterations=log.summary()))
    frame_ms = sum(r["ms_per_frame"] for r in out["runs"]) / REPEATS

    pipe = start(seq, name)
    warm = INIT_FRAMES + 10
    run_frames(pipe, seq, INIT_FRAMES, warm)
    split = last - 2 * WINDOW
    with StageTimers(missing_ok=parent_tree) as timers:
        _, kf, esc = run_frames(pipe, seq, warm, split)
    frames = split - warm
    per_frame = ("frontend", "pyramid", "align_chain", "epipolar", "flow")
    out["stages_ms"] = {stage: timers.ms[stage] / (frames if stage in per_frame else max(kf, 1))
                        for stage in STAGES.values() if stage not in timers.untimed}
    out["untimed_stages"] = timers.untimed
    out["stage_calls"] = dict(timers.calls)
    out["stage_window"] = dict(frames=frames, keyframes=kf, escalations=esc)

    before = kernels.counts()
    with profiled([torch.profiler.ProfilerActivity.CPU,
                   torch.profiler.ProfilerActivity.CUDA]) as prof:
        with IterationLog() as log:
            _, kf, _ = run_frames(pipe, seq, split, split + WINDOW)
    k3 = sorted((e for e in prof.events() if "align_level_kernel" in e.name
                 and e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if len(k3) == len(log.launches):
        out["k3_by_level"] = log.by_level([e.time_range.elapsed_us() for e in k3],
                                          int(seq.images.shape[-1]))
    else:
        out["k3_by_level"] = f"not measured: {len(k3)} kernel events, {len(log.launches)} calls"
    device_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                    for e in prof.key_averages())
    busy_ms = device_us / 1e3 / WINDOW
    own = defaultdict(lambda: [0, 0.0])
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        # the longest name the key holds ("dilate_hist_kernel", not "hist_kernel")
        name = max((k for k in KERNEL_NAMES if k in e.key), key=len, default=None)
        if name and us > 0 and "at::" not in e.key and "aten::" not in e.key:
            own[name][0] += e.count
            own[name][1] += us
    out["kernel_device_us_per_launch"] = {name: dict(launches=n, us=us / n)
                                          for name, (n, us) in own.items()}
    calls = {name: n - before[name] for name, n in kernels.counts().items()}
    out["kernel_device_us_per_call"] = {
        entry: dict(calls=calls[entry], us=sum(own[k][1] for k in group if k in own)
                    / max(calls[entry], 1))
        for entry, group in KERNEL_GROUPS.items()}
    out["device_busy_ms_per_frame"] = busy_ms
    out["device_idle_share"] = 1.0 - busy_ms / frame_ms
    out["profiled_window"] = dict(frames=WINDOW, keyframes=kf)

    run_frames(pipe, seq, split + WINDOW, last - 1)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()

    def last_frame_ms(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, diag = device_loop.device_tick(state, seq.images[last - 1], last - 1, False,
                                          pipe.models, pipe.cfg, mask=pipe.mask)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), diag

    regular = [last_frame_ms(pipe.state) for _ in range(REPEATS)]
    escalated = [last_frame_ms(closed_gate(pipe.state)) for _ in range(REPEATS)]
    out["last_frame"] = dict(
        regular_ms=[ms for ms, _ in regular], escalated_ms=[ms for ms, _ in escalated],
        regular_is_keyframe=bool(regular[0][1].is_keyframe),
        escalated=[bool(d.escalated) for _, d in escalated],
        pose_distance_m=float((escalated[0][1].pose_t - regular[0][1].pose_t).norm()))

    del pipe, regular, escalated
    torch.cuda.reset_peak_memory_stats()
    with StageTimers(peak=True, missing_ok=parent_tree) as peaks:
        run_frames(start(seq, out["path"]), seq, INIT_FRAMES, last)
    out["peak_memory_stage"] = dict(stage=peaks.peak[0], bytes=peaks.peak[1])

    # every host synchronisation of a whole run, the bookkeeping of every frame
    # included (the last frames' drained at the end)
    pipe = start(seq, out["path"])
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with SyncCounts(caught) as spans:
            _, kf, _ = run_frames(pipe, seq, INIT_FRAMES, last)
            pipe.drain()
    torch.cuda.set_sync_debug_mode("default")
    out["host_syncs_per_frame"] = spans.count() / (last - INIT_FRAMES)
    out["host_syncs_per_keyframe"] = ({span: n / spans.keyframes for span, n in spans.syncs.items()}
                                      if spans.keyframes else None)
    out["sync_window"] = dict(frames=last - INIT_FRAMES, keyframes=kf)
    return out


def main(argv):
    if not torch.cuda.is_available():
        print("profile_track: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    kernels.library()
    results = []
    # the sensor path reads its frames from a camera's files (chip_smoke.py
    # [sensor]); behind the camera it runs the standart path's stages
    names = [name for name in PATHS if name != "sensor"]
    args = [a for a in argv[1:] if a != "--parent-tree"]
    out_file = next((a for a in args if a not in names), None)
    for name in [a for a in args if a in names] or names:
        torch.cuda.reset_peak_memory_stats()
        res = profile_path(name, parent_tree="--parent-tree" in argv[1:])
        res["card"] = card
        results.append(res)
        print(json.dumps(res), flush=True)
    if out_file:
        with open(out_file, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
