"""Where a tracked frame's time goes on the card, for the paths of
``dsopp_tpu_torch.testing.paths`` (the ones ``chip_smoke.py`` drives).

    python -m dsopp_tpu_torch.testing.profile_track [out.json] [path ...]

``path`` is ``standart``, ``fast``, ``dense``, ``masked`` or ``ledger`` (default:
all five).  Per
path, after the 6-frame known-pose bootstrap:

1. ``REPEATS`` plain runs over all frames: frames/s of each (host clock
   around work that ends in a device synchronisation), keyframes,
   escalations, K3 iterations per launch;
2. one run with synchronised stage timers around the align chain, the
   epipolar update, the flow statistic, the pyramid, the whole frontend and
   the keyframe backend with its parts (push, the new bank with its candidate
   selection, activation, refinement, pairing, BA solve down to its six
   kernels' calls, the marginalization policy and the ledger fold each with
   its kernel's call, depth maps; each timer synchronises the device
   before and after, so the stages do not overlap and their sum exceeds an
   untimed frame).  The timers are hung on the modules' functions from here,
   so the tracker itself carries no instrumentation;
3. in that run, ``torch.profiler`` over ``WINDOW`` steady frames (device
   busy time per frame; idle share against the plain runs' frame time;
   device time per launch of each hand-written kernel) and
   PyTorch's sync debug mode over the next ``WINDOW`` frames (host
   synchronisations per frame, and per keyframe inside the keyframe backend
   and inside the span from the policy through the ledger fold);
4. the last frame once more from the state before it, ``REPEATS`` times as
   it is and ``REPEATS`` times with the re-track gate closed
   (``rmse_last0`` tiny, so the 105 further hypotheses run): the cost of an
   escalated frame.

Prints one JSON object per path, with the card's name and power limit, and
writes them to ``out.json`` when given.  Needs a CUDA card.
"""

from __future__ import annotations

import json
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
from dsopp_tpu_torch.tracker import device_loop, fused_keyframe, fused_tick, marginalization

REPEATS, WINDOW = 3, 10
# __global__ functions of csrc/ by the names the profiler reports
KERNEL_NAMES = ("pyramid_level_kernel", "align_level_kernel", "epipolar_kernel",
                "flow_kernel", "ba_fej_kernel", "ba_evaluate_kernel", "pair_kernel",
                "landmark_kernel", "reduce_kernel", "solve_kernel", "backsub_kernel",
                "norm_kernel", "decide_kernel", "commit_kernel", "finish_kernel",
                "quantile_kernel", "status_kernel", "region_threshold_kernel",
                "tile_argmax_kernel", "rank_tiles_kernel", "active_projections_kernel",
                "candidates_kernel", "compact_kernel", "refine_kernel", "pair_slots_kernel",
                "project_kernel", "depth_scatter_kernel", "pool_kernel", "dilate_kernel",
                "hist_kernel", "class_threshold_kernel", "tile_count_kernel",
                "select_write_kernel", "heavy_rank_kernel", "policy_kernel", "fold_kernel",
                "fold_out_kernel")
# (module, function) -> stage name
STAGES = {
    (device_loop, "_frontend_core"): "frontend",
    (fused_tick, "build_pyramid_maps"): "pyramid",
    (fused_tick, "_run_chunks"): "align_chain",
    (fused_tick, "estimate_depths"): "epipolar",
    (fused_tick, "mean_square_flows"): "flow",
    (device_loop, "keyframe_update"): "keyframe_backend",
    (fused_keyframe, "push_frame_slot"): "kf_push",
    (fused_keyframe, "immature_bank"): "kf_bank",
    (fused_keyframe, "select_candidates"): "kf_candidates",
    (fused_keyframe, "_activation_kernel"): "kf_activation",
    (fused_keyframe, "_refine_idepth_kernel"): "kf_refine",
    (fused_keyframe, "_activation_scatter"): "kf_scatter",
    (fused_keyframe, "_solve_loop_device"): "kf_ba_solve",
    (device_loop, "flags_device"): "kf_flags",
    (device_loop, "_marginalize_device"): "kf_marginalize",
    (marginalization, "flags_device_cuda"): "kf_policy_kernel",   # K15p's call
    (pba, "_marginalize_cuda"): "kf_fold_kernel",                 # K15's call
    (device_loop, "build_frontend_state"): "kf_depth_maps",
    # the wrappers the device-resident loop and the dispatchers both end in
    (pba, "_fej_cache_cuda"): "ba_fej",
    (pba, "_evaluate_cuda"): "ba_evaluate",
    (pba, "_linearize_from_ev_cuda"): "ba_linearize",
    (pba, "_solve_step_launch"): "ba_solve_step",
    (pba, "_lm_phase"): "ba_lm",
    (pba, "_point_status_from_ev_cuda"): "ba_point_status",
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
    """Wraps the functions of ``STAGES`` with synchronised timers."""

    def __init__(self):
        self.ms = defaultdict(float)
        self.calls = defaultdict(int)
        self.saved = []

    def __enter__(self):
        for (module, name), stage in STAGES.items():
            fn = getattr(module, name)
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
            return out
        return timed


class SyncCounts:
    """Counts the host synchronisations that sync debug mode reports (into
    ``caught``) inside the keyframe backend and inside the span from the
    marginalization policy through the ledger fold."""

    SPANS = ((device_loop, "keyframe_update", "keyframe_backend"),
             (device_loop, "flags_device", "marginalization"),
             (device_loop, "_marginalize_device", "marginalization"))

    def __init__(self, caught):
        self.caught = caught
        self.syncs = defaultdict(int)
        self.keyframes = 0
        self.saved = []

    def __enter__(self):
        for module, name, span in self.SPANS:
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
    """Records the iteration counts K3 returns (device tensors, read at the end)."""

    def __init__(self):
        self.results = []
        self.fn = pose_alignment.align_level_cuda

    def __enter__(self):
        def logged(*args, **kwargs):
            res = self.fn(*args, **kwargs)
            self.results.append(res.iterations)
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


def profile_path(name):
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
    with StageTimers() as timers:
        _, kf, esc = run_frames(pipe, seq, warm, split)
    frames = split - warm
    per_frame = ("frontend", "pyramid", "align_chain", "epipolar", "flow")
    out["stages_ms"] = {stage: timers.ms[stage] / (frames if stage in per_frame else max(kf, 1))
                        for stage in STAGES.values()}
    out["stage_calls"] = dict(timers.calls)
    out["stage_window"] = dict(frames=frames, keyframes=kf, escalations=esc)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, kf, _ = run_frames(pipe, seq, split, split + WINDOW)
    device_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                    for e in prof.key_averages())
    busy_ms = device_us / 1e3 / WINDOW
    own = defaultdict(lambda: [0, 0.0])
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        for name in KERNEL_NAMES:
            if name in e.key and us > 0 and "at::" not in e.key and "aten::" not in e.key:
                own[name][0] += e.count
                own[name][1] += us
    out["kernel_device_us_per_launch"] = {name: dict(launches=n, us=us / n)
                                          for name, (n, us) in own.items()}
    out["device_busy_ms_per_frame"] = busy_ms
    out["device_idle_share"] = 1.0 - busy_ms / frame_ms
    out["profiled_window"] = dict(frames=WINDOW, keyframes=kf)

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with SyncCounts(caught) as spans:
            _, kf, _ = run_frames(pipe, seq, split + WINDOW, last - 1)
    torch.cuda.set_sync_debug_mode("default")
    syncs = spans.count()
    out["host_syncs_per_frame"] = syncs / (WINDOW - 1)
    out["host_syncs_per_keyframe"] = ({span: n / spans.keyframes for span, n in spans.syncs.items()}
                                      if spans.keyframes else None)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["sync_window"] = dict(frames=WINDOW - 1, keyframes=kf)

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
    out_file = next((a for a in argv[1:] if a not in names), None)
    for name in [a for a in argv[1:] if a in names] or names:
        torch.cuda.reset_peak_memory_stats()
        res = profile_path(name)
        res["card"] = card
        results.append(res)
        print(json.dumps(res), flush=True)
    if out_file:
        with open(out_file, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
