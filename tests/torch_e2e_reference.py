"""The JAX package and the port side by side at the setup of
``tests/tracker/test_monocular_e2e.py`` (240×320, 40 frames, an 8-frame
known-pose bootstrap), how the free runs of the two packages compare where
the tick functions agree:

1. the JAX package free-running in ``dtype`` on the CPU, through its device
   loop (``PipelinedTracker``, as the port runs) and its host loop (as the
   JAX test runs), plain and under the exposure oscillation: per-frame
   unaligned RMSE and max;
2. the port's plain versions free-running in ``dtype`` on the CPU at 1, 2, 4
   and 8 torch threads, plain and under the oscillation;
3. under the oscillation, every tick of the JAX device loop's run replayed on
   the port from the JAX state before it (:func:`replay`): the keyframe
   decisions, and how far the port's pose (and, on keyframes, its BA-refined
   window) lands from JAX's.

Run: ``JAX_PLATFORMS=cpu python -m tests.torch_e2e_reference [f32|f64]
[exposure]`` (``exposure``: the oscillation runs only); the JAX package's
thread count follows the cores the process may use (``taskset -c 0``, ...).
About 6 min with every part.

``... [f32|f64] perturbed [seed ...]`` runs the exposure run of both
packages with N(0, NOISE²) grey levels added to every frame, one draw per
seed (1 to 4 by default): how the fork falls when only the roundings move.
"""

import dataclasses
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dsopp_tpu.core.lie import SE3 as JSE3  # noqa: E402
from dsopp_tpu.testing import render_sequence  # noqa: E402
from dsopp_tpu.tracker import device_loop as jdl  # noqa: E402
from dsopp_tpu.tracker.monocular import MonocularTracker as JTracker  # noqa: E402
from dsopp_tpu.tracker.monocular import TrackerConfig as JConfig  # noqa: E402
from dsopp_tpu_torch import convert  # noqa: E402
from dsopp_tpu_torch.testing import paths  # noqa: E402
from dsopp_tpu_torch.tracker import device_loop as tdl  # noqa: E402
from dsopp_tpu_torch.tracker.monocular import MonocularTracker, TrackerConfig  # noqa: E402

from tests._torch_port import state_fields  # noqa: E402

INIT, FRAMES = paths.E2E_INIT_FRAMES, paths.E2E_FRAMES


def frame(seq, i, exposure, np_dtype, noise=None):
    image = np.asarray(seq.images[i]) + (0.0 if noise is None else noise[i])
    if not exposure:
        return image.astype(np_dtype), 1.0
    e = paths.oscillating_exposure(i)
    return np.clip(image * e - 4.0, 0.0, 255.0).astype(np_dtype), e


def rmse_max(est, seq):
    gt = np.stack([np.asarray(seq.pose_t_wc(i).t) for i in range(INIT, FRAMES)])
    errs = np.linalg.norm(np.asarray(est, np.float64) - gt, axis=-1)
    return float(np.sqrt(np.mean(errs ** 2))), float(errs.max())


def jax_bootstrap(seq, exposure, dtype, noise=None):
    jt = JTracker(seq.camera, JConfig(**dataclasses.asdict(paths.e2e_config())), dtype=dtype)
    for j in range(INIT):
        img, e = frame(seq, j, exposure, np.dtype(dtype), noise)
        jt.tick(j, float(seq.timestamps[j]), jnp.asarray(img),
                known_pose=JSE3(jnp.asarray(seq.pose_t_wc(j).q, dtype),
                                jnp.asarray(seq.pose_t_wc(j).t, dtype)),
                force_keyframe=j == INIT - 1, exposure=e)
    return jt


def jax_run(seq, loop, exposure, dtype, noise=None):
    jt = jax_bootstrap(seq, exposure, dtype, noise)
    est = []
    if loop == "host":
        for i in range(INIT, FRAMES):
            img, e = frame(seq, i, exposure, np.dtype(dtype), noise)
            est.append(np.asarray(jt.tick(i, float(seq.timestamps[i]), jnp.asarray(img),
                                          exposure=e)["pose"].t))
        return rmse_max(est, seq)
    pipe = jdl.PipelinedTracker(jt, flush_every=1000)
    for i in range(INIT, FRAMES):
        img, e = frame(seq, i, exposure, np.dtype(dtype), noise)
        pipe.tick(i, float(seq.timestamps[i]), jnp.asarray(img), exposure=e)
        est.append(np.asarray(pipe.pending[-1][2].pose_t))
    pipe.finalize()
    return rmse_max(est, seq)


def replay(seq, dtype):
    """The JAX device loop under the oscillation, and before each of its
    ticks the port's ``device_tick`` from the JAX state → one record a tick:
    (frame, JAX's keyframe decision, the port's, the largest coordinate gap
    of the two poses in m, and on keyframes the largest gap of the BA-refined
    window's translations in m, else None)."""
    tdtype = torch.float32 if dtype == jnp.float32 else torch.float64
    pipe = jdl.PipelinedTracker(jax_bootstrap(seq, True, dtype), flush_every=1000)
    port = MonocularTracker(convert.pinhole(seq.camera.fx, seq.camera.fy, seq.camera.cx,
                                            seq.camera.cy, seq.camera.image_size),
                            TrackerConfig(**dataclasses.asdict(paths.e2e_config())),
                            dtype=tdtype, device="cpu")
    models, lcfg = tuple(port.models), port.loop_config()
    records = []
    for i in range(INIT, FRAMES):
        img, e = frame(seq, i, True, np.dtype(dtype))
        before = jax.tree_util.tree_map(np.array, state_fields(pipe.state))
        pipe.tick(i, float(seq.timestamps[i]), jnp.asarray(img), exposure=e)
        jd = pipe.pending[-1][2]
        st, d = tdl.device_tick(convert.device_tracker_state(before, dtype=tdtype),
                                torch.as_tensor(img), i, False, models, lcfg, exposure=e)
        gap = float(np.abs(np.asarray(jd.pose_t, np.float64) - d.pose_t.double().numpy()).max())
        window_gap = None
        if bool(jd.is_keyframe):
            win = convert.window(jax.tree_util.tree_map(
                np.array, state_fields(pipe.state))["window"], dtype=tdtype)
            window_gap = float((win.poses().t - st.window.poses().t).abs().max())
        records.append((i, bool(jd.is_keyframe), bool(d.is_keyframe), gap, window_gap))
    pipe.finalize()
    return records


def port_run(exposure, dtype, threads):
    # the run's last bits follow the reductions' split across threads
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        seq, _, diags = paths.e2e_run(dtype, "cpu", exposure=exposure)
    finally:
        torch.set_num_threads(before)
    est = torch.stack([d.pose_t for d in diags]).double().numpy()
    errs = np.linalg.norm(est - seq.poses_t[INIT:FRAMES], axis=-1)
    return float(np.sqrt(np.mean(errs ** 2))), float(errs.max())


def port_perturbed(seq, dtype, noise):
    """The port's plain versions on one thread over the JAX package's
    rendering of the exposure run with ``noise`` added to every frame, as
    ``paths.e2e_run`` drives it → (RMSE, max)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cam = convert.pinhole(seq.camera.fx, seq.camera.fy, seq.camera.cx, seq.camera.cy,
                              seq.camera.image_size)
        tracker = MonocularTracker(cam, paths.e2e_config(), dtype=dtype, device="cpu")
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        for j in range(INIT):
            img, e = frame(seq, j, True, np_dtype, noise)
            pose = seq.pose_t_wc(j)
            tracker.tick(j, float(seq.timestamps[j]), torch.as_tensor(img),
                         known_pose=convert.se3(np.asarray(pose.q), np.asarray(pose.t), dtype,
                                                "cpu"),
                         force_keyframe=j == INIT - 1, exposure=e)
        pipe = tdl.PipelinedTracker(tracker, flush_every=16)
        est = []
        for i in range(INIT, FRAMES):
            img, e = frame(seq, i, True, np_dtype, noise)
            est.append(pipe.tick(i, float(seq.timestamps[i]), torch.as_tensor(img),
                                 exposure=e).pose_t.double().numpy())
        pipe.finalize()
    finally:
        torch.set_num_threads(before)
    return rmse_max(est, seq)


def perturbed(name, seeds):
    """The exposure run of both packages in ``name``'s precision with
    N(0, NOISE²) grey levels added to every frame, one draw per seed (seed 0:
    none)."""
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}[name]
    seq = render_sequence(num_frames=FRAMES, height=paths.E2E_SIZE[0], width=paths.E2E_SIZE[1])
    shape = np.asarray(seq.images).shape
    for seed in seeds:
        noise = NOISE * np.random.default_rng(seed).standard_normal(shape) if seed else None
        rmse, mx = jax_run(seq, "device", True, jdtype, noise)
        print(f"seed {seed}: JAX {name} device loop RMSE {rmse!r} m, max {mx!r} m", flush=True)
        rmse, mx = port_perturbed(seq, tdtype, noise)
        print(f"seed {seed}: port {name} (one thread) RMSE {rmse!r} m, max {mx!r} m", flush=True)


NOISE = 1e-3   # grey levels: far below a u8 step, far above an f32 rounding at 255


def main(argv):
    if len(argv) > 2 and argv[2] == "perturbed":
        perturbed(argv[1], [int(v) for v in argv[3:]] or [1, 2, 3, 4])
        return 0
    name = argv[1] if len(argv) > 1 else "f32"
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}[name]
    seq = render_sequence(num_frames=FRAMES, height=paths.E2E_SIZE[0], width=paths.E2E_SIZE[1])
    for exposure in (False, True):
        if not exposure and "exposure" in argv[2:]:
            continue
        label = "exposure oscillation" if exposure else "plain"
        for loop in ("device", "host"):
            rmse, mx = jax_run(seq, loop, exposure, jdtype)
            print(f"JAX {name} {loop} loop, {label}: RMSE {rmse!r} m, max {mx!r} m", flush=True)
        for threads in (1, 2, 4, 8):
            rmse, mx = port_run(exposure, tdtype, threads)
            print(f"port {name} (plain versions, CPU, {threads} threads), {label}: RMSE {rmse!r}"
                  f" m, max {mx!r} m", flush=True)
    print(f"the exposure run's ticks replayed on the port ({name}) from the JAX state:")
    records = replay(seq, jdtype)
    for i, kf_jax, kf_port, gap, window_gap in records:
        line = f"  tick {i}: keyframe JAX {kf_jax} port {kf_port}, pose {gap!r} m from JAX's"
        print(line + ("" if window_gap is None else f", BA-refined window {window_gap!r} m"))
    print(f"  decisions equal on {sum(r[1] == r[2] for r in records)} of {len(records)} ticks;"
          f" largest pose gap {max(r[3] for r in records)!r} m, largest window gap"
          f" {max(r[4] for r in records if r[4] is not None)!r} m")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
