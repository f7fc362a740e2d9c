"""The JAX package's application on the input of ``chip_smoke.py``'s
``[app]`` phase, on the CPU, and the port's beside it: where the phase's
gates come from.

The standart corridor (``testing/paths.py::render_path("standart")``: 120
frames at 480×640, focal 520) rendered by the port in ``dtype`` on the CPU
is written as the phase writes it (``testing/paths.py::write_app_folder``:
u8 ``.npy`` frames, ``times.txt``, a pinhole ``calib.txt`` and a JSON
``mono.json`` at the standart point with no poses file); then

1. the JAX package's ``build_application`` + ``run`` on those files, in
   ``dtype`` on the CPU: the frame its feature-based bootstrap finishes on,
   the bootstrap poses' and the whole trajectory's similarity-aligned ATE
   RMSE against ground truth, and the bound the phase derives from it,
   max(1.5 × RMSE, RMSE + 0.01 m);
2. unless ``jax-only``, the port's app on the same files on the CPU (plain
   versions, 4 torch threads), the same numbers.

Run: ``python -m tests.torch_app_reference [f32|f64] [jax-only]`` from the
repository's root (~3 min; the files go to a temporary folder).
"""

import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")
if "f64" in sys.argv[1:]:
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dsopp_tpu.config import build_application as jax_build  # noqa: E402
from dsopp_tpu.config import load_config as jax_load  # noqa: E402
from dsopp_tpu_torch.config import loader  # noqa: E402
from dsopp_tpu_torch.output.ate import absolute_trajectory_error  # noqa: E402
from dsopp_tpu_torch.testing import paths  # noqa: E402


def _ate(entries, gt):
    return absolute_trajectory_error([(t, np.asarray(m)) for t, m in entries], gt, align=True,
                                     with_scale=True)


def _report(label, app, done_at, gt, seconds):
    fbs = [(ts, mat) for _, ts, mat in app.fbs_initializer.poses]
    traj = app.tracker.track.trajectory(app.tracker.window)
    ate = _ate(traj, gt)
    print(f"{label}: bootstrap done on frame {done_at}, its ATE {_ate(fbs, gt)['rmse']:.9f} m;"
          f" {app.tracker.num_keyframes} keyframes, {len(app.tracker.track.marginalized)}"
          f" marginalized; trajectory of {len(traj)} entries, similarity-aligned ATE RMSE"
          f" {ate['rmse']:.9f} m max {ate['max']:.9f} m ({seconds:.1f} s)", flush=True)
    return ate["rmse"]


def main(argv):
    f64 = "f64" in argv
    dtype = torch.float64 if f64 else torch.float32
    seq = paths.render_path("standart", dtype, "cpu")
    gt = [(float(seq.timestamps[i]), seq.pose(i).matrix().double().numpy())
          for i in range(seq.images.shape[0])]
    with tempfile.TemporaryDirectory(prefix="dsopp_app_reference_") as folder:
        path = paths.write_app_folder(seq, folder, paths.app_config())
        done = []
        t0 = time.perf_counter()
        app = jax_build(jax_load(path), folder, jnp.float64 if f64 else jnp.float32)
        app.run(on_frame=lambda f, r: done.append(f.frame_id)
                if r.get("bootstrap") and r.get("keyframe") else None)
        rmse = _report(f"JAX app ({'f64' if f64 else 'f32'}, CPU)", app, done, gt,
                       time.perf_counter() - t0)
        print(f"the [app] phase's bound: max(1.5 x {rmse:.9f}, {rmse:.9f} + 0.01) ="
              f" {max(1.5 * rmse, rmse + 0.01):.9f} m", flush=True)
        if "jax-only" in argv:
            return 0
        torch.set_num_threads(4)
        done = []
        t0 = time.perf_counter()
        app = loader.build_application(loader.load_config(path), folder, dtype, "cpu")
        app.run(on_frame=lambda f, r: done.append(f.frame_id)
                if r.get("bootstrap") and r.get("keyframe") else None)
        _report(f"port app ({'f64' if f64 else 'f32'}, CPU)", app, done, gt,
                time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
