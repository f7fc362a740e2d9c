"""The odometry application (counterpart of ``dsopp_tpu/app/main.py``):
a config file with ``--config.*`` dot-path overrides → the pipeline, a
frames/s line a frame, then the saved track and, if asked, a TUM
trajectory and the reference-format ``track.bin``.  It runs on the CUDA
card, in f32, unless ``--device cpu`` or ``--float64`` asks otherwise.

Usage::

    python -m dsopp_tpu_torch.app.main --config_file_path mono.json \\
        --output_file_path track.npz [--trajectory_file_path est.tum] \\
        [--track_bin_path track.bin] [--visualization [--visualization_port 8642]] \\
        [--config.tracker.keyframe_strategy.factor=2]

A YAML config needs ``yaml``; a JSON one is read without it.
``--visualization`` serves the live viewer (``output/live_viewer.py``) on
127.0.0.1 while tracking; port 0 picks a free one.  Not ported:
``--host-loop`` (the tracked phase always runs ``PipelinedTracker``), which
the parser refuses with a message that says so.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# flags of the JAX package's app this port refuses, and why
NOT_PORTED = {
    "--host-loop": "the host-driven tracker loop is not ported; the tracked phase always"
                   " runs PipelinedTracker",
}


def _parser():
    parser = argparse.ArgumentParser(description="dsopp_tpu_torch direct odometry")
    parser.add_argument("--config_file_path", required=True)
    parser.add_argument("--output_file_path", default="track.npz")
    parser.add_argument("--track_bin_path", default=None,
                        help="optional reference-format track.bin output")
    parser.add_argument("--trajectory_file_path", default=None,
                        help="optional TUM trajectory output")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--deterministic", action="store_true",
                        help="accepted as the JAX package's app accepts it; the port runs"
                             " on one device")
    parser.add_argument("--visualization", action="store_true",
                        help="serve the live 3D viewer over HTTP on 127.0.0.1 while tracking")
    parser.add_argument("--visualization_port", type=int, default=8642,
                        help="the live viewer's port (0: a free one)")
    parser.add_argument("--refine_calibration", action="store_true",
                        help="optimize the camera calibration over a frame segment and print"
                             " the refined model instead of tracking")
    parser.add_argument("--start_frame", type=int, default=0,
                        help="first frame of the calibration segment")
    parser.add_argument("--frames_number", type=int, default=80,
                        help="number of frames in the calibration segment")
    parser.add_argument("--fix_focal", action="store_true",
                        help="keep the focal length fixed during calibration refinement")
    parser.add_argument("--fix_center", action="store_true",
                        help="keep the principal point fixed during calibration refinement")
    parser.add_argument("--float64", action="store_true", help="run in float64")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = _parser()
    args, unknown = parser.parse_known_args(argv)
    refused = [a for a in unknown if a.split("=", 1)[0] in NOT_PORTED]
    if refused:
        flag = refused[0].split("=", 1)[0]
        parser.error(f"{flag} is not supported by the port: {NOT_PORTED[flag]}")
    overrides = [a for a in unknown if a.startswith("--config.")]
    bad = [a for a in unknown if not a.startswith("--config.")]
    if bad:
        parser.error(f"unknown arguments: {bad}")

    import torch

    from dsopp_tpu_torch.config.loader import apply_overrides, build_application, load_config
    from dsopp_tpu_torch.output.storage import save_track
    from dsopp_tpu_torch.output.tum import export_tum

    config = apply_overrides(load_config(args.config_file_path), overrides)
    base_dir = os.path.dirname(os.path.abspath(args.config_file_path))
    app = build_application(config, base_dir,
                            torch.float64 if args.float64 else torch.float32, args.device)

    if args.refine_calibration:
        return _refine_calibration(app, args)

    viewer = None
    if args.visualization:
        from dsopp_tpu_torch.output.live_viewer import LiveViewer

        viewer = LiveViewer(app.camera.camera_model(), port=args.visualization_port)
        print(f"live viewer: http://localhost:{viewer.port}/", flush=True)

    t0 = time.time()
    frame_times = []

    def on_frame(frame, result):
        frame_times.append(time.time())
        window = frame_times[-50:]
        fps = (len(window) - 1) / max(window[-1] - window[0], 1e-9) if len(window) >= 2 else 0.0
        kind = "KF" if result.get("keyframe") else "  "
        print(f"frame {frame.frame_id} {kind} fps(50)={fps:5.1f}", flush=True)

    try:
        n = app.run(max_frames=args.max_frames, on_frame=on_frame,
                    observers=[viewer] if viewer else None)
    finally:
        if viewer is not None:
            viewer.close()
    app.finish()
    total = time.time() - t0
    print(f"processed {n} frames in {total:.1f}s ({n / max(total, 1e-9):.2f} fps total)")
    if app.sanity_checker is not None and app.sanity_checker.results:
        print(f"sanity violations: {dict(app.sanity_checker.results)}")

    model = app.camera.camera_model()
    camera_info = {"fx": float(model.fx), "fy": float(model.fy),
                   "cx": float(model.cx), "cy": float(model.cy)}
    save_track(args.output_file_path, app.tracker.track, app.tracker.window, camera_info)
    print(f"track written to {args.output_file_path}")
    if args.track_bin_path:
        from dsopp_tpu_torch.output.protobuf_track import save_track_bin

        save_track_bin(args.track_bin_path, app.tracker.track, app.tracker.window,
                       camera=model, model=app.camera.settings.calibration,
                       sanity_results=(app.sanity_checker.results
                                       if app.sanity_checker else None))
        print(f"reference-format track written to {args.track_bin_path}")
    if args.trajectory_file_path:
        export_tum(args.trajectory_file_path, app.tracker.track.trajectory(app.tracker.window))
        print(f"trajectory written to {args.trajectory_file_path}")
    return 0


def _refine_calibration(app, args):
    """Optimize the pinhole calibration over the frames [start_frame,
    start_frame + frames_number) through the bootstrap's geometric BA with
    the intrinsics free, and print the refined model."""
    from dsopp_tpu_torch.fbs.geometric_ba import refine_intrinsics
    from dsopp_tpu_torch.fbs.initializer import InitializerOptions, MonocularInitializer

    model = app.camera.camera_model()
    init = MonocularInitializer(camera=model,
                                options=InitializerOptions(max_frames=max(args.frames_number, 5)))
    n = seen = 0
    while True:
        frame = app._next_frame()
        if frame is None or seen >= args.start_frame + args.frames_number:
            break
        seen += 1
        if seen <= args.start_frame:
            continue
        done = init.process(frame.frame_id, frame.timestamp, frame.image)
        n += 1
        if done:
            break
    if not getattr(init, "calib_data", None):
        print(f"calibration refinement failed: initializer did not converge ({n} frames)")
        return 1
    poses_r, poses_t, pts, obs_f, obs_p, obs_px = init.calib_data
    _, _, _, (fx, fy, cx, cy), rms = refine_intrinsics(
        poses_r, poses_t, pts, obs_f, obs_p, obs_px, model.fx, model.fy, model.cx, model.cy,
        fix_focal=args.fix_focal, fix_center=args.fix_center)
    print(f"refined camera model: pinhole fx={fx:.4f} fy={fy:.4f} "
          f"cx={cx:.4f} cy={cy:.4f} (rms {rms:.3f} px over {n} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
