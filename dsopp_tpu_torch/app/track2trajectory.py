"""A saved track → a TUM trajectory (counterpart of
``dsopp_tpu/app/track2trajectory.py``): the keyframes, and unless
``--keyframes_only`` the attached frames through their keyframe's pose.

    python -m dsopp_tpu_torch.app.track2trajectory track.npz est.tum
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser()
    parser.add_argument("track", help="path to track .npz")
    parser.add_argument("output", help="TUM trajectory output path")
    parser.add_argument("--keyframes_only", action="store_true")
    args = parser.parse_args(argv)

    from dsopp_tpu_torch.output.storage import load_track
    from dsopp_tpu_torch.output.tum import export_tum

    data = load_track(args.track)
    entries = [(kf["timestamp"], kf["t_wc"]) for kf in data["keyframes"]]
    if not args.keyframes_only:
        by_id = {kf["frame_id"]: kf["t_wc"] for kf in data["keyframes"]}
        for a in data["attached"]:
            t_kf = by_id.get(a["keyframe_id"])
            if t_kf is not None:
                entries.append((a["timestamp"], t_kf @ a["t_keyframe_frame"]))
    entries.sort(key=lambda e: e[0])
    export_tum(args.output, entries)
    print(f"wrote {len(entries)} poses to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
