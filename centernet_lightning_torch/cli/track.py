"""Track a folder of frames (port of tools/track.py): writes
MOT-Challenge-format results (and, with `--save-images`, annotated
frames); with `--eval-gt` it also scores HOTA / MOTA / IDF1 against a MOT
ground-truth tree.

    python -m centernet_lightning_torch.cli.track \
        --checkpoint runs/mot17/checkpoints \
        --frames datasets/MOT17/train/MOT17-04/img1 --out /tmp/track04 \
        --eval-gt datasets/MOT17/train --seq MOT17-04 \
        --tracker detection_threshold=0.3

`--quantize N` serves the model in int8, calibrated on the first N
frames. Reading the frames needs OpenCV.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Optional, Sequence

__all__ = ["main"]


def _parse_kv(pairs):
    """KEY=VALUE strings -> dict, each value parsed as JSON when it is."""
    out = {}
    for pair in pairs or []:
        key, _, value = pair.partition("=")
        if not _:
            raise SystemExit(f"--tracker expects key=value, got '{pair}'")
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Track a folder of frames")
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint dir (or yaml config via --config)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--frames", required=True,
                        help="folder of ordered frames (one sequence)")
    parser.add_argument("--out", required=True, help="output folder")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--save-images", action="store_true",
                        help="also write annotated frames")
    parser.add_argument("--tracker", nargs="*", metavar="KEY=VALUE",
                        help="tracker overrides, e.g. detection_threshold=0.3")
    parser.add_argument("--quantize", type=int, default=0, metavar="N",
                        help="serve int8, calibrated on the first N frames")
    parser.add_argument("--eval-gt", default=None,
                        help="MOT GT root (<root>/<seq>/gt/gt.txt) to score "
                             "the results against")
    parser.add_argument("--seq", default=None,
                        help="sequence name inside --eval-gt (default: the "
                             "frames folder's parent directory name)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from ..api import build_centernet

    predictor = build_centernet(
        args.config or args.checkpoint,
        checkpoint=args.checkpoint if args.config else None,
        device=args.device,
    )
    if args.quantize > 0:
        from ..quantize import load_calibration_images

        calib = load_calibration_images(args.frames, args.quantize,
                                        predictor.image_size)
        predictor = predictor.quantize(calib)
        print(f"int8 serving: calibrated on {len(calib)} frames",
              file=sys.stderr)
    out = predictor.inference_tracking(
        args.frames, batch_size=args.batch_size, save_dir=args.out,
        save_results=True, save_images=args.save_images,
        tracker_config=_parse_kv(args.tracker),
    )
    results = os.path.join(args.out, "tracking_results.txt")
    n_tracks = len({t for ids in out["track_ids"] for t in ids})
    summary = {"frames": len(out["track_ids"]), "tracks": n_tracks,
               "results": results}

    if args.eval_gt:
        from ..eval.mot import evaluate_mot_tracking_from_file

        seq = args.seq or os.path.basename(
            os.path.dirname(os.path.abspath(args.frames)))
        trackers_root = os.path.join(args.out, "trackers")
        tdir = os.path.join(trackers_root, "tracker")
        os.makedirs(tdir, exist_ok=True)
        shutil.copy(results, os.path.join(tdir, f"{seq}.txt"))
        seqmap = os.path.join(args.out, "seqmap.txt")
        with open(seqmap, "w") as f:
            f.write(f"{seq}\n")
        metrics = evaluate_mot_tracking_from_file(
            args.eval_gt, trackers_root, trackers_to_eval=["tracker"],
            seqmap_file=seqmap)
        summary.update({k: float(v) for k, v in metrics.items()
                        if isinstance(v, (int, float))})

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
