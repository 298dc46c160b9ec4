"""Readings for the limits of the comparison with the reference, many
seeds in one process (the benchmark's own runs never run this).

    python3 benchmark/control.py --workload <name> --mode <mode> \
        --seeds 1 2 3 [--seconds 2] [--out file.jsonl]

Modes:
  sound     the program as the cell runs it, a short window a seed: the
            lower readings;
  control   the nearest lower precision in the program's place: serving
            cells run the program's own int8 path
            (CenterNetPredictor.quantize, calibrated on the cell's
            calibration images); training cells the reference computed
            with int8 operands and gradients (one scale a tensor) against
            the float32 reference, with no window;
  fp8       (training) the same with float8 operands (e4m3, gradients
            e5m2), which the comparison does not tell from bfloat16;
  half      a fault: the program takes half of each batch (training: the
            step sees the first half of the rows, the mean over them;
            serving: the second half of a batch is answered with zeros);
  altered   a fault (serving): every detection's class moved to the next
            one where the decode produces it;
  nopeak    a fault (serving): the decode without its 3x3 peak test (the
            program's own option, a 1x1 window), so the top-k takes any
            pixel;
  shifted   a fault (serving): the top-k's pixels moved one to the right
            before their boxes are gathered, as a top-k over a map one
            pixel off would;
  witness   (training) the reference with bfloat16 operands in the
            program's place: what bfloat16 alone reads.
Each seed prints one JSON line {seed, mode, numbers, correct}.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def cell_for(name: str, seed: int, seconds: float, device):
    from cnbench import manifest
    from cnbench.common import Cell

    wl = manifest.workload(name)
    return Cell(name=name, config=manifest.config(wl["config"]),
                traffic=manifest.traffic(wl["traffic"]), limits=manifest.limits(name),
                seed=seed, seconds=seconds, trace=False, device=device,
                started=time.perf_counter())


def int8(predictor, calibration):
    return predictor.quantize(calibration)


def half_answers(predictor, calibration):
    gather = predictor.gather_detection2d

    def gather_half(images, **kw):
        out = gather(images, **kw)
        n = out["scores"].shape[0]
        for v in out.values():             # the second half left out: zeros
            v[n // 2:] = 0
        return out
    predictor.gather_detection2d = gather_half
    return predictor


def altered_answers(predictor, calibration):
    detect = predictor.detect

    def detect_altered(images, **kw):
        out = detect(images, **kw)
        classes = predictor.task.num_classes
        return dict(out, labels=(out["labels"] + 1) % classes)
    predictor.detect = detect_altered
    return predictor


def no_peak_test(predictor, calibration):
    gather = predictor.gather_detection2d

    def gather_all_pixels(images, **kw):
        return gather(images, **dict(kw, nms_kernel=1))
    predictor.gather_detection2d = gather_all_pixels
    return predictor


def shifted_pixels():
    """Patch the program's decode so that each detection's box comes from
    the pixel right of the one the top-k picked."""
    from centernet_lightning_torch.ops import decode as decode_ops

    assemble = decode_ops.assemble_detections

    def assemble_shifted(scores, indices, labels, box_offsets, **kw):
        hw = box_offsets.shape[1] * box_offsets.shape[2]
        return assemble(scores, (indices + 1) % hw, labels, box_offsets, **kw)
    decode_ops.assemble_detections = assemble_shifted


def half_batch_steps():
    """Patch the program's make_train_step so that each step takes the
    first half of the batch's rows."""
    import centernet_lightning_torch.train as train_pkg

    make = train_pkg.make_train_step

    def make_half(task, **kw):
        step = make(task, **kw)

        def half(state, batch):
            n = batch["image"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    train_pkg.make_train_step = make_half


def readings(name: str, mode: str, seed: int, seconds: float, device):
    from cnbench import judge
    from cnbench.kinds import train as train_kind
    from cnbench.runner import run
    from cnbench import manifest

    cell = cell_for(name, seed, seconds, device)
    kind = cell.traffic["kind"]
    if kind == "train" and mode == "witness":
        spec, params, images, boxes = train_kind.inputs(cell)
        ref = train_kind.reference_readings(cell, spec, params, images, boxes)
        wit = train_kind.reference_readings(cell, spec, params, images, boxes, lowp="bf16")
        numbers = judge.training_gaps(wit, ref)
        return numbers, judge.verdict(numbers, cell.limits)[0], {"prog": wit, "ref": ref}
    if kind == "train" and mode in ("control", "fp8"):
        lowp = "int8" if mode == "control" else "fp8"
        spec, params, images, boxes = train_kind.inputs(cell)
        ref = train_kind.reference_readings(cell, spec, params, images, boxes)
        ctl = train_kind.reference_readings(cell, spec, params, images, boxes, lowp=lowp)
        numbers = judge.training_gaps(ctl, ref)
        return numbers, judge.verdict(numbers, cell.limits)[0], {"prog": ctl, "ref": ref}
    if kind != "train":
        cell.predictor_hook = {"control": int8, "half": half_answers,
                               "altered": altered_answers, "nopeak": no_peak_test,
                               "shifted": None, "sound": None}[mode]
    result, checks = run(cell, manifest.manifest())
    numbers = dict(result["info"].get("numbers", {}), **{k: c["value"] for k, c in checks.items()})
    return numbers, result["correct"], cell.log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("sound", "control", "fp8", "half", "altered", "nopeak",
                             "shifted", "witness"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--detail", default=None,
                    help="a file for the per-tensor readings of training cells")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    from cnbench.common import free
    if args.mode == "half":
        half_batch_steps()
    if args.mode == "shifted":
        shifted_pixels()
    device = torch.device(args.device)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers, correct, detail = readings(args.workload, args.mode, seed, args.seconds,
                                            device)
        line = json.dumps({"workload": args.workload, "seed": seed, "mode": args.mode,
                           "numbers": numbers, "correct": correct,
                           "seconds": time.perf_counter() - t0})
        if args.detail and detail:
            with open(args.detail, "a") as f:
                f.write(json.dumps({"workload": args.workload, "seed": seed,
                                    "mode": args.mode, **detail}) + "\n")
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
