"""Export a model for serving with the decode in the graph (port of
tools/export.py).

The serving program (uint8 NHWC images -> preprocess -> forward -> decode
-> {boxes, scores, labels [, embeddings]}) is traced at a fixed input
shape with `torch.export` and saved as a `.pt2` (`torch.export.save`),
the port's counterpart of the JAX package's StableHLO and SavedModel
artifacts. The peak stage is the custom op
`torch.ops.centernet_lightning.peak_class_scores`, and the bounded DCN
engines are `centernet_lightning::dcn_sample_taps` and
`centernet_lightning::dcn_fused_conv` (ops/_library.py), so a program
exported on the card runs the hand-written kernels when it is loaded
again; loading needs `import centernet_lightning_torch` first, which
registers the ops:

    import centernet_lightning_torch, torch
    program = torch.export.load("model.pt2").module()
    dets = program(images_uint8)                  # on the export's device

    python -m centernet_lightning_torch.cli.export \
        --checkpoint runs/coco/checkpoints --output model.pt2 \
        [--batch-size 8] [--quantize-calibrate photos/] [--format onnx]

`--quantize-calibrate DIR` exports the int8 program (its int8 weights
and scales ride in the file). `--format onnx` needs the `onnx` package,
and refuses a model with a bounded DCN engine, naming its operator, which
has no ONNX form.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Sequence

import torch
from torch import nn

__all__ = ["ServingProgram", "make_serving_fn", "export_program",
           "export_onnx", "dcn_operators", "main"]


class ServingProgram(nn.Module):
    """The predictor's serving computation as one module: what
    `predictor.detect(images)` runs on a uint8 batch already on the device
    (preprocessed with the predictor's mean and std, the decode from
    logits, boxes in input pixels, the task's k and NMS window).
    `plain_decode` decodes with the plain ops only (no peak op)."""

    def __init__(self, predictor, plain_decode: bool = False):
        super().__init__()
        self.plain_decode = plain_decode
        self.model = predictor.model
        self.task = predictor.task
        self.dtype = predictor.compute_dtype or torch.float32
        self.register_buffer("mean", predictor._norm[0].clone())
        self.register_buffer("std", predictor._norm[1].clone())

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        from ..ops.decode import decode_detections
        from ..ops.peak_decode import decode_detections_fused
        from ..ops.preprocess import preprocess

        out = self.model(preprocess(images, mean=self.mean, std=self.std,
                                    dtype=self.dtype))
        task = self.task
        # the peak op on every device (the kernel on the card, its twin on
        # the CPU); the fused decode sends other NMS windows to the plain one
        decode = decode_detections if self.plain_decode else decode_detections_fused
        return decode(out["heatmap"], out["box_2d"], reid=out.get("reid"),
                      num_detections=task.num_detections,
                      nms_kernel=task.nms_kernel, box_log=task.box_log,
                      box_multiplier=task.box_multiplier, stride=task.stride,
                      from_logits=True)


def dcn_operators(model: nn.Module) -> list:
    """The registered DCN operators the model's bounded DCN blocks call,
    sorted (empty for a model without them)."""
    from ..models.layers import DeformableConvBlock

    names = {"centernet_lightning::" + ("dcn_fused_conv"
                                        if m.sampler == "fused"
                                        else "dcn_sample_taps")
             for m in model.modules()
             if isinstance(m, DeformableConvBlock)
             and m.max_displacement is not None}
    return sorted(names)


def make_serving_fn(predictor, batch_size: int, height: int, width: int,
                    plain_decode: bool = False):
    """(ServingProgram, an example uint8 input on the predictor's device)."""
    example = torch.zeros((batch_size, height, width, 3), dtype=torch.uint8,
                          device=predictor.device)
    return ServingProgram(predictor, plain_decode).eval(), example


def export_program(predictor, output: str, batch_size: int = 1,
                   height: int = 512, width: int = 512):
    """Trace the serving program with `torch.export` and save it to
    `output` (.pt2). Returns the ExportedProgram."""
    program, example = make_serving_fn(predictor, batch_size, height, width)
    with torch.no_grad():
        exported = torch.export.export(program, (example,))
    torch.export.save(exported, output)
    print(f"wrote torch.export program ({os.path.getsize(output)} bytes, "
          f"input {tuple(example.shape)} uint8 on {example.device}) -> {output}")
    return exported


def export_onnx(predictor, output: str, batch_size: int = 1,
                height: int = 512, width: int = 512, opset: int = 17):
    """ONNX, where the `onnx` package imports; otherwise exits non-zero
    naming it. The peak op has no ONNX form, so the graph decodes with the
    plain ops (ops/decode.py), which compute the same; the DCN operators
    have no plain form that is the same program, so a model with one
    exits non-zero naming it."""
    ops = dcn_operators(predictor.model)
    if ops:
        raise SystemExit(f"--format onnx cannot carry the operator(s) "
                         f"{', '.join(ops)} of this model's bounded DCN "
                         f"blocks; export --format pt2 instead")
    try:
        import onnx  # noqa: F401
    except ImportError:
        raise SystemExit("--format onnx needs the onnx package, which is not "
                         "installed here; export --format pt2 instead") from None
    program, example = make_serving_fn(predictor, batch_size, height, width,
                                       plain_decode=True)
    torch.onnx.export(program, (example,), output, opset_version=opset,
                      input_names=["images"])
    print(f"wrote ONNX (opset {opset}) -> {output}")
    return output


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Export CenterNet for serving")
    parser.add_argument("--config", help="model yaml (or use --checkpoint dir)")
    parser.add_argument("--checkpoint", help="checkpoint dir to load")
    parser.add_argument("--torch-ckpt",
                        help="reference Lightning .ckpt/.pth to export "
                             "directly (requires --config)")
    parser.add_argument("--output", required=True)
    parser.add_argument("--format", choices=["pt2", "onnx"], default="pt2")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--opset", type=int, default=17, help="ONNX opset")
    parser.add_argument("--quantize-calibrate", metavar="IMG_DIR",
                        help="export the int8 serving program, calibrated on "
                             "images from this folder")
    parser.add_argument("--quantize-images", type=int, default=32,
                        help="most calibration images read from the folder")
    parser.add_argument("--device", default="cuda",
                        help="torch device to trace on (default: cuda)")
    args = parser.parse_args(argv)

    if args.torch_ckpt and not args.config:
        parser.error("--torch-ckpt requires --config (the torch state dict "
                     "carries no hparams)")
    if args.torch_ckpt and args.checkpoint:
        parser.error("--torch-ckpt and --checkpoint are mutually exclusive "
                     "weight sources")
    if not (args.config or args.checkpoint):
        parser.error("one of --config / --checkpoint is required")

    from ..api import build_centernet

    predictor = build_centernet(
        args.config or args.checkpoint,
        checkpoint=args.checkpoint if args.config else None,
        torch_ckpt=args.torch_ckpt, device=args.device)
    if args.quantize_calibrate:
        import numpy as np

        from ..data.inference import InferenceDataset

        ds = InferenceDataset(args.quantize_calibrate,
                              resize=(args.height, args.width))
        n = min(len(ds), args.quantize_images)
        if n == 0:
            parser.error(f"no images found in {args.quantize_calibrate}")
        batch = np.stack([ds[i]["image"] for i in range(n)]).astype(np.uint8)
        predictor = predictor.quantize(batch)
        print(f"int8: calibrated on {n} images from {args.quantize_calibrate}",
              file=sys.stderr)
    export = export_onnx if args.format == "onnx" else export_program
    kwargs = {"opset": args.opset} if args.format == "onnx" else {}
    export(predictor, args.output, args.batch_size, args.height, args.width,
           **kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
