"""PyTorch port: models with the bounded DCN engines export (cli/export.py),
their kernels kept in the graph as the registered operators
`centernet_lightning::dcn_sample_taps` and `::dcn_fused_conv`, on the CPU.

- Each operator's CPU implementation is its kernel's plain twin (bitwise,
  no launch), and its Meta implementation gives the CPU's shape and dtype
  at odd H, W and C.
- A tiny ResNet-18 FPN model with `dcn_fast_d1` or `dcn_fused_d1` head
  blocks exports: the graph holds the DCN operator and the peak operator,
  and the saved `.pt2`, loaded again, gives the predictor's detections
  bitwise; the JAX package's predictor on the same (converted) weights
  agrees within the tolerances of test_torch_port_dcn_model.py.
- `cli.export` writes such a model from a checkpoint; `--format onnx`
  exits non-zero naming the operator.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu import build_centernet as j_build

from centernet_lightning_torch import build_centernet
from centernet_lightning_torch.cli import export as t_export
from centernet_lightning_torch.models.centernet import CenterNet
from centernet_lightning_torch.ops import dcn as dcn_ops
from centernet_lightning_torch.ops import dcn_fused, dcn_sample
from centernet_lightning_torch.train.checkpoint import save_checkpoint
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import (assert_detections_match, perturb_batch_norm,
                                 perturb_dcn, to_numpy_tree)

BLOCKS = {"dcn_fast_d1": "centernet_lightning.dcn_sample_taps.default",
          "dcn_fused_d1": "centernet_lightning.dcn_fused_conv.default"}
PEAK_OP = "centernet_lightning.peak_class_scores.default"
TOL = dict(rtol=1e-4, atol=1e-4)


def tiny_cfg(block):
    return {"num_classes": 3, "backbone": "resnet18",
            "backbone_config": {"width": 16}, "neck": "FPN",
            "neck_config": {"out_channels": 16},
            "head_config": {"width": 8, "depth": 2, "block": block},
            "num_detections": 20, "image_size": [32, 32]}


def images(seed, n=2, size=32):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def _planes(rng, n, h, w, d):
    off = torch.from_numpy(rng.normal(0, 1.5, (n, h, w, 18)).astype(np.float32))
    mask = torch.sigmoid(torch.from_numpy(
        rng.normal(size=(n, h, w, 9)).astype(np.float32)))
    return dcn_ops.dcn_planes(off, mask, d)


@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (2, 3, 9, 5), (1, 1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("op", ["dcn_sample_taps", "dcn_fused_conv"])
def test_dcn_op_cpu_is_the_twin_and_meta_shapes(op, shape):
    rng = np.random.default_rng(sum(shape))
    n, h, w, c = shape
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    planes = _planes(rng, n, h, w, 1)
    extra = ((torch.from_numpy(rng.normal(size=(9, c, 3)).astype(np.float32)),)
             if op == "dcn_fused_conv" else ())
    twin = (dcn_ops.fused_reference if extra else dcn_ops.tap_sample_reference)
    counter = (dcn_fused.dcn_fused_conv if extra else dcn_sample.dcn_sample_taps)
    before = counter.launches
    got = getattr(torch.ops.centernet_lightning, op)(x, *planes, *extra, 1)
    assert torch.equal(got, twin(x, *planes, *extra, 1))
    assert counter.launches == before
    meta = getattr(torch.ops.centernet_lightning, op)(
        *(t.to("meta") for t in (x, *planes, *extra)), 1)
    assert meta.device.type == "meta"
    assert (meta.shape, meta.dtype) == (got.shape, got.dtype)
    assert got.shape == ((n, h, w, 9, c) if not extra else (n, h, w, 3))


def _pair(block, rng):
    """The JAX predictor with perturbed DCN and BatchNorm variables, and
    the port's predictor on the same weights (utils/convert.py)."""
    cfg = tiny_cfg(block)
    jp = j_build({"model": cfg})
    variables = perturb_dcn(perturb_batch_norm(to_numpy_tree(jp.variables), rng),
                            rng)
    # moderate heatmap logits (scores stay apart) and boxes of the image's
    # scale (a box edge near 0 is then not the difference of two large ones)
    for head, scale in (("heads_heatmap", 0.05), ("heads_box_2d", 0.01)):
        out_conv = variables["params"][head]["out_conv"]
        out_conv["kernel"] = out_conv["kernel"] * scale
    jp.variables = variables
    tp = build_centernet({"model": cfg}, device="cpu")
    tp.model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return jp, tp


@pytest.mark.parametrize("block", list(BLOCKS))
def test_dcn_model_export_roundtrip(tmp_path, block):
    jp, tp = _pair(block, np.random.default_rng(90))
    path = str(tmp_path / "dcn.pt2")
    exported = t_export.export_program(tp, path, batch_size=2, height=32,
                                       width=32)
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    # one operator a DCN head block (two heads of depth 2), one peak stage
    n_blocks = sum(1 for m in tp.model.modules()
                   if type(m).__name__ == "DeformableConvBlock")
    assert n_blocks == 4
    assert targets.count(BLOCKS[block]) == n_blocks
    assert targets.count(PEAK_OP) == 1
    other = BLOCKS["dcn_fast_d1" if block == "dcn_fused_d1" else "dcn_fused_d1"]
    assert other not in targets
    launches = (dcn_sample.dcn_sample_taps.launches,
                dcn_fused.dcn_fused_conv.launches)
    program = torch.export.load(path).module()
    x = images(91)
    with torch.no_grad():
        got = program(torch.from_numpy(x))
    want = tp.detect(x)
    assert set(got) == set(want) == {"boxes", "scores", "labels"}
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (dcn_sample.dcn_sample_taps.launches,
            dcn_fused.dcn_fused_conv.launches) == launches
    # the loaded program against the JAX package's serving path
    ref = jp.gather_detection2d(jnp.asarray(x))
    got_np = {"bboxes": got["boxes"].numpy(), "scores": got["scores"].numpy(),
              "labels": got["labels"].numpy()}
    assert_detections_match(ref, got_np, min_distinct=10, rtol=1e-4, atol=1e-6)
    ref_enc = jp(jnp.asarray(x.astype(np.float32) / 255.0))
    with torch.no_grad():
        got_enc = tp(x.astype(np.float32) / 255.0)
    for key in ("heatmap", "box_2d"):
        np.testing.assert_allclose(got_enc[key].numpy(),
                                   np.asarray(ref_enc[key]), **TOL)


def test_dcn_export_cli_and_onnx_refusal(tmp_path):
    task = CenterNet(**tiny_cfg("dcn_fused_d1"))
    task.init(torch.Generator().manual_seed(4))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, {"model": task.model.state_dict(), "step": 0},
                    hparams=task.hparams, step=0)
    out = str(tmp_path / "dcn.pt2")
    assert t_export.main(["--checkpoint", ckpt, "--output", out, "--height",
                          "32", "--width", "32", "--device", "cpu"]) == 0
    x = images(92, n=1)
    got = torch.export.load(out).module()(torch.from_numpy(x))
    want = build_centernet(ckpt, device="cpu").detect(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    onnx_out = str(tmp_path / "dcn.onnx")
    with pytest.raises(SystemExit, match="centernet_lightning::dcn_fused_conv") as err:
        t_export.main(["--checkpoint", ckpt, "--output", onnx_out, "--format",
                       "onnx", "--height", "32", "--width", "32", "--device",
                       "cpu"])
    assert err.value.code not in (0, None)
    assert not os.path.exists(onnx_out)
    assert t_export.dcn_operators(task.model) == ["centernet_lightning::dcn_fused_conv"]
