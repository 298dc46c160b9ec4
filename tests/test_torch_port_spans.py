"""PyTorch port: the named ranges of utils/spans.py, on the CPU with tiny
models. Without a profiler a span is one shared null context. Under
`torch.profiler.profile(activities=[CPU])`: one `gather_detection2d` call
records `api.call` and inside it, in order, `api.prepare`, `api.forward`,
`api.decode` and `api.to_host`; one train step records `train.step` and
its five phases; a DCN model's backward records one `dcn.recompute` for
each sampling (or fused) op, inside `train.backward`; the int8 conv's
ranges keep their names `int8_conv.<stage>`. Every span is an op of the
profiler's (`cpu_op`), never a user annotation, so a CUDA trace gets no
copy of it on the device's timeline.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from centernet_lightning_torch import build_centernet
from centernet_lightning_torch.models.centernet import CenterNet
from centernet_lightning_torch.models.layers import DeformableConvBlock
from centernet_lightning_torch.train import optim as t_optim
from centernet_lightning_torch.train import state as t_state
from centernet_lightning_torch.utils import spans

from _torch_port_helpers import TRAIN_CFG, detection_batch

PREFIXES = ("api.", "train.", "dcn.", "int8_conv.")
TINY = {"num_classes": 3, "backbone": "resnet18", "backbone_config": {"width": 16},
        "neck": "FPN", "neck_config": {"out_channels": 16},
        "head_config": {"width": 16, "depth": 1}, "num_detections": 20}
API = ["api.prepare", "api.forward", "api.decode", "api.to_host"]
TRAIN = ["train.cast", "train.forward", "train.loss", "train.backward",
         "train.optimizer"]


def recorded(fn):
    """The spans `fn()` records under a CPU profiler: [(name, start_ns,
    end_ns, thread)] in order of start, after checking that each is an op
    and not a user annotation."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIXES):
            assert not e.is_user_annotation() and e.activity_type() == "cpu_op", e.name()
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.start_thread_id()))
    return sorted(out, key=lambda s: s[1])


def children(got, parent):
    """The spans directly inside the one span named `parent`, in order."""
    (_, p0, p1, thread), = [s for s in got if s[0] == parent]
    inside = [s for s in got if s[0] != parent and p0 <= s[1] and s[2] <= p1
              and s[3] == thread]
    return [s[0] for s in inside
            if not any(o is not s and o[1] <= s[1] and s[2] <= o[2]
                       for o in inside)]


def test_span_without_profiler_is_one_null_context():
    assert not torch.autograd._profiler_enabled()
    ctx = spans.span("train.step")
    assert isinstance(ctx, contextlib.nullcontext)
    assert spans.span("api.call") is ctx
    with ctx:
        pass
    # a span opened and closed before the profiler starts leaves nothing
    with spans.span("api.call"):
        pass
    assert recorded(lambda: torch.ones(2) + 1) == []


def _serve():
    pred = build_centernet({"model": dict(TINY, image_size=[64, 64])}, seed=0,
                           device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    pred.gather_detection2d(images)
    return lambda: pred.gather_detection2d(images)


def _train(dtype, conv_type="normal"):
    cfg = dict(TRAIN_CFG, neck_config=dict(TRAIN_CFG["neck_config"],
                                           conv_type=conv_type))
    task = CenterNet(**cfg)
    task.init(torch.Generator().manual_seed(0))
    model = task.model.to(memory_format=torch.channels_last)
    state = t_state.TrainState(model=model, tx=t_optim.make_optimizer(
        model, optimizer="AdamW", lr=1e-4, max_epochs=1, steps_per_epoch=1))
    step = t_state.make_train_step(task, compute_dtype=dtype)
    batch = {k: torch.from_numpy(v)
             for k, v in detection_batch(np.random.default_rng(1)).items()}
    return model, lambda: step(state, batch)


@pytest.mark.parametrize("case", ["serve", "train_f32", "train_bf16"])
def test_spans_nest_in_order(case):
    if case == "serve":
        parent, expected, fn = "api.call", API, _serve()
    else:
        _, fn = _train("bfloat16" if case == "train_bf16" else None)
        parent, expected = "train.step", TRAIN
    got = recorded(fn)
    assert sorted(s[0] for s in got) == sorted([parent] + expected)
    assert children(got, parent) == expected


@pytest.mark.parametrize("conv_type", ["dcn_fast_d1", "dcn_fast", "dcn_fused_d1"])
def test_dcn_backward_records_one_recompute_each_sampling_op(conv_type):
    model, fn = _train(None, conv_type)
    blocks = sum(isinstance(m, DeformableConvBlock) for m in model.modules())
    assert blocks > 0
    got = recorded(fn)
    assert children(got, "train.step") == TRAIN
    assert children(got, "train.backward") == ["dcn.recompute"] * blocks
    assert children(got, "train.forward") == []


def test_int8_conv_ranges_keep_their_names():
    pred = build_centernet({"model": dict(TINY, image_size=[64, 64])}, seed=0,
                           device="cpu")
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    qpred = pred.quantize([images])
    got = recorded(lambda: qpred.gather_detection2d(images))
    stages = {s[0] for s in got if s[0].startswith("int8_conv.")}
    assert "int8_conv.quantize" in stages
    assert stages <= {f"int8_conv.{n}" for n in ("quantize", "im2col", "int_mm", "dequant")}
    assert children(got, "api.call") == API
    (_, f0, f1, _), = [s for s in got if s[0] == "api.forward"]
    assert all(f0 <= s[1] and s[2] <= f1 for s in got if s[0].startswith("int8_conv."))
