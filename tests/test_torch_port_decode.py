"""PyTorch port vs the JAX package: the peak kernel's plain twin and the
decode, on the CPU.

The plain twin `peak_class_scores_reference` must equal the Pallas kernel
`peak_class_scores_pallas` (interpret mode, both layouts) and the plain
`ops/decode.py:peak_class_scores` EXACTLY: a max selects an input value,
so there is no rounding to excuse. That holds for maps with NaNs too: a
NaN in a class's 3x3 window gives that class the neutral (0, or -1e30 for
logits), in the JAX package and in both of the port's plain paths. The CUDA kernel itself is held against
the same twin on the card by chip_smoke.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.ops import decode as J
from centernet_lightning_tpu.ops import pallas_decode as JP

from centernet_lightning_torch.ops import decode as T
from centernet_lightning_torch.ops import peak_decode as TP

from _torch_port_helpers import assert_detections_match


def _maps(kind, shape, from_logits, rng):
    """Heatmaps that exercise ties and edges, as f32 numpy."""
    n, h, w, c = shape
    draw = (lambda s: rng.normal(0, 3, s)) if from_logits else \
        (lambda s: rng.uniform(0, 1, s))
    if kind == "random":
        x = draw(shape)
    elif kind == "constant":              # every pixel a tied plateau peak
        x = np.full(shape, 0.25)
    elif kind == "equal_classes":         # every class ties: label must be 0
        x = np.repeat(draw((n, h, w, 1)), c, axis=3)
    elif kind == "edge_ties":             # equal neighbours along the border
        x = draw(shape)
        x[:, 0, :, :] = x[:, 0, :1, :]
        x[:, :, -1, :] = x[:, :1, -1, :]
        x[:, -1, :2, :] = x[:, -1, -1:, :]
    elif kind == "nan":                   # NaNs inside, at a corner, on a border
        x = draw(shape)
        x[:, h // 2, w // 2, ::2] = np.nan
        x[:, 0, 0, :] = np.nan
        x[:, -1, 1:-1, c // 2] = np.nan
        x[:, 1:-1, 0, -1] = np.nan
    else:                                 # coarse levels: many tied values
        x = np.round(draw(shape) * 4) / 4
    return x.astype(np.float32)


CASES = [
    ("random", (2, 9, 13, 5)), ("random", (1, 16, 16, 33)),
    ("constant", (1, 6, 7, 4)), ("equal_classes", (2, 8, 8, 7)),
    ("edge_ties", (1, 7, 9, 3)), ("quantized", (2, 10, 12, 6)),
    ("nan", (2, 9, 13, 5)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("from_logits", [False, True], ids=["probs", "logits"])
@pytest.mark.parametrize("kind,shape", CASES, ids=[c[0] for c in CASES])
def test_peak_reference_equals_pallas_and_plain(kind, shape, from_logits, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_maps(kind, shape, from_logits, rng)).to(
        getattr(torch, dtype))
    x32 = x.float().numpy()               # the exact values both sides see
    jx = jnp.asarray(x32).astype(getattr(jnp, dtype))
    got_s, got_l = TP.peak_class_scores_reference(x, from_logits=from_logits)
    assert got_s.dtype == torch.float32 and got_l.dtype == torch.int32
    got_s, got_l = got_s.numpy(), got_l.numpy()

    refs = [JP.peak_class_scores_pallas(jx, from_logits=from_logits,
                                        interpret=True, layout=layout)
            for layout in ("nchw", "nhwc")]
    refs.append(J.peak_class_scores(jnp.asarray(x32), from_logits=from_logits))
    for ref_s, ref_l in refs:
        np.testing.assert_array_equal(got_s, np.asarray(ref_s, np.float32))
        np.testing.assert_array_equal(got_l, np.asarray(ref_l))


@pytest.mark.parametrize("from_logits", [False, True], ids=["probs", "logits"])
def test_port_plain_peak_equals_twin(from_logits):
    """The port's two plain paths (decode.py's -inf-padded pool, and the
    kernel's twin with neutral edges) agree exactly."""
    x = torch.from_numpy(_maps("quantized", (2, 11, 9, 6), from_logits,
                               np.random.default_rng(1)))
    a = T.peak_class_scores(x, from_logits=from_logits)
    b = TP.peak_class_scores_reference(x, from_logits=from_logits)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("from_logits", [False, True], ids=["probs", "logits"])
def test_port_plain_peak_equals_jax_on_nan_maps(from_logits, dtype):
    """The port's plain decode (ops/decode.py) on maps with NaNs: a NaN
    pixel, or a pixel whose window holds a NaN, scores the neutral with the
    JAX package's label (jnp.argmax's first index)."""
    x = torch.from_numpy(_maps("nan", (2, 9, 13, 5), from_logits,
                               np.random.default_rng(4))).to(getattr(torch, dtype))
    x32 = x.float().numpy()
    got_s, got_l = T.peak_class_scores(x.float(), from_logits=from_logits)
    ref_s, ref_l = J.peak_class_scores(jnp.asarray(x32), from_logits=from_logits)
    assert not torch.isnan(got_s).any()
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s, np.float32))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    # the labels are scores.max's first index, as jnp.argmax's
    heat = torch.from_numpy(x32)
    pooled = torch.nn.functional.max_pool2d(
        heat.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    neutral = T.NEG_BIG if from_logits else 0.0
    masked = torch.where(pooled == heat, heat, torch.tensor(neutral))
    np.testing.assert_array_equal(
        got_l.numpy(), masked.max(dim=-1).indices.reshape(2, -1).numpy())


def test_peak_wrapper_on_cpu_runs_the_twin_without_counting():
    x = torch.rand(1, 5, 6, 3, generator=torch.Generator().manual_seed(0))
    before = TP.peak_class_scores_cuda.launches
    s, l = TP.peak_class_scores_cuda(x)
    rs, rl = TP.peak_class_scores_reference(x)
    assert torch.equal(s, rs) and torch.equal(l, rl)
    assert TP.peak_class_scores_cuda.launches == before


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(4, 4, 3), ValueError),
    (torch.zeros(1, 4, 4, 3, dtype=torch.float16), TypeError),
])
def test_peak_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        TP.peak_class_scores_cuda(bad)


DECODE_CASES = {
    "plain": dict(),
    "box_log_multiplier": dict(box_log=True, box_multiplier=16.0),
    "normalize": dict(normalize_boxes=True),
    "k_above_hw": dict(num_detections=500),
    "logits": dict(from_logits=True),
    "stride8_bf16box": dict(stride=8, box_multiplier=2.0),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_parity(name):
    kw = {"num_detections": 40, **DECODE_CASES[name]}
    rng = np.random.default_rng(2)
    logits = kw.get("from_logits", False)
    heat = rng.normal(0, 3, (2, 16, 18, 5)) if logits else \
        rng.uniform(0, 1, (2, 16, 18, 5))
    heat = heat.astype(np.float32)
    box = rng.normal(size=(2, 16, 18, 4)).astype(np.float32)
    tbox = torch.from_numpy(box)
    if name == "stride8_bf16box":
        tbox = tbox.to(torch.bfloat16)
        box = tbox.float().numpy()
    ref = J.decode_detections(jnp.asarray(heat), jnp.asarray(box), **kw)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = T.decode_detections(torch.from_numpy(heat), tbox, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    assert got["scores"].dtype == np.float32 and got["boxes"].dtype == np.float32
    assert got["labels"].dtype == np.int32
    assert got["scores"].shape == ref["scores"].shape
    assert_detections_match(ref, got, min_distinct=10)

    fused = TP.decode_detections_fused(torch.from_numpy(heat), tbox, **kw)
    pallas = JP.decode_detections_pallas(jnp.asarray(heat), jnp.asarray(box),
                                         interpret=True, layout="nhwc", **kw)
    assert_detections_match({k: np.asarray(v) for k, v in pallas.items()},
                            {k: v.numpy() for k, v in fused.items()},
                            min_distinct=10)


def test_decode_golden():
    data = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                "decode_golden.npz"))
    got = T.decode_detections(
        torch.from_numpy(data["heatmap"]), torch.from_numpy(data["box"]),
        num_detections=25, box_log=True, box_multiplier=16.0, stride=4)
    assert_detections_match(
        {"scores": data["scores"], "labels": data["labels"],
         "boxes": data["boxes"]},
        {k: v.numpy() for k, v in got.items()}, rtol=1e-6, atol=1e-7,
        min_distinct=40)


def test_topk_tie_convention():
    """The port's documented convention (ops/decode.py): sorted scores
    equal the reference's; tied scores may come in any index order, but
    each returned (index, label, score) is a real entry of the peak map."""
    heat = np.zeros((1, 6, 6, 2), np.float32)
    heat[0, ::3, ::3, 1] = 0.5            # four tied isolated peaks
    heat[0, 4, 4, 0] = 0.9
    ref = J.decode_detections(jnp.asarray(heat), jnp.zeros((1, 6, 6, 4)),
                              num_detections=8)
    got = T.get_topk_from_heatmap(torch.from_numpy(heat), num_detections=8)
    scores, idx, labels = (t.numpy()[0] for t in got)
    np.testing.assert_array_equal(scores, np.asarray(ref["scores"])[0])
    np.testing.assert_array_equal(labels[:5], [0, 1, 1, 1, 1])
    assert idx[0] == 4 * 6 + 4
    assert sorted(idx[1:5]) == [0, 3, 18, 21]     # the tied set, any order
    flat_scores, flat_labels = T.peak_class_scores(torch.from_numpy(heat))
    np.testing.assert_array_equal(flat_scores.numpy()[0][idx], scores)
    np.testing.assert_array_equal(flat_labels.numpy()[0][idx], labels)


def test_decode_auto_takes_plain_path_on_cpu():
    heat = torch.rand(1, 8, 8, 3, generator=torch.Generator().manual_seed(3))
    box = torch.rand(1, 8, 8, 4, generator=torch.Generator().manual_seed(4))
    before = TP.peak_class_scores_cuda.launches
    a = T.decode_detections_auto(heat, box, num_detections=10)
    b = T.decode_detections(heat, box, num_detections=10)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert TP.peak_class_scores_cuda.launches == before
    # pseudo_nms=False reaches the plain decoder (no suppression)
    c = T.decode_detections_auto(heat, box, num_detections=64, pseudo_nms=False)
    ref = J.decode_detections(jnp.asarray(heat.numpy()), jnp.asarray(box.numpy()),
                              num_detections=64, pseudo_nms=False)
    np.testing.assert_array_equal(c["scores"].numpy(), np.asarray(ref["scores"]))


def test_gather_at_indices_parity():
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    idx = rng.integers(0, 30, size=(2, 7)).astype(np.int32)
    ref = np.asarray(J.gather_at_indices(jnp.asarray(feat), jnp.asarray(idx)))
    got = T.gather_at_indices(torch.from_numpy(feat), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fused_decode_widens_fp16_maps():
    """An fp16 heatmap (fp16 serving) goes through the fused decode: it is
    widened to f32 for the kernel, as the JAX package's Pallas wrapper
    widens maps narrower than f32; the wrapper itself still refuses fp16."""
    rng = np.random.default_rng(6)
    heat = torch.from_numpy(rng.normal(0, 3, (2, 12, 14, 5)).astype(np.float32)).half()
    box = torch.from_numpy(rng.normal(size=(2, 12, 14, 4)).astype(np.float32)).half()
    kw = dict(num_detections=30, from_logits=True, box_log=True,
              box_multiplier=4.0)
    got = TP.decode_detections_fused(heat, box, **kw)
    ref = J.decode_detections(jnp.asarray(heat.float().numpy()),
                              jnp.asarray(box.float().numpy()), **kw)
    assert got["scores"].dtype == torch.float32
    assert_detections_match({k: np.asarray(v) for k, v in ref.items()},
                            {k: v.numpy() for k, v in got.items()},
                            min_distinct=10)


def test_box_decode_clamp_tie_gradient():
    """At an offset of exactly 0 the decode's clamp passes half the
    gradient, as jnp.clip does (ops/decode.py, JAX decode.py:144)."""
    box = np.zeros((1, 2, 3, 4), np.float32)
    box[0, 0, 1] = [0.5, -1.0, 2.0, 0.0]
    idx = np.array([[0, 1, 4]], np.int32)
    weights = np.random.default_rng(7).normal(size=(1, 3, 4)).astype(np.float32)

    def jf(b):
        return jnp.sum(J.gather_and_decode_boxes(b, jnp.asarray(idx),
                                                 box_multiplier=2.0) * weights)

    ref = np.asarray(jax.grad(jf)(jnp.asarray(box)))
    tb = torch.from_numpy(box).requires_grad_()
    (T.gather_and_decode_boxes(tb, torch.from_numpy(idx), box_multiplier=2.0)
     * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(tb.grad.numpy(), ref, rtol=1e-6, atol=0)
    # y2 = (cy + 2 * offset) * 4 at the tie offset 0: half of 8 * weight
    np.testing.assert_allclose(ref[0, 0, 1, 3], 0.5 * 8 * weights[0, 1, 3],
                               rtol=1e-6)
