"""PyTorch port vs the JAX package: box geometry, every loss, the training
targets and `CenterNet.compute_loss`, on the CPU with identical seeded
numpy inputs.

Tolerances: boxes and losses rtol 1e-6 (f32 elementwise; atol 1e-6 near
zero); heatmaps atol 1e-6 (f32 exp); indices and masks exactly; summed
losses rtol 1e-6. Gradients of compute_loss w.r.t. the head outputs rtol
1e-5 / atol 1e-7 (the same elementwise derivatives, summed in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.ops import boxes as j_boxes
from centernet_lightning_tpu.ops import losses as j_losses
from centernet_lightning_tpu.ops import targets as j_targets

from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
from centernet_lightning_torch.ops import boxes as t_boxes
from centernet_lightning_torch.ops import losses as t_losses
from centernet_lightning_torch.ops import targets as t_targets

RTOL = dict(rtol=1e-6, atol=1e-6)


def _xyxy(rng, shape):
    xy = rng.uniform(0, 50, size=shape + (2,))
    wh = rng.uniform(0.5, 30, size=shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or RTOL))


@pytest.mark.parametrize("src,dst", [(s, d) for s in ("xyxy", "xywh", "cxcywh")
                                     for d in ("xyxy", "xywh", "cxcywh")])
def test_convert_box_format(src, dst):
    b = _xyxy(np.random.default_rng(0), (3, 5))
    _close(t_boxes.convert_box_format(torch.from_numpy(b), src, dst),
           j_boxes.convert_box_format(jnp.asarray(b), src, dst))


def test_box_geometry():
    rng = np.random.default_rng(1)
    a, b = _xyxy(rng, (4, 6)), _xyxy(rng, (4, 6))
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _close(t_boxes.area(ta), j_boxes.area(ja))
    for got, ref in zip(t_boxes.box_inter_union(ta, tb),
                        j_boxes.box_inter_union(ja, jb)):
        _close(got, ref)
    _close(t_boxes.box_iou(ta, tb), j_boxes.box_iou(ja, jb))
    for got, ref in zip(t_boxes.enclosing_box(ta, tb), j_boxes.enclosing_box(ja, jb)):
        _close(got, ref)
    with pytest.raises(ValueError):
        t_boxes.convert_box_format(ta, "xyxy", "yxyx")


@pytest.mark.parametrize("name", ["CornerNetFocalLoss", "QualityFocalLoss",
                                  "cornernet_focal", "quality_focal"])
def test_heatmap_losses(name):
    rng = np.random.default_rng(2)
    logits = rng.normal(scale=3, size=(2, 6, 7, 3)).astype(np.float32)
    target = rng.uniform(size=(2, 6, 7, 3)).astype(np.float32)
    target[0, 2, 3, 1] = target[1, 0, 0, 2] = 1.0   # positives
    got = t_losses.get_heatmap_loss(name)(torch.from_numpy(logits),
                                          torch.from_numpy(target))
    ref = j_losses.get_heatmap_loss(name)(jnp.asarray(logits), jnp.asarray(target))
    _close(got, ref)


@pytest.mark.parametrize("name", ["L1Loss", "SmoothL1Loss", "IoULoss",
                                  "GIoULoss", "DIoULoss", "CIoULoss", "giou"])
def test_box_losses(name):
    rng = np.random.default_rng(3)
    pred, target = _xyxy(rng, (2, 9)), _xyxy(rng, (2, 9))
    pred[0, 0] = target[0, 0]                      # a perfect box
    got = t_losses.get_box_loss(name)(torch.from_numpy(pred), torch.from_numpy(target))
    ref = j_losses.get_box_loss(name)(jnp.asarray(pred), jnp.asarray(target))
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_reduce_loss(reduction, weighted):
    rng = np.random.default_rng(4)
    loss = rng.uniform(size=(2, 5, 1)).astype(np.float32)
    w = (rng.uniform(size=(2, 5, 1)) < 0.5).astype(np.float32) if weighted else None
    norm = np.float32(3.0)
    got = t_losses.reduce_loss(torch.from_numpy(loss), reduction,
                               None if w is None else torch.from_numpy(w),
                               torch.tensor(norm))
    ref = j_losses.reduce_loss(jnp.asarray(loss), reduction,
                               None if w is None else jnp.asarray(w), jnp.asarray(norm))
    _close(got, ref)


def _targets(rng, n=2, k=6, size=64):
    """Padded CollateDetection targets: about half the slots valid, some
    centres on half-pixels (round half to even), one box partly off the
    map, and garbage labels on padded slots."""
    xy = rng.uniform(-4, size - 8, size=(n, k, 2))
    wh = rng.uniform(2, 30, size=(n, k, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    boxes[0, 0] = [6.0, 10.0, 4.0, 4.0]             # centre 8, 12 -> /4 = 2, 3
    boxes[0, 1] = [4.0, 4.0, 4.0, 4.0]              # centre 6 / 4 = 1.5 -> 2
    boxes[1, 0] = [16.0, 16.0, 4.0, 4.0]            # centre 18 / 4 = 4.5 -> 4
    labels = rng.integers(0, 3, size=(n, k)).astype(np.int32)
    mask = (rng.uniform(size=(n, k)) < 0.6).astype(np.float32)
    mask[:, :2] = 1.0
    labels[mask == 0] = rng.integers(-5, 20, size=int((mask == 0).sum()))
    return boxes, labels, mask


@pytest.mark.parametrize("radius", [("cornernet", {}), ("ttfnet", {"alpha": 0.54}),
                                    ("fixed", {"r": 2.0})])
def test_render_heatmap(radius):
    name, kw = radius
    boxes, labels, mask = _targets(np.random.default_rng(5))
    args = (3, 16, 16, 4)
    got = t_targets.render_heatmap(torch.from_numpy(boxes), torch.from_numpy(labels),
                                   torch.from_numpy(mask), *args,
                                   t_targets.get_radius_fn(name, **kw))
    valid = mask.astype(bool) & (labels >= 0) & (labels < 3)
    ref = j_targets.render_heatmap(jnp.asarray(boxes), jnp.asarray(np.where(valid, labels, 0)),
                                   jnp.asarray(mask * valid), *args,
                                   j_targets.get_radius_fn(name, **kw))
    assert tuple(got.shape) == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert (got.numpy() == 1.0).sum() >= 2          # the peaks


def test_render_heatmap_padded_labels_never_raise():
    """Padded slots carry any label, in range or not: nothing raises and
    they add nothing; a valid negative label counts from the end, as the
    JAX scatter does."""
    boxes, labels, mask = _targets(np.random.default_rng(6))
    labels[0, 0] = -1
    args = (3, 16, 16, 4)
    fn = t_targets.get_radius_fn("cornernet")
    got = t_targets.render_heatmap(torch.from_numpy(boxes), torch.from_numpy(labels),
                                   torch.from_numpy(mask), *args, fn)
    ref = j_targets.render_heatmap(jnp.asarray(boxes), jnp.asarray(labels),
                                   jnp.asarray(mask), *args,
                                   j_targets.get_radius_fn("cornernet"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    empty = t_targets.render_heatmap(torch.from_numpy(boxes), torch.from_numpy(labels),
                                     torch.zeros_like(torch.from_numpy(mask)), *args, fn)
    assert float(empty.abs().max()) == 0.0


@pytest.mark.parametrize("sample_size", [1, 3, 5])
def test_center_sample_indices(sample_size):
    boxes, _, mask = _targets(np.random.default_rng(7))
    got = t_targets.center_sample_indices(torch.from_numpy(boxes), torch.from_numpy(mask),
                                          16, 16, 4, sample_size)
    ref = j_targets.center_sample_indices(jnp.asarray(boxes), jnp.asarray(mask),
                                          16, 16, 4, sample_size)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    with pytest.raises(ValueError):
        t_targets.center_sample_indices(torch.from_numpy(boxes),
                                        torch.from_numpy(mask), 16, 16, 4, 2)


@pytest.mark.parametrize("cfg", [
    {"box_loss": "L1Loss"},
    {"box_loss": "GIoULoss", "box_log": True, "box_multiplier": 4.0,
     "box_loss_weight": 5.0},
    {"heatmap_loss": "QualityFocalLoss", "heatmap_target": "ttfnet",
     "box_loss": "CIoULoss", "box_log": True, "center_sampling_size": 1},
], ids=["l1", "giou_log", "qfl_ttfnet_ciou"])
def test_compute_loss_matches_jax(cfg):
    """The whole loss, and its gradient w.r.t. the head outputs, on the
    same outputs and targets (no model involved)."""
    kw = dict(num_classes=3, backbone="resnet18", neck_config={"out_channels": 8},
              head_config={"width": 8, "depth": 1}, **cfg)
    jtask, ttask = JCenterNet(**kw), TCenterNet(**kw)
    rng = np.random.default_rng(8)
    boxes, labels, mask = _targets(rng)
    labels = np.where(mask > 0, labels, 0).astype(np.int32)
    heat = rng.normal(scale=2, size=(2, 16, 16, 3)).astype(np.float32)
    box = rng.normal(scale=0.5, size=(2, 16, 16, 4)).astype(np.float32)
    if not cfg.get("box_log"):
        box = np.abs(box) * 4
    targets = {"boxes": boxes, "labels": labels, "mask": mask}

    def jloss(h, b):
        out = jtask.compute_loss({"heatmap": h, "box_2d": b},
                                 {k: jnp.asarray(v) for k, v in targets.items()})
        return out["total"], out

    (_, ref), (jgh, jgb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(heat), jnp.asarray(box))
    th = torch.from_numpy(heat).requires_grad_()
    tb = torch.from_numpy(box).requires_grad_()
    got = ttask.compute_loss({"heatmap": th, "box_2d": tb},
                             {k: torch.from_numpy(v) for k, v in targets.items()})
    for key in ("heatmap", "box_2d", "total"):
        np.testing.assert_allclose(float(got[key].detach()), float(ref[key]), rtol=1e-6)
    got["total"].backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), rtol=1e-5, atol=1e-7)


def test_box_intersection_clamp_tie_gradient():
    """At exactly 0 the intersection's clip (JAX boxes.py:74) passes half
    the gradient in the JAX package; the port matches (torch.maximum, not
    clamp)."""
    rng = np.random.default_rng(8)
    a = _xyxy(rng, (6,))
    b = a.copy()
    b[:3, 0] = a[:3, 2]                 # touching: x2 - x1 == 0 exactly
    b[3:, 1] = a[3:, 3]                 # y2 - y1 == 0 exactly

    def j(x, y):
        inter, union = j_boxes.box_inter_union(x, y)
        return jnp.sum(inter * 1.5 + union)

    ref = jax.grad(j, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (a, b)]
    inter, union = t_boxes.box_inter_union(*leaves)
    (inter * 1.5 + union).sum().backward()
    for leaf, r in zip(leaves, ref):
        _close(leaf.grad, r, rtol=1e-6, atol=1e-7)


def test_quality_focal_loss_zero_logit_gradient():
    """At a logit of exactly 0 the quality focal loss takes JAX's
    subgradients (JAX losses.py:100): half through `jnp.maximum(x, 0)` and
    the x >= 0 side of `jnp.abs`; elsewhere the same gradient."""
    rng = np.random.default_rng(9)
    logits = rng.normal(scale=2, size=(2, 5, 6, 2)).astype(np.float32)
    logits[0, 1, :, 0] = 0.0
    logits[1, :, 2, 1] = 0.0
    target = rng.uniform(size=logits.shape).astype(np.float32)
    weights = rng.normal(size=logits.shape).astype(np.float32)

    ref = np.asarray(jax.grad(lambda x: jnp.sum(
        j_losses.quality_focal_loss(x, jnp.asarray(target)) * weights))(
            jnp.asarray(logits)))
    t = torch.from_numpy(logits).requires_grad_()
    (t_losses.quality_focal_loss(t, torch.from_numpy(target))
     * torch.from_numpy(weights)).sum().backward()
    _close(t.grad, ref, rtol=1e-6, atol=1e-7)
    # the tie passes a gradient the clamp/abs form would not: at x = 0 the
    # BCE term's derivative is 0.5 - t - 0.5 (half the max, the abs's +1
    # through log1p(exp(-x)) at -0.5) = -t, where clamp gives 0.5 - t
    tie = logits == 0
    assert tie.sum() >= 10
    probs = 0.5
    mod = np.abs(target - probs) ** 2
    bce_grad = -target
    dmod = 2 * (probs - target) * 0.25 * np.log(2.0)   # d|t - p|^2 * ce at 0
    np.testing.assert_allclose(ref[tie], ((mod * bce_grad + dmod) * weights)[tie],
                               rtol=1e-5, atol=1e-6)
