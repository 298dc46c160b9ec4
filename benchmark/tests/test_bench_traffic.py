"""Inputs repeat for a seed, and every seed gets the same
amount of work."""
import numpy as np
import torch

from cnbench import traffic

PARAMS = {"pool": 3, "batch": 4, "max_boxes": 16, "boxes_per_image": 2.4,
          "min_side": 0.05, "max_side": 0.9}


def test_box_batches_repeat_and_keep_counts():
    a = traffic.box_batches(3, PARAMS, 20, 64, 64)
    b = traffic.box_batches(3, PARAMS, 20, 64, 64)
    c = traffic.box_batches(4, PARAMS, 20, 64, 64)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    count = lambda bs: sorted(int(m.sum()) for bb in bs for m in bb["mask"])
    assert count(a) == count(c)                   # the same multiset of counts
    for bb in a:
        boxes, mask = bb["boxes"], bb["mask"]
        assert boxes.shape == (4, 16, 4) and mask.shape == (4, 16)
        assert torch.all(mask.sum(1) >= 1)
        valid = mask > 0
        assert torch.all(boxes[..., 0][valid] >= 0)
        assert torch.all((boxes[..., 0] + boxes[..., 2])[valid] <= 64 + 1e-4)
        assert torch.all(bb["labels"][valid] < 20)


def test_box_areas_follow_their_shares():
    shares = {"area_shares": [[1e-4, 0.003, 41], [0.003, 0.03, 34], [0.03, 0.81, 24]],
              "max_aspect": 2.0}
    w, h = traffic.box_sizes(np.random.default_rng(0), shares, (50, 40))
    assert w.shape == h.shape == (50, 40)
    assert np.all(w <= 1) and np.all(h <= 1) and np.all(w / h <= 2 + 1e-9)
    area = (w * h).ravel()
    # each row takes its share of the 2,000 boxes, inside its range; the
    # largest boxes may be clipped to the image and lose area, never gain
    expect = [2000 * share / 99 for _, _, share in shares["area_shares"]]
    small = int(((area >= 1e-4 * (1 - 1e-9)) & (area < 0.003)).sum())
    medium = int(((area >= 0.003 * (1 - 1e-9)) & (area < 0.03)).sum())
    assert abs(small - expect[0]) <= 1 and abs(medium - expect[1]) <= 1
    assert int((area >= 0.81).sum()) == 0
    w2, h2 = traffic.box_sizes(np.random.default_rng(1), shares, (50, 40))
    assert int(((w2 * h2) < 0.003).sum()) == small       # the same multiset of rows


def test_images_repeat_for_a_seed():
    a = traffic.images(9, 2, 8, 8, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (2, 8, 8, 3)
    assert torch.equal(a, traffic.images(9, 2, 8, 8, "cpu"))
    assert not torch.equal(a, traffic.images(10, 2, 8, 8, "cpu"))
