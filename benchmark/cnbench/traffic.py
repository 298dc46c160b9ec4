"""Inputs from the seed: image pools and padded box batches. Every seed
gets the same amount of work: the same numbers of images and boxes, and
the same multiset of box counts and size rows, in another order."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def images(seed: int, count: int, height: int, width: int, device) -> torch.Tensor:
    """uint8 (count, H, W, 3) noise images, drawn on `device` and returned
    in pinned host memory (on the CPU, in plain memory)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    dev = torch.randint(0, 256, (count, height, width, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    if torch.device(device).type != "cuda":
        return dev
    host = torch.empty(dev.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(dev)
    return host


def poisson_quantiles(mean: float, count: int) -> np.ndarray:
    """The count quantiles (i + 0.5) / count of Poisson(mean): a fixed
    multiset of draws."""
    from scipy.stats import poisson
    return poisson.ppf((np.arange(count) + 0.5) / count, mean).astype(np.int64)


def box_batches(seed: int, params: Dict, num_classes: int, height: int,
                width: int) -> List[Dict[str, torch.Tensor]]:
    """`pool` batches of `batch` images' padded boxes: counts a Poisson
    (boxes_per_image) multiset shuffled by the seed, at least 1 and at most
    max_boxes; sizes as `box_sizes` says; positions uniform inside the
    image; labels uniform. Boxes xywh float32 in input pixels, labels
    int64, mask float32 (1 on the valid slots)."""
    g = rng(seed, 1)
    n = params["pool"] * params["batch"]
    k = params["max_boxes"]
    counts = np.clip(poisson_quantiles(params["boxes_per_image"], n), 1, k)
    counts = g.permutation(counts)
    w, h = box_sizes(g, params, (n, k))
    w, h = w * width, h * height
    x = g.uniform(0, 1, (n, k)) * (width - w)
    y = g.uniform(0, 1, (n, k)) * (height - h)
    boxes = np.stack([x, y, w, h], -1).astype(np.float32)
    labels = g.integers(0, num_classes, (n, k))
    mask = (np.arange(k)[None, :] < counts[:, None]).astype(np.float32)
    boxes *= mask[..., None]
    labels = labels * mask.astype(np.int64)
    out = []
    for b in range(params["pool"]):
        s = slice(b * params["batch"], (b + 1) * params["batch"])
        out.append({"boxes": torch.from_numpy(boxes[s]),
                    "labels": torch.from_numpy(labels[s]),
                    "mask": torch.from_numpy(mask[s])})
    return out


def box_sizes(g: np.random.Generator, params: Dict, shape) -> tuple:
    """Box sides over the image's, (w, h) each of `shape`. With
    `area_shares` (rows [low, high, share] of the box's area over the
    image's): each row takes its share of the boxes, a fixed multiset
    shuffled by the seed, with areas log-uniform in [low, high) and
    width / height log-uniform in [1 / max_aspect, max_aspect], sides
    clipped to the image. Otherwise each side is log-uniform in
    [min_side, max_side]."""
    if "area_shares" not in params:
        lo, hi = math.log(params["min_side"]), math.log(params["max_side"])
        return np.exp(g.uniform(lo, hi, shape)), np.exp(g.uniform(lo, hi, shape))
    rows = np.asarray(params["area_shares"], dtype=np.float64)
    m = int(np.prod(shape))
    edges = np.cumsum(rows[:, 2]) / rows[:, 2].sum()
    which = g.permutation(np.searchsorted(edges, (np.arange(m) + 0.5) / m))
    lo, hi = np.log(rows[which, 0]), np.log(rows[which, 1])
    area = np.exp(lo + (hi - lo) * g.uniform(0, 1, m))
    a = math.log(params["max_aspect"])
    aspect = np.exp(g.uniform(-a, a, m))
    w = np.minimum(np.sqrt(area * aspect), 1.0)
    h = np.minimum(np.sqrt(area / aspect), 1.0)
    return w.reshape(shape), h.reshape(shape)
