"""Host-side image/box augmentation pipeline (numpy + cv2; a copy of the
JAX package's data/transforms.py, with OpenCV imported only inside the
functions that resize, warp, blur or convert an image, so the module loads
without it).

Replaces the reference's albumentations dependency (not available here;
reference datasets/coco.py:103-113 resolves transforms by name from
A.__dict__). Transform names and init args mirror albumentations so the
reference YAML configs work unchanged (configs/centernet.yaml:39-85).

Samples are dicts: {"image": HWC uint8 (float32 after Normalize),
"bboxes": (K, 4) float32 xywh in pixels, "labels": (K,) int64,
optionally "ids": (K,) int64}. Box filtering after geometric ops follows the
reference: clip to image, drop boxes with a side <= 1 px or area < min_area
(reference datasets/coco.py:18-25, 60-67; bbox_params min_area=1,
coco.py:111).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

__all__ = [
    "Compose", "Resize", "SmallestMaxSize", "LongestMaxSize", "RandomCrop",
    "CenterCrop", "RandomResizedCrop", "PadIfNeeded", "HorizontalFlip",
    "VerticalFlip", "ColorJitter", "Normalize", "Cutout", "MotionBlur",
    "Affine", "TrivialAugmentWide", "TRANSFORMS", "build_transforms",
]


def _resize(sample, new_h, new_w, interpolation=None):
    """interpolation: a cv2 flag, cv2.INTER_LINEAR when None."""
    img = sample["image"]
    h, w = img.shape[:2]
    if (h, w) == (new_h, new_w):
        return sample
    import cv2

    if interpolation is None:
        interpolation = cv2.INTER_LINEAR
    sample["image"] = cv2.resize(img, (new_w, new_h), interpolation=interpolation)
    if len(sample.get("bboxes", ())):
        s = np.array([new_w / w, new_h / h, new_w / w, new_h / h], np.float32)
        sample["bboxes"] = sample["bboxes"] * s
        # annotation areas (segmentation area for COCO) scale with the
        # coordinate space so the evaluator's area-range gating stays
        # consistent with the resized boxes
        if "area" in sample:
            sample["area"] = np.asarray(sample["area"], np.float32) * (
                (new_w / w) * (new_h / h))
    return sample


def _filter_boxes(sample, min_area: float = 1.0, min_side: float = 1.0):
    boxes = sample.get("bboxes")
    if boxes is None or len(boxes) == 0:
        return sample
    h, w = sample["image"].shape[:2]
    x1 = np.clip(boxes[:, 0], 0, w)
    y1 = np.clip(boxes[:, 1], 0, h)
    x2 = np.clip(boxes[:, 0] + boxes[:, 2], 0, w)
    y2 = np.clip(boxes[:, 1] + boxes[:, 3], 0, h)
    clipped = np.stack([x1, y1, x2 - x1, y2 - y1], axis=-1)
    keep = (
        (clipped[:, 2] > min_side)
        & (clipped[:, 3] > min_side)
        & (clipped[:, 2] * clipped[:, 3] >= min_area)
    )
    sample["bboxes"] = clipped[keep]
    for key in ("labels", "ids", "iscrowd", "area"):
        if key in sample:
            sample[key] = np.asarray(sample[key])[keep]
    return sample


class Transform:
    p: float = 1.0

    def apply(self, sample: Dict, rng: np.random.Generator) -> Dict:
        raise NotImplementedError

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        if self.p >= 1.0 or rng.uniform() < self.p:
            return self.apply(sample, rng)
        return sample


class Resize(Transform):
    def __init__(self, height: int, width: int, p: float = 1.0):
        self.height, self.width, self.p = height, width, p

    def apply(self, sample, rng):
        return _resize(sample, self.height, self.width)


class SmallestMaxSize(Transform):
    """Scale so the SHORTER side == max_size (albumentations semantics)."""

    def __init__(self, max_size: int, p: float = 1.0):
        self.max_size, self.p = max_size, p

    def apply(self, sample, rng):
        h, w = sample["image"].shape[:2]
        scale = self.max_size / min(h, w)
        return _resize(sample, int(round(h * scale)), int(round(w * scale)))


class LongestMaxSize(Transform):
    def __init__(self, max_size: int, p: float = 1.0):
        self.max_size, self.p = max_size, p

    def apply(self, sample, rng):
        h, w = sample["image"].shape[:2]
        scale = self.max_size / max(h, w)
        return _resize(sample, int(round(h * scale)), int(round(w * scale)))


def _crop(sample, top, left, height, width):
    img = sample["image"]
    sample["image"] = img[top : top + height, left : left + width]
    if len(sample.get("bboxes", ())):
        sample["bboxes"] = sample["bboxes"] - np.array([left, top, 0, 0], np.float32)
    return _filter_boxes(sample)


class RandomCrop(Transform):
    def __init__(self, height: int, width: int, p: float = 1.0):
        self.height, self.width, self.p = height, width, p

    def apply(self, sample, rng):
        h, w = sample["image"].shape[:2]
        if h < self.height or w < self.width:
            sample = _resize(sample, max(h, self.height), max(w, self.width))
            h, w = sample["image"].shape[:2]
        top = int(rng.integers(0, h - self.height + 1))
        left = int(rng.integers(0, w - self.width + 1))
        return _crop(sample, top, left, self.height, self.width)


class CenterCrop(Transform):
    def __init__(self, height: int, width: int, p: float = 1.0):
        self.height, self.width, self.p = height, width, p

    def apply(self, sample, rng):
        h, w = sample["image"].shape[:2]
        return _crop(sample, max(0, (h - self.height) // 2),
                     max(0, (w - self.width) // 2), self.height, self.width)


class RandomResizedCrop(Transform):
    def __init__(self, height: int, width: int,
                 scale: Sequence[float] = (0.08, 1.0),
                 ratio: Sequence[float] = (3 / 4, 4 / 3), p: float = 1.0):
        self.height, self.width = height, width
        self.scale, self.ratio, self.p = scale, ratio, p

    def apply(self, sample, rng):
        h, w = sample["image"].shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = int(rng.integers(0, h - ch + 1))
                left = int(rng.integers(0, w - cw + 1))
                sample = _crop(sample, top, left, ch, cw)
                return _resize(sample, self.height, self.width)
        # fallback: center crop of the valid aspect
        sample = CenterCrop(min(h, w), min(h, w)).apply(sample, rng)
        return _resize(sample, self.height, self.width)


class PadIfNeeded(Transform):
    """Bottom/right zero padding to minimums and/or divisors
    (configs/centernet.yaml:76-81 uses divisor 32 for val)."""

    def __init__(self, min_height: Optional[int] = None,
                 min_width: Optional[int] = None,
                 pad_height_divisor: Optional[int] = None,
                 pad_width_divisor: Optional[int] = None, p: float = 1.0):
        self.min_height, self.min_width = min_height, min_width
        self.pad_height_divisor = pad_height_divisor
        self.pad_width_divisor = pad_width_divisor
        self.p = p

    def apply(self, sample, rng):
        h, w = sample["image"].shape[:2]
        th = max(self.min_height or 0, h)
        tw = max(self.min_width or 0, w)
        if self.pad_height_divisor:
            th = int(math.ceil(th / self.pad_height_divisor) * self.pad_height_divisor)
        if self.pad_width_divisor:
            tw = int(math.ceil(tw / self.pad_width_divisor) * self.pad_width_divisor)
        if (th, tw) == (h, w):
            return sample
        pad = [(0, th - h), (0, tw - w)] + [(0, 0)] * (sample["image"].ndim - 2)
        sample["image"] = np.pad(sample["image"], pad)
        return sample


class HorizontalFlip(Transform):
    def __init__(self, p: float = 0.5):
        self.p = p

    def apply(self, sample, rng):
        img = sample["image"]
        w = img.shape[1]
        sample["image"] = np.ascontiguousarray(img[:, ::-1])
        boxes = sample.get("bboxes")
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            boxes[:, 0] = w - boxes[:, 0] - boxes[:, 2]
            sample["bboxes"] = boxes
        return sample


class VerticalFlip(Transform):
    def __init__(self, p: float = 0.5):
        self.p = p

    def apply(self, sample, rng):
        img = sample["image"]
        h = img.shape[0]
        sample["image"] = np.ascontiguousarray(img[::-1])
        boxes = sample.get("bboxes")
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            boxes[:, 1] = h - boxes[:, 1] - boxes[:, 3]
            sample["bboxes"] = boxes
        return sample


class ColorJitter(Transform):
    def __init__(self, brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.0, p: float = 0.5):
        self.brightness, self.contrast = brightness, contrast
        self.saturation, self.hue, self.p = saturation, hue, p

    def apply(self, sample, rng):
        img = sample["image"].astype(np.float32)
        if self.brightness:
            img = img * rng.uniform(1 - self.brightness, 1 + self.brightness)
        if self.contrast:
            mean = img.mean()
            img = (img - mean) * rng.uniform(1 - self.contrast, 1 + self.contrast) + mean
        if self.saturation:
            gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
            f = rng.uniform(1 - self.saturation, 1 + self.saturation)
            img = img * f + gray[..., None] * (1 - f)
        if self.hue:
            import cv2

            hsv = cv2.cvtColor(
                np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV
            ).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(-self.hue, self.hue) * 180)) % 180
            img = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(np.float32)
        sample["image"] = np.clip(img, 0, 255).astype(np.uint8)
        return sample


class Normalize(Transform):
    def __init__(self, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD, p: float = 1.0):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.p = p

    def apply(self, sample, rng):
        img = sample["image"].astype(np.float32) / 255.0
        sample["image"] = (img - self.mean) / self.std
        return sample


class Cutout(Transform):
    """Mask out `num_holes` fixed-size rectangles (albumentations Cutout
    semantics: hole centers uniform over the image, windows clipped at the
    borders, boxes/labels untouched). Named by the reference tracking
    configs (reference configs/mot_tracking.yaml:78-82,
    configs/crowdhuman_tracking.yaml:67-70: 10 holes of 60x60)."""

    def __init__(self, num_holes: int = 8, max_h_size: int = 8,
                 max_w_size: int = 8, fill_value: float = 0, p: float = 0.5):
        self.num_holes, self.fill_value, self.p = num_holes, fill_value, p
        self.max_h_size, self.max_w_size = max_h_size, max_w_size

    def apply(self, sample, rng):
        img = sample["image"].copy()
        h, w = img.shape[:2]
        fill = np.asarray(self.fill_value, img.dtype)
        for _ in range(self.num_holes):
            cy = int(rng.integers(0, h + 1))
            cx = int(rng.integers(0, w + 1))
            # albumentations clips the top-left corner first, then extends
            # by the FULL hole size (holes shift inward at the top/left
            # borders instead of shrinking, and odd sizes stay exact)
            y1 = np.clip(cy - self.max_h_size // 2, 0, h)
            y2 = np.clip(y1 + self.max_h_size, 0, h)
            x1 = np.clip(cx - self.max_w_size // 2, 0, w)
            x2 = np.clip(x1 + self.max_w_size, 0, w)
            img[y1:y2, x1:x2] = fill
        sample["image"] = img
        return sample


class MotionBlur(Transform):
    """Directional blur with a random line kernel (albumentations
    MotionBlur semantics: odd kernel size drawn from blur_limit, a line
    between two random kernel cells, normalized, cv2.filter2D). Named by
    the reference CrowdHuman recipe
    (reference configs/crowdhuman_tracking.yaml:55-56: blur_limit [3, 15]).
    Boxes/labels untouched (image-only op)."""

    def __init__(self, blur_limit=(3, 7), p: float = 0.5):
        if isinstance(blur_limit, (int, float)):
            blur_limit = (3, int(blur_limit))
        self.blur_limit = (int(blur_limit[0]), int(blur_limit[1]))
        if self.blur_limit[0] < 3:
            raise ValueError(f"blur_limit must start >= 3, got {blur_limit}")
        self.p = p

    def apply(self, sample, rng):
        import cv2

        lo, hi = self.blur_limit
        ksize = int(rng.integers(lo // 2, hi // 2 + 1)) * 2 + 1  # odd in [lo|1, hi]
        kernel = np.zeros((ksize, ksize), np.float32)
        # random line through two distinct points (albumentations draws two
        # random cells and connects them)
        x1, y1, x2, y2 = (int(rng.integers(0, ksize)) for _ in range(4))
        if (x1, y1) == (x2, y2):
            x2 = (x1 + 1) % ksize
        cv2.line(kernel, (x1, y1), (x2, y2), 1.0, thickness=1)
        kernel /= max(kernel.sum(), 1e-6)
        img = sample["image"]
        sample["image"] = cv2.filter2D(img, -1, kernel).astype(img.dtype)
        return sample


def _affine_matrix(w: int, h: int, rotate: float = 0.0, shear_x: float = 0.0,
                   shear_y: float = 0.0, tx: float = 0.0, ty: float = 0.0):
    """2x3 affine about the image center: rotate(deg) @ shear(deg) then
    translate(px)."""
    cx, cy = w / 2.0, h / 2.0
    to_origin = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    a = np.deg2rad(rotate)
    rot = np.array([[np.cos(a), -np.sin(a), 0],
                    [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float64)
    shear = np.array([[1, np.tan(np.deg2rad(shear_x)), 0],
                      [np.tan(np.deg2rad(shear_y)), 1, 0],
                      [0, 0, 1]], np.float64)
    back = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]], np.float64)
    return (back @ rot @ shear @ to_origin)[:2]


def _warp_sample(sample, mat):
    """cv2.warpAffine the image; boxes map by transforming all 4 corners and
    taking the enclosing AABB (Compose's final filter clips/drops)."""
    import cv2

    img = sample["image"]
    h, w = img.shape[:2]
    sample["image"] = cv2.warpAffine(img, mat, (w, h))
    boxes = sample.get("bboxes")
    if boxes is not None and len(boxes):
        x, y, bw, bh = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        corners = np.stack([
            np.stack([x, y], -1), np.stack([x + bw, y], -1),
            np.stack([x, y + bh], -1), np.stack([x + bw, y + bh], -1),
        ], axis=1)                                     # (K, 4, 2)
        ones = np.ones((*corners.shape[:2], 1))
        warped = np.concatenate([corners, ones], -1) @ mat.T   # (K, 4, 2)
        x1 = warped[..., 0].min(1)
        y1 = warped[..., 1].min(1)
        x2 = warped[..., 0].max(1)
        y2 = warped[..., 1].max(1)
        new_boxes = np.stack([x1, y1, x2 - x1, y2 - y1], -1).astype(np.float32)
        if "area" in sample:
            # scale each annotation area by its box's w*h change (exact for
            # pure scaling; a reasonable proxy under rotation/shear — area
            # is only consumed by eval, which never warps)
            old = np.maximum(bw * bh, 1e-12)
            sample["area"] = np.asarray(sample["area"], np.float32) * (
                (new_boxes[:, 2] * new_boxes[:, 3]) / old)
        sample["bboxes"] = new_boxes
    return sample


class Affine(Transform):
    """Random affine: each scalar arg v samples uniformly in (-v, v)
    (albumentations A.Affine convention; reference transforms.py:11-15).
    rotate/shear in degrees, translate in pixels."""

    def __init__(self, rotate: float = 0.0, shear_x: float = 0.0,
                 shear_y: float = 0.0, translate_x: float = 0.0,
                 translate_y: float = 0.0, p: float = 1.0):
        self.rotate, self.shear_x, self.shear_y = rotate, shear_x, shear_y
        self.translate_x, self.translate_y, self.p = translate_x, translate_y, p

    def apply(self, sample, rng):
        h, w = sample["image"].shape[:2]
        draw = lambda v: float(rng.uniform(-v, v)) if v else 0.0
        mat = _affine_matrix(
            w, h, rotate=draw(self.rotate),
            shear_x=draw(self.shear_x), shear_y=draw(self.shear_y),
            tx=draw(self.translate_x), ty=draw(self.translate_y),
        )
        return _warp_sample(sample, mat)


class TrivialAugmentWide(Transform):
    """One random op at a random strength per call — the reference's
    12-op albumentations OneOf (datasets/transforms.py:8-26): 5 geometric
    (shear x/y to 45deg, translate x/y to 32px, rotate to 135deg; random
    sign) + 7 photometric. Default p = num_ops/(num_ops+1) matches the
    reference's OneOf probability."""

    def __init__(self, p: float = 12.0 / 13.0):
        self.p = p

    def apply(self, sample, rng):
        h, w = sample["image"].shape[:2]
        sign = 1.0 if rng.uniform() < 0.5 else -1.0
        geo = lambda s, **kw: _warp_sample(s, _affine_matrix(w, h, **kw))
        ops = [
            lambda s, m: geo(s, shear_x=45 * m * sign),
            lambda s, m: geo(s, shear_y=45 * m * sign),
            lambda s, m: geo(s, tx=32 * m * sign),
            lambda s, m: geo(s, ty=32 * m * sign),
            lambda s, m: geo(s, rotate=135 * m * sign),
            lambda s, m: ColorJitter(brightness=m, contrast=0, saturation=0).apply(s, rng),
            lambda s, m: ColorJitter(brightness=0, contrast=m, saturation=0).apply(s, rng),
            lambda s, m: ColorJitter(brightness=0, contrast=0, saturation=m).apply(s, rng),
            lambda s, m: self._posterize(s, m),
            lambda s, m: self._solarize(s, m),
            lambda s, m: self._equalize(s, m),
            lambda s, m: self._sharpen(s, m, rng),
        ]
        op = ops[int(rng.integers(0, len(ops)))]
        return op(sample, float(rng.uniform(0.0, 0.99)))

    @staticmethod
    def _posterize(sample, m):
        bits = max(1, int(8 - 6 * m))
        shift = 8 - bits
        sample["image"] = (sample["image"] >> shift) << shift
        return sample

    @staticmethod
    def _solarize(sample, m):
        thresh = int(255 * (1 - m))
        img = sample["image"]
        sample["image"] = np.where(img >= thresh, 255 - img, img)
        return sample

    @staticmethod
    def _equalize(sample, m):
        import cv2

        img = sample["image"]
        out = np.stack([cv2.equalizeHist(img[..., c]) for c in range(3)], axis=-1)
        sample["image"] = out
        return sample

    @staticmethod
    def _sharpen(sample, m, rng):
        import cv2

        img = sample["image"].astype(np.float32)
        blur = cv2.GaussianBlur(img, (3, 3), 0)
        sample["image"] = np.clip(img + m * (img - blur), 0, 255).astype(np.uint8)
        return sample


class Compose:
    def __init__(self, transforms: List[Transform], min_area: float = 1.0,
                 seed: Optional[int] = None):
        self.transforms = transforms
        self.min_area = min_area
        self.rng = np.random.default_rng(seed)
        # numpy Generators are not thread-safe and the threaded DataLoader
        # calls transforms concurrently: hand each call its own child
        # generator, seeded under a lock
        import threading

        self._lock = threading.Lock()

    def __call__(self, sample: Dict, rng: Optional[np.random.Generator] = None) -> Dict:
        if rng is None:
            with self._lock:
                rng = np.random.default_rng(self.rng.integers(2 ** 63))
        sample = dict(sample)
        sample["bboxes"] = np.asarray(sample.get("bboxes", np.zeros((0, 4))), np.float32).reshape(-1, 4)
        sample["labels"] = np.asarray(sample.get("labels", np.zeros((0,))), np.int64).reshape(-1)
        for t in self.transforms:
            sample = t(sample, rng)
        return _filter_boxes(sample, min_area=self.min_area, min_side=0.0)


def get_default_transforms(resize_height: int = 512, resize_width: int = 512,
                           seed: Optional[int] = None) -> "Compose":
    """ImageNet normalize + resize (reference datasets/utils.py:12-21)."""
    return Compose([Normalize(), Resize(resize_height, resize_width)], seed=seed)


def get_default_detection_transforms(seed: Optional[int] = None) -> "Compose":
    """512x512 detection default (reference datasets/utils.py:23-27)."""
    return get_default_transforms(512, 512, seed=seed)


def get_default_tracking_transforms(seed: Optional[int] = None) -> "Compose":
    """1088x608 tracking default — close to 16:9 and divisible by 32
    (reference datasets/utils.py:29-33)."""
    return get_default_transforms(608, 1088, seed=seed)


TRANSFORMS = {
    cls.__name__: cls
    for cls in (
        Resize, SmallestMaxSize, LongestMaxSize, RandomCrop, CenterCrop,
        RandomResizedCrop, PadIfNeeded, HorizontalFlip, VerticalFlip,
        ColorJitter, Normalize, Cutout, MotionBlur, Affine,
        TrivialAugmentWide,
    )
}


def build_transforms(config, seed: Optional[int] = None) -> Compose:
    """[{name, init_args|params}] -> Compose. The reference's
    parse_albumentations_transforms (coco.py:103-113) / parse_transforms
    (builder.py:46) config surface. The Gen-A mapping form
    {Name: {params}} (reference configs/crowdhuman_tracking.yaml:53-70,
    test_config.yaml:55-63) is accepted too."""
    if isinstance(config, dict):
        config = [{"name": name, "params": params}
                  for name, params in config.items()]
    transforms = []
    for item in config or []:
        if not isinstance(item, dict) or "name" not in item:
            raise ValueError(
                f"transform entry {item!r} has no 'name'; use "
                f"{{name: X, params: {{...}}}} or the mapping form "
                f"{{X: {{...}}}}")
        name = item["name"]
        if name not in TRANSFORMS and name != "Mosaic":
            raise KeyError(f"unknown transform {name!r} "
                           f"(known: {sorted(TRANSFORMS)})")
        if name == "Mosaic":
            raise ValueError(
                "Mosaic needs to see 4 samples and is a dataset wrapper, "
                "not a per-sample transform: use the dataset config key "
                "'mosaic: {height, width, p}' (data/mosaic.py)"
            )
        kwargs = item.get("init_args") or item.get("params") or {}
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        transforms.append(TRANSFORMS[name](**kwargs))
    return Compose(transforms, seed=seed)
