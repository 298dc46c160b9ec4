"""Post-training int8 quantization for serving (port of quantize.py).

Every target convolution of a model runs as symmetric int8 math:

    x_q = clip(round(x / s_x), -127, 127)             # per tensor
    y   = conv(x_q, w_q), accumulated in int32
    y   = y * (s_x * s_w[c_out]) + bias                # f32, then x's dtype

Weights are int8 per output channel (s_w[o] = max|w[o]| / 127); the
activation scale s_x of each convolution is its input's max-abs over
calibration batches, / 127. BatchNorm, activations, adds, resizes and the
decode stay in the predictor's float dtype.

Targets are the modules whose type is exactly `nn.Conv2d` or
`models/layers.py:SameConv2d` (flax's `nn.Conv`); a transpose convolution
(`nn.ConvTranspose2d`) is never one. `default_exclude` keeps two kinds in
float: the offset and mask convolutions of a `DeformableConvBlock`, and
grouped (depthwise) convolutions. A custom `exclude(module, name, parent)`
replaces it. Scales are keyed by module name (`model.named_modules()`),
where the JAX package keys them by flax path; `utils/convert.py` maps one
to the other.

The int32 accumulation has two implementations with equal results:
  - `int8_conv_plain` (a CPU tensor, the tests, and the card's reference in
    chip_smoke.py): `F.conv2d` in float64 over the int8 values, exact since
    |sum| <= 127^2 K < 2^53;
  - `int8_conv_mm` (what `Int8Conv2d` runs on a CUDA tensor, counted in
    `Int8Conv2d.card_calls`): int8 x int8 -> int32 products on the
    tensor cores through `torch._int_mm` (cuBLASLt), over an NHWC im2col
    (a 1x1 convolution at stride 1 is a reshape of the channels_last
    input), K and N zero-padded to multiples of 8, the batch cut into
    chunks so that the im2col stays under `IM2COL_BYTES`. A grouped
    convolution is one product a group. A shape `_int_mm` refuses raises
    with the shape; there is no float fallback.
The JAX package runs the same conv as XLA's
`lax.conv_general_dilated(..., preferred_element_type=int32)` outside any
Pallas kernel, so the port leaves it to a library product as well. While
a profiler runs, each stage of the card's conv (quantize, im2col, int_mm,
dequant) is a range named `int8_conv.<stage>`.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .models.layers import SameConv2d, same_pads

__all__ = [
    "Int8Conv2d",
    "collect_conv_scales",
    "conv_targets",
    "default_exclude",
    "int8_conv_mm",
    "int8_conv_plain",
    "load_calibration_images",
    "pack_weight",
    "quantize_activation",
    "quantize_conv_params",
    "quantize_model",
    "quantized_apply",
    "unpack_weight",
]

_EPS = 1e-8
_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
IM2COL_BYTES = 1 << 29    # the largest im2col chunk the card builds (512 MiB)
_MIN_ROWS = 17            # _int_mm takes more than 16 rows


def load_calibration_images(img_dir: str, n: int, image_size) -> np.ndarray:
    """First `n` images of a folder, resized to (h, w), uint8 (N, h, w, 3):
    the calibration batch for `CenterNetPredictor.quantize`, shared by the
    detect, track and serve CLIs (entries that are no image are skipped)."""
    import os

    import cv2

    h, w = image_size
    names = sorted(
        f for f in os.listdir(img_dir)
        if f.lower().endswith(_IMG_EXTS)
        and os.path.isfile(os.path.join(img_dir, f))
    )[:n]
    if not names:
        raise FileNotFoundError(
            f"no calibration images ({'/'.join(_IMG_EXTS)}) in {img_dir}")
    return np.stack([
        cv2.resize(cv2.cvtColor(
            cv2.imread(os.path.join(img_dir, f), cv2.IMREAD_COLOR),
            cv2.COLOR_BGR2RGB), (w, h))
        for f in names
    ]).astype(np.uint8)


def default_exclude(module: nn.Module, name: str,
                    parent: Optional[nn.Module]) -> bool:
    """Keep in float the DCN offset / mask convolutions (zero at init and
    sensitive to absolute error) and grouped convolutions (bound by
    memory, no tensor-core gain). Pass a custom `exclude` to override."""
    if type(parent).__name__ == "DeformableConvBlock":
        return True
    return module.groups > 1


def _supported(module: nn.Conv2d) -> bool:
    return (module.padding_mode == "zeros"
            and not isinstance(module.padding, str))


def conv_targets(model: nn.Module, exclude: Callable = default_exclude
                 ) -> Dict[str, nn.Conv2d]:
    """{name: module} of the convolutions `quantize_model` replaces."""
    modules = dict(model.named_modules())
    out = {}
    for name, module in modules.items():
        if type(module) not in (nn.Conv2d, SameConv2d) or not _supported(module):
            continue
        parent = modules.get(name.rpartition(".")[0]) if name else None
        if not exclude(module, name, parent):
            out[name] = module
    return out


@torch.no_grad()
def collect_conv_scales(model: nn.Module, batches: Sequence[torch.Tensor],
                        exclude: Callable = default_exclude) -> Dict[str, float]:
    """{conv name: activation scale}, scale = max-abs of the input / 127
    over `batches`, which must be preprocessed exactly as serving inputs
    (the predictor's `quantize` does that). The model runs in eval mode."""
    targets = conv_targets(model, exclude)
    record: Dict[str, torch.Tensor] = {}

    def observer(name):
        def hook(module, args):
            m = args[0].float().abs().amax()
            record[name] = torch.maximum(record[name], m) if name in record else m
        return hook

    handles = [m.register_forward_pre_hook(observer(n)) for n, m in targets.items()]
    maxabs: Dict[str, float] = {}
    was_training = model.training
    model.eval()
    try:
        for batch in batches:
            record.clear()
            model(batch)
            for k, v in record.items():
                maxabs[k] = max(maxabs.get(k, 0.0), float(v))
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return {k: max(v, _EPS) / 127.0 for k, v in maxabs.items()}


def quantize_conv_params(model: nn.Module, act_scales: Dict[str, float]
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{name: {"w": int8 OIHW, "s": f32 (O,), ["b": f32 (O,)]}} for every
    convolution with an activation scale: per output channel,
    s_w = max(max|w|, 1e-8) / 127 and w_q = clip(round(w / s_w), -127, 127)
    (round half to even), from the weights as the model holds them."""
    modules = dict(model.named_modules())
    qtree = {}
    for name in act_scales:
        conv = modules[name]
        w = conv.weight.detach().float()
        s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=_EPS) / 127.0
        w_q = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127)
        entry = {"w": w_q.to(torch.int8), "s": s_w}
        if conv.bias is not None:
            entry["b"] = conv.bias.detach().float()
        qtree[name] = entry
    return qtree


def quantize_activation(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s), -127, 127) as int8, in f32. `scale` is a
    one-element f32 tensor of shape (1,) on x's device: a bf16 `x` is then
    promoted to f32 inside the division (no copy first), and the division
    is a true one on every device."""
    q = torch.div(x, scale)
    return q.round_().clamp_(-127, 127).to(torch.int8)


def int8_conv_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride, pads,
                    dilation, groups: int) -> torch.Tensor:
    """int32 accumulators of an int8 conv, exactly, on any device: x_q
    (N, C, H, W) and w_q (O, C/g, kh, kw) int8; pads (top, bottom, left,
    right) of zeros. Returns (N, O, Ho, Wo) int32, in channels_last memory
    when x_q is."""
    top, bottom, left, right = pads
    x = F.pad(x_q.double(), (left, right, top, bottom))
    y = F.conv2d(x, w_q.double(), None, stride, 0, dilation, groups)
    fmt = (torch.channels_last if x_q.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return y.to(torch.int32, memory_format=fmt)


def _stage(name: str):
    """A profiler range around one stage of the int8 conv (quantize,
    im2col, int_mm, dequant), only while a profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(f"int8_conv.{name}")
    return contextlib.nullcontext()


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _int_mm(a: torch.Tensor, b: torch.Tensor, what: str) -> torch.Tensor:
    try:
        return torch._int_mm(a, b)
    except RuntimeError as err:
        raise RuntimeError(f"int8 conv {what}: _int_mm refused A {tuple(a.shape)} "
                           f"x B {tuple(b.shape)}: {err}") from err


def _im2col(xp: torch.Tensor, kh: int, kw: int, stride, dilation,
            ho: int, wo: int) -> torch.Tensor:
    """(N, Hp, Wp, C) padded NHWC -> (N*Ho*Wo, kh*kw*C), columns (ky, kx, c)."""
    n, _, _, c = xp.shape
    (sh, sw), (dh, dw) = stride, dilation
    # eight channels as one int64: the gathering copy moves 8 bytes an
    # element instead of 1 (the same bytes, in the same order)
    packed = (c % 8 == 0 and xp.stride(-1) == 1 and xp.storage_offset() % 8 == 0
              and all(st % 8 == 0 for st in xp.stride()[:-1]))
    if packed:
        xp, c = xp.view(torch.int64), c // 8
    if kh == kw == 1:
        cols = xp[:, :(ho - 1) * sh + 1:sh, :(wo - 1) * sw + 1:sw]
        cols = cols.reshape(n * ho * wo, c)
    else:
        win_h, win_w = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        cols = xp.unfold(1, win_h, sh).unfold(2, win_w, sw)  # (N, Ho, Wo, C, wh, ww)
        cols = cols[:, :ho, :wo, :, ::dh, ::dw]
        cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, kh * kw * c)
    return cols.view(torch.int8) if packed else cols


def pack_weight(w_q: torch.Tensor, groups: int) -> torch.Tensor:
    """int8 OIHW weights -> (groups, Np, Kp): a group's (O/g, kh*kw*C/g)
    matrix, columns (ky, kx, c) as the im2col has them, zero-padded to
    multiples of 8 (what `_int_mm` takes); B of a group's product is its
    transpose, column-major."""
    o, cg, kh, kw = w_q.shape
    og, k = o // groups, kh * kw * cg
    wt = w_q.permute(0, 2, 3, 1).reshape(groups, og, k)
    return F.pad(wt, (0, _round8(k) - k, 0, _round8(og) - og)).contiguous()


def unpack_weight(packed: torch.Tensor, shape) -> torch.Tensor:
    """`pack_weight`'s inverse: the int8 OIHW weights of `shape`."""
    o, cg, kh, kw = shape
    groups = packed.shape[0]
    og = o // groups
    w = packed[:, :og, :kh * kw * cg].reshape(o, kh, kw, cg)
    return w.permute(0, 3, 1, 2).contiguous()


def int8_conv_mm(x_q: torch.Tensor, w_q: torch.Tensor, stride, pads,
                 dilation, groups: int, epilogue: Optional[Callable] = None
                 ) -> torch.Tensor:
    """The int8 conv as `torch._int_mm` products over an NHWC im2col, on
    any device `_int_mm` runs on (what `Int8Conv2d` runs on the card):
    x_q (N, C, H, W) and w_q (O, C/g, kh, kw) int8, pads (top, bottom,
    left, right). `epilogue` maps each chunk's (rows, O) int32 accumulators
    to what is kept (the dequantization), so no full int32 output is held.
    Returns (N, O, Ho, Wo) (int32 without an epilogue) in channels_last
    memory."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8 conv takes int8 tensors, got {w_q.dtype}")
    return _conv_mm(x_q, pack_weight(w_q, groups), tuple(w_q.shape), stride,
                    pads, dilation, epilogue)


def _conv_mm(x_q, packed, w_shape, stride, pads, dilation, epilogue):
    """`int8_conv_mm` on weights already packed (`pack_weight`) from int8
    OIHW weights of `w_shape`."""
    if x_q.dtype != torch.int8:
        raise TypeError(f"int8 conv takes int8 tensors, got {x_q.dtype}")
    stride, dilation = tuple(stride), tuple(dilation)
    top, bottom, left, right = pads
    n, c, h, w = x_q.shape
    o, cg, kh, kw = w_shape
    groups = packed.shape[0]
    og = o // groups
    ho = (h + top + bottom - (kh - 1) * dilation[0] - 1) // stride[0] + 1
    wo = (w + left + right - (kw - 1) * dilation[1] - 1) // stride[1] + 1
    xh = x_q.permute(0, 2, 3, 1)                  # NHWC, as channels_last lies
    if any(pads):
        with _stage("im2col"):
            xh = F.pad(xh, (0, 0, left, right, top, bottom))
    k = kh * kw * cg
    kp = packed.shape[2]
    chunk = max(1, min(n, IM2COL_BYTES // max(ho * wo * kp, 1)))
    shape = (f"x {tuple(x_q.shape)} w {tuple(w_shape)} stride {stride} "
             f"pads {tuple(pads)} groups {groups}")
    outs = []
    for i0 in range(0, n, chunk):
        xc = xh[i0:i0 + chunk]
        rows = xc.shape[0] * ho * wo
        per_group = []
        for g in range(groups):
            with _stage("im2col"):
                a = _im2col(xc[..., g * cg:(g + 1) * cg], kh, kw, stride,
                            dilation, ho, wo)
                pad_rows = max(_MIN_ROWS - rows, 0)
                if kp != k or pad_rows:
                    a = F.pad(a, (0, kp - k, 0, pad_rows))
            with _stage("int_mm"):
                acc = _int_mm(a, packed[g].t(), shape)
            per_group.append(acc[:rows, :og])
        acc = per_group[0] if groups == 1 else torch.cat(per_group, dim=1)
        if epilogue is not None:
            with _stage("dequant"):
                acc = epilogue(acc)
        outs.append(acc.reshape(xc.shape[0], ho, wo, o))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.permute(0, 3, 1, 2)


class Int8Conv2d(nn.Module):
    """A convolution in int8 (`quantize_model` puts it in place of a
    target): the int8 weights packed as the card's product takes them
    (`weight_q`, `pack_weight`; `weight_oihw()` unpacks them), f32
    per-channel weight scales and bias as buffers, the activation scale as
    a (1,) f32 buffer. Takes and returns NCHW in the input's dtype. On a
    CUDA tensor it runs `int8_conv_mm`'s products (counted in the class's
    `card_calls`); on a CPU tensor, or with `plain=True` on any device
    (the card's reference), the plain accumulation."""

    card_calls = 0

    def __init__(self, conv: nn.Conv2d, act_scale: float,
                 q: Dict[str, torch.Tensor]):
        super().__init__()
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.kernel_size, self.stride = conv.kernel_size, conv.stride
        self.dilation, self.groups = conv.dilation, conv.groups
        self.same = isinstance(conv, SameConv2d) and not conv.symmetric
        self.padding = conv.padding
        self.act_scale = float(act_scale)
        dev = conv.weight.device
        self.weight_shape = tuple(q["w"].shape)
        self.register_buffer("weight_q", pack_weight(q["w"].to(dev), self.groups))
        self.register_buffer("w_scale", q["s"].to(dev))
        self.register_buffer("bias", q["b"].to(dev) if "b" in q else None)
        self.register_buffer("x_scale", torch.tensor([self.act_scale],
                                                     dtype=torch.float32,
                                                     device=dev))
        self.plain = False

    def weight_oihw(self) -> torch.Tensor:
        """The int8 weights as OIHW (what the plain accumulation takes)."""
        return unpack_weight(self.weight_q, self.weight_shape)

    def pads(self, h: int, w: int) -> Tuple[int, int, int, int]:
        """(top, bottom, left, right) zeros for an input of h x w."""
        if self.same:
            k, s = self.kernel_size, self.stride
            return (*same_pads(h, k[0], s[0]), *same_pads(w, k[1], s[1]))
        ph, pw = self.padding
        return ph, ph, pw, pw

    def dequantize(self, acc: torch.Tensor, dtype: torch.dtype,
                   channel_dim: int = 1) -> torch.Tensor:
        """acc * (s_x * s_w) + bias in f32, then `dtype`; channels along
        `channel_dim` (the plain path's NCHW, the card's (rows, O))."""
        view = (-1,) + (1,) * (acc.dim() - 1 - channel_dim)
        # int32 * f32 promotes inside the product (no f32 copy first); the
        # bias add writes `dtype` directly, rounding its f32 sum once
        y = torch.mul(acc, (self.x_scale * self.w_scale).view(view))
        if self.bias is None:
            return y.to(dtype)
        return torch.add(y, self.bias.view(view),
                         out=torch.empty_like(y, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _stage("quantize"):
            x_q = quantize_activation(x, self.x_scale)
        pads = self.pads(x.shape[2], x.shape[3])
        if x.device.type == "cuda" and not self.plain:
            out = _conv_mm(x_q, self.weight_q, self.weight_shape, self.stride,
                           pads, self.dilation, epilogue=lambda acc:
                           self.dequantize(acc, x.dtype, channel_dim=1))
            Int8Conv2d.card_calls += 1
            return out
        if x.device.type != "cpu" and not self.plain:
            raise ValueError(f"no int8 conv for device {x.device}")
        acc = int8_conv_plain(x_q, self.weight_oihw(), self.stride, pads,
                              self.dilation, self.groups)
        return self.dequantize(acc, x.dtype)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"groups={self.groups}, act_scale={self.act_scale:.6g}")


def _quantized_copy(model: nn.Module, qtree: Dict[str, Dict[str, torch.Tensor]],
                    act_scales: Dict[str, float]) -> nn.Module:
    qmodel = copy.deepcopy(model).eval()
    modules = dict(qmodel.named_modules())
    for name, q in qtree.items():
        parent_name, _, leaf = name.rpartition(".")
        parent = modules[parent_name] if parent_name else qmodel
        setattr(parent, leaf, Int8Conv2d(modules[name], act_scales[name], q))
    qmodel.act_scales = {k: act_scales[k] for k in qtree}
    return qmodel


def quantized_apply(model: nn.Module, qtree: Dict[str, Dict[str, torch.Tensor]],
                    act_scales: Dict[str, float], images: torch.Tensor):
    """`model(images)` with every convolution of `qtree` in int8 (the
    others in float as they are); `model` is left untouched."""
    return _quantized_copy(model, qtree, act_scales)(images)


def quantize_model(model: nn.Module,
                   calibration_batches: Sequence[torch.Tensor] = (),
                   exclude: Callable = default_exclude,
                   act_scales: Optional[Dict[str, float]] = None) -> nn.Module:
    """A copy of `model` (eval mode) with every target convolution replaced
    by an `Int8Conv2d`, scales from `calibration_batches` (preprocessed as
    serving inputs) or given as `act_scales`. `model` is left untouched;
    the copy's `act_scales` holds the scales."""
    if act_scales is None:
        act_scales = collect_conv_scales(model, calibration_batches, exclude)
    return _quantized_copy(model, quantize_conv_params(model, act_scales),
                           act_scales)
