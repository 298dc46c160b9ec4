"""The (data, model) process grid (port of parallel/mesh.py's `model` axis).

The JAX package lays its devices out as a (data, model) mesh. The batch
goes over `data`; with `shard_params(model_parallel=True)` every 4-D kernel
whose out-dim is at least 256 and divides by the `model` size is split
over `model`; with `spatial_sharding` the NHWC images are split over batch
and height, and GSPMD inserts the halo exchanges. Here each rank is one
process (`torch.distributed`), rank = d * n_model + m as
`np.reshape(devices, (n_data, n_model))` orders JAX's devices, and:

  - `create_mesh` builds the grid's data and model sub-groups;
  - `shard_params(model_parallel=True)` makes those convolutions
    column-parallel: each rank holds a slice of the out-channels, computes
    it, and the slices are all-gathered along channels over the model
    group. Everything after the gather runs replicated on the model group,
    so every rank holds the same cotangent of the gathered map and the
    gather's backward is the rank's own slice of it (a reduce-scatter
    would multiply it by n_model); the conv's input is summed over the
    group in the backward (each rank's slice gives part of its gradient);
  - `spatial_forward` runs a model's eval forward on one band of
    H / n_model rows a rank (`split_rows`), under a torch function mode
    that gives each spatial primitive the rows it needs from the global
    map: a window of size k, stride s and pads (lo, hi) on the global
    height needs lo rows above the band and k - s - lo below, which come
    from the neighbours (one all-gather of every band's edge rows, a
    collective that gloo also takes on CUDA tensors); only the global
    edges get the pad value (zero, or -inf for max pools); a spatial
    primitive without a band rule is refused (NotImplementedError). Pads
    and crops that the port's layers reckon from a band's own height stay
    right: an H pad is taken as the SAME pad of the window op that reads
    it and recomputed for the global height, a crop (negative pad) is
    local, and a transposed conv gives the band the rows its crop
    expects. Where a
    band would not divide by a stride, or for the exact DCN engines
    (whose offsets are unbounded), the map is gathered whole (counted in
    `spatial_forward.gathers`) and goes on replicated, as GSPMD pads
    uneven shards; a replicated map meeting a band is cut to the band, and
    refused (NotImplementedError) unless it is that band's whole map (as
    where BiFPN's `Fuse` compares a gathered level's height with a
    band's). `gather_bands` then puts the heads' maps back together along
    H for the decode (whose 3x3 pseudo-NMS crosses band edges);
  - `make_train_step(..., mesh=mesh)` (train/state.py) takes the step on
    the grid: the batch split over data and replicated over model, the
    gradient mean, the losses' counts and BatchNorm's statistics over the
    data group (parallel/dist.py).

With one process every function returns what a single process computes.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import dist

__all__ = ["Mesh", "create_mesh", "shard_batch", "shard_params",
           "full_state_dict", "split_rows", "spatial_forward", "gather_bands",
           "spatial_detect"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (data, model) grid and its two groups
    (None with one process)."""
    n_data: int = 1
    n_model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None


def create_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) grid over the initialised process group
    (every process on `data` by default). Every rank must call it, with
    the same sizes: it creates every sub-group in one order."""
    world = dist.process_count(tdist.group.WORLD) if tdist.is_initialized() else 1
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world or n_model < 1:
        raise ValueError(f"a ({n_data}, {n_model}) grid needs "
                         f"{n_data * n_model} processes, there are {world}")
    if world == 1:
        return Mesh()
    d, m = divmod(tdist.get_rank(), n_model)
    model_group = data_group = None
    for dd in range(n_data):
        g = tdist.new_group([dd * n_model + mm for mm in range(n_model)])
        model_group = g if dd == d else model_group
    for mm in range(n_model):
        g = tdist.new_group([dd * n_model + mm for dd in range(n_data)])
        data_group = g if mm == m else data_group
    return Mesh(n_data, n_model, d, m, data_group, model_group)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays or tensors): the
    batch split over `data`, replicated over `model`."""
    def rows(v):
        n = v.shape[0] // mesh.n_data
        return v[mesh.data_rank * n:(mesh.data_rank + 1) * n]
    return {k: rows(v) if hasattr(v, "shape") else v for k, v in batch.items()}


# ---- tensor parallelism: column-parallel convolutions ----------------------

class _ToModel(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the model group
    (each rank's slice of a column-parallel conv gives part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        tdist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """The ranks' channel slices of an NCHW map, all-gathered in rank
    order over the model group (through NHWC, so a channels_last map stays
    channels_last). The backward is this rank's slice of the cotangent:
    every rank of the group holds the same cotangent of the gathered map."""

    @staticmethod
    def forward(ctx, y, group, rank, n):
        yh = y.permute(0, 2, 3, 1).contiguous()
        parts = [torch.empty_like(yh) for _ in range(n)]
        tdist.all_gather(parts, yh, group=group)
        ctx.group, ctx.rank, ctx.size = group, rank, y.shape[1]
        return torch.cat(parts, dim=3).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.rank * ctx.size, ctx.size), None, None, None


def _column_parallel_forward(conv: nn.Module, mesh: Mesh,
                             x: torch.Tensor) -> torch.Tensor:
    """`conv`'s forward with its weight's slice of out-channels, gathered
    over the model group, then its (whole) bias."""
    from ..models.layers import SameConv2d

    x = _ToModel.apply(x, mesh.model_group)
    groups = conv.groups
    if groups > 1:      # a grouped conv's slice reads its groups' inputs
        cin = x.shape[1] // mesh.n_model
        x = x.narrow(1, mesh.model_rank * cin, cin)
        groups //= mesh.n_model
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, conv.weight, None, conv.stride, conv.padding,
                               conv.output_padding, groups, conv.dilation)
    else:
        if isinstance(conv, SameConv2d):
            x = conv.pad_input(x)
        y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding,
                     conv.dilation, groups)
    y = _GatherChannels.apply(y, mesh.model_group, mesh.model_rank,
                              mesh.n_model)
    if conv.bias is not None:
        y = y + conv.bias.view(1, -1, 1, 1)
    return y


def _split_dim(module: nn.Module) -> Optional[int]:
    """The out-channel dim of a convolution's weight, None for others."""
    if isinstance(module, nn.ConvTranspose2d):
        return 1
    if isinstance(module, nn.Conv2d):
        return 0
    return None


def shard_params(model: nn.Module, mesh: Mesh,
                 model_parallel: bool = False) -> Tuple[str, ...]:
    """Rank 0's parameters and buffers on every rank (replicated); with
    `model_parallel`, every convolution whose out-channels are at least
    256 and divide by `n_model` (the kernels JAX's `spec_for` splits)
    keeps its rank's slice of them and runs column-parallel. Returns the
    names of the split weights. A split weight carries `model_group` and
    `model_split` = (dim, rank, n) (train/optim.py's clip reads the first;
    `full_state_dict` the second)."""
    dist.broadcast_module(model, group=tdist.group.WORLD)
    if not model_parallel or mesh.n_model == 1:
        return ()
    n, m = mesh.n_model, mesh.model_rank
    names = []
    for name, module in model.named_modules():
        dim = _split_dim(module)
        if dim is None or getattr(module, "model_split", None):
            continue
        out = module.weight.shape[dim]
        if out < 256 or out % n:
            continue
        part = out // n
        w = module.weight
        local = nn.Parameter(w.detach().narrow(dim, m * part, part).clone(),
                             requires_grad=w.requires_grad)
        local.model_group = mesh.model_group
        local.model_split = (dim, m, n)
        module.weight = local
        module.model_split = True
        module.forward = functools.partial(_column_parallel_forward, module,
                                           mesh)
        names.append(f"{name}.weight" if name else "weight")
    return tuple(names)


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every split weight gathered whole over
    its model group (what one process holds)."""
    out = {}
    for name, t in model.state_dict(keep_vars=True).items():
        split = getattr(t, "model_split", None)
        if split is None:
            out[name] = t.detach().clone()
            continue
        dim, _, n = split
        parts = [torch.empty_like(t) for _ in range(n)]
        tdist.all_gather(parts, t.detach().contiguous(), group=t.model_group)
        out[name] = torch.cat(parts, dim)
    return out


# ---- height-split serving --------------------------------------------------

_KIND = "_band_kind"          # "band" (this rank's rows) or "full"
_PAD = "_band_pad"            # a SAME pad a window op has still to apply
_WHOLE = "_band_whole"        # a band's gathered map, once gathered
BAND, FULL = "band", "full"


def split_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's band of H / n_model rows of NHWC x."""
    h = x.shape[1] // mesh.n_model
    if h * mesh.n_model != x.shape[1]:
        raise ValueError(f"height {x.shape[1]} does not split into "
                         f"{mesh.n_model} bands")
    return x.narrow(1, mesh.model_rank * h, h)


def _kind(t) -> Optional[str]:
    return getattr(t, _KIND, None) if isinstance(t, torch.Tensor) else None


def _tag(out, kind: Optional[str]):
    if kind is not None:
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                setattr(t, _KIND, kind)
    return out


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, str):
        raise NotImplementedError(f"padding {v!r} under a height split")
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    from ..models.layers import same_pads

    return same_pads(size, k, s)


def _binder(fn):
    sig = inspect.signature(fn)

    def bind(args, kwargs):
        ba = sig.bind(*args, **kwargs)
        ba.apply_defaults()
        return ba
    return bind


_CONV = _binder(lambda input, weight, bias=None, stride=1, padding=0,
                dilation=1, groups=1: None)
_CONVT = _binder(lambda input, weight, bias=None, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1: None)
_MAX = _binder(lambda input, kernel_size, stride=None, padding=0, dilation=1,
               ceil_mode=False, return_indices=False: None)
_AVG = _binder(lambda input, kernel_size, stride=None, padding=0,
               ceil_mode=False, count_include_pad=True,
               divisor_override=None: None)
# spatial primitives without a band rule: refused on a band
_REFUSED = {F.adaptive_avg_pool2d, F.adaptive_max_pool2d, F.grid_sample,
            F.unfold, F.fold, F.pixel_shuffle, F.pixel_unshuffle}
_PADF = _binder(lambda input, pad, mode="constant", value=None: None)
_INTERP = _binder(lambda input, size=None, scale_factor=None, mode="nearest",
                  align_corners=None, recompute_scale_factor=None,
                  antialias=False: None)
_REDUCE = _binder(lambda input, dim=None, keepdim=False, *, dtype=None: None)
_SAMPLE = _binder(lambda x, a0, b0, fy, fx, wm, d: None)
_FUSED = _binder(lambda x, a0, b0, fy, fx, wm, kernel, d: None)
_EXACT = _binder(lambda x, offsets, mask, k=3: None)


class _Bands(TorchFunctionMode):
    """The height split's rules (see the module docstring). NCHW maps
    (the model's) carry H in dim 2, NHWC maps (the DCN engines' and the
    heads' outputs) in dim 1."""

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.n, self.r, self.group = mesh.n_model, mesh.model_rank, mesh.model_group
        self.gathers = 0
        from ..ops import dcn, dcn_fused, dcn_sample

        self.rules = {
            F.conv2d: self._conv, F.conv_transpose2d: self._conv_transpose,
            F.max_pool2d: self._max_pool,
            F.avg_pool2d: self._avg_pool, F.pad: self._pad,
            F.interpolate: self._interpolate,
            torch.Tensor.mean: self._reduce, torch.mean: self._reduce,
            torch.Tensor.sum: self._reduce, torch.sum: self._reduce,
            dcn_sample.dcn_sample_taps: functools.partial(self._dcn, _SAMPLE),
            dcn_fused.dcn_fused_conv: functools.partial(self._dcn, _FUSED),
            dcn.exact_taps: self._exact,
        }

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = self.rules.get(func)
        if rule is not None and _kind(args[0] if args else None) == BAND:
            return rule(func, args, kwargs)
        if func in _REFUSED and _kind(args[0]) == BAND:
            raise NotImplementedError(f"{func.__name__} under a height split")
        return self._generic(func, args, kwargs)

    # -- rows from the other bands --

    def _whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every band of x along `dim`, in rank order (one all-gather,
        counted; kept on x for its other readers)."""
        whole = getattr(x, _WHOLE, None)
        if whole is None:
            parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                     for _ in range(self.n)]
            tdist.all_gather(parts, x.contiguous(), group=self.group)
            whole = torch.cat(parts, dim)
            setattr(x, _WHOLE, whole)
            self.gathers += 1
        return whole

    def _halo(self, x: torch.Tensor, dim: int, lo: int, below: int,
              fill) -> torch.Tensor:
        """x's band with `lo` rows above and `below` rows below it from
        the neighbouring bands (as many bands up or down as it takes), the
        global map's edges filled with `fill` (a value, or "edge" to repeat
        the edge row); a negative `below` drops rows of the band. Every
        band sends its last a = min(lo, hb) and first b rows in one
        all-gather."""
        hb = x.shape[dim]
        a, b = min(lo, hb), min(max(below, 0), hb)
        parts = None
        if a + b:
            mine = ([x.narrow(dim, hb - a, a)] if a else []) + \
                   ([x.narrow(dim, 0, b)] if b else [])
            edge = torch.cat(mine, dim).contiguous()
            parts = [torch.empty_like(edge) for _ in range(self.n)]
            tdist.all_gather(parts, edge, group=self.group)
        pieces = [x.narrow(dim, 0, hb + min(below, 0))]
        left, j = lo, self.r - 1
        while left > 0:            # from the bands above, nearest first
            if j < 0:
                pieces.insert(0, self._fill(x, dim, left, fill, top=True))
                break
            take = min(left, a)
            pieces.insert(0, parts[j].narrow(dim, a - take, take))
            left, j = left - take, j - 1
        left, j = max(below, 0), self.r + 1
        while left > 0:            # from the bands below
            if j >= self.n:
                pieces.append(self._fill(x, dim, left, fill, top=False))
                break
            take = min(left, b)
            pieces.append(parts[j].narrow(dim, a, take))
            left, j = left - take, j + 1
        return torch.cat(pieces, dim) if len(pieces) > 1 else pieces[0]

    @staticmethod
    def _fill(x, dim, count, fill, top):
        if fill == "edge":
            row = x.narrow(dim, 0 if top else x.shape[dim] - 1, 1)
            return torch.cat([row] * count, dim)
        shape = list(x.shape)
        shape[dim] = count
        return torch.full(shape, fill, dtype=x.dtype, device=x.device)

    # -- the rules --

    def _generic(self, func, args, kwargs):
        flat, spec = tree_flatten((args, kwargs))
        kinds = {_kind(t) for t in flat} - {None}
        if BAND in kinds and FULL in kinds:
            # a replicated map meets a band: cut it to the band
            hb = next(t.shape[2] for t in flat
                      if _kind(t) == BAND and t.dim() == 4)
            flat = [self._cut(t, hb) if _kind(t) == FULL and t.dim() == 4
                    else t for t in flat]
            args, kwargs = tree_unflatten(flat, spec)
        out = func(*args, **kwargs)
        if any(getattr(t, _PAD, None) for t in flat if isinstance(t, torch.Tensor)) \
                and any(isinstance(t, torch.Tensor) for t in tree_flatten(out)[0]):
            raise NotImplementedError(
                f"{getattr(func, '__name__', func)} read a map whose SAME pad "
                f"a window op was to apply, under a height split")
        return _tag(out, BAND if BAND in kinds else FULL if kinds else None)

    def _cut(self, t: torch.Tensor, hb: int) -> torch.Tensor:
        """This rank's rows of the replicated map `t`, which must be the
        whole of a band of `hb` rows: a replicated map of another height
        (code that compared a gathered level's shape with a band's, as
        `Fuse` does where a level was gathered) is refused."""
        if t.shape[2] != hb * self.n:
            raise NotImplementedError(
                f"a replicated map of height {t.shape[2]} meets a band of "
                f"{hb} rows over {self.n}: this model needs every level to "
                f"split into bands at this size")
        return t.narrow(2, self.r * hb, hb)

    def _window(self, func, ba, k: int, s: int, implicit: int, fill,
                ceil_mode: bool = False):
        """A window op of size k and stride s along H with `implicit`
        symmetric H padding, on a band (the SAME pad an F.pad left on it
        included)."""
        x = ba.arguments["input"]
        hb, pend = x.shape[2], getattr(x, _PAD, None)
        H = hb * self.n
        lo = hi = implicit
        if pend is not None:
            t, b, value, band_h = pend
            if (t, b) != _same_pads(band_h, k, s):
                raise NotImplementedError(
                    f"an H pad {(t, b)} that is not SAME for a {k}/{s} window")
            if implicit and value != fill:
                raise NotImplementedError("two pad values along H")
            fill = value
            t, b = _same_pads(H, k, s)
            lo, hi = lo + t, hi + b
        span = H + lo + hi - k
        exact = span % s == 0 or not ceil_mode
        if hb % s == 0 and exact and span // s + 1 == H // s:
            ext = self._halo(x, 2, lo, k - s - lo, fill)
            ba.arguments["input"] = ext
            ba.arguments["padding"] = (0, _pair(ba.arguments["padding"])[1])
            return _tag(func(*ba.args, **ba.kwargs), BAND)
        whole = self._whole(x, 2)
        if pend is not None:
            whole = F.pad(whole, (0, 0, lo - implicit, hi - implicit),
                          value=fill)
        ba.arguments["input"] = whole
        return _tag(func(*ba.args, **ba.kwargs), FULL)

    def _conv(self, func, args, kwargs):
        ba = _CONV(args, kwargs)
        w = ba.arguments["weight"]
        if _pair(ba.arguments["dilation"])[0] != 1:
            raise NotImplementedError("dilated convolution under a height split")
        return self._window(func, ba, w.shape[2], _pair(ba.arguments["stride"])[0],
                            _pair(ba.arguments["padding"])[0], 0.0)

    def _conv_transpose(self, func, args, kwargs):
        """A transposed conv (stride s, kernel k, unpadded, as `Upsample`
        runs it) gives the band its rows of the whole map's output before
        any crop: [s r hb, s r hb + (hb - 1) s + k), what the conv of the
        band alone would span, so a crop the caller reckons from the
        band's height cuts the right rows. They need (k - 1) // s input
        rows above and below; the global edges add none."""
        ba = _CONVT(args, kwargs)
        a = ba.arguments
        if (_pair(a["padding"])[0] or _pair(a["output_padding"])[0]
                or _pair(a["dilation"])[0] != 1):
            raise NotImplementedError("this transposed conv under a height split")
        x, k, s = a["input"], a["weight"].shape[2], _pair(a["stride"])[0]
        hb, halo = x.shape[2], (k - 1) // s
        a["input"] = self._halo(x, 2, halo, halo, 0.0)
        y = func(*ba.args, **ba.kwargs)
        return _tag(y.narrow(2, s * halo, (hb - 1) * s + k), BAND)

    def _max_pool(self, func, args, kwargs):
        ba = _MAX(args, kwargs)
        a = ba.arguments
        k = _pair(a["kernel_size"])[0]
        s = _pair(a["stride"] if a["stride"] not in (None, ()) else a["kernel_size"])[0]
        if _pair(a["dilation"])[0] != 1 or a["return_indices"]:
            raise NotImplementedError("this max pool under a height split")
        return self._window(func, ba, k, s, _pair(a["padding"])[0],
                            float("-inf"), a["ceil_mode"])

    def _avg_pool(self, func, args, kwargs):
        ba = _AVG(args, kwargs)
        a = ba.arguments
        k = _pair(a["kernel_size"])[0]
        s = _pair(a["stride"] if a["stride"] not in (None, ()) else a["kernel_size"])[0]
        if _pair(a["padding"])[0]:
            raise NotImplementedError("a padded average pool under a height split")
        return self._window(func, ba, k, s, 0, 0.0, a["ceil_mode"])

    def _pad(self, func, args, kwargs):
        ba = _PADF(args, kwargs)
        x, pad = ba.arguments["input"], tuple(ba.arguments["pad"])
        if len(pad) < 4 or max(pad[2:4]) <= 0:
            # no H pad, or a crop reckoned from the band's own rows (as
            # `Upsample` crops the transposed conv's rows): local
            return _tag(func(*args, **kwargs), BAND)
        if (ba.arguments["mode"] != "constant" or len(pad) > 4
                or min(pad[2:4]) < 0):
            raise NotImplementedError(f"an H pad {pad[2:4]} in mode "
                                      f"{ba.arguments['mode']!r} on a band")
        value = ba.arguments["value"]
        y = func(x, pad[:2], value=value)
        setattr(y, _PAD, (pad[2], pad[3], 0.0 if value is None else value,
                          x.shape[2]))
        return _tag(y, BAND)

    def _interpolate(self, func, args, kwargs):
        ba = _INTERP(args, kwargs)
        a = ba.arguments
        x, size, sf = a["input"], a["size"], a["scale_factor"]
        hb = x.shape[2]
        if size is not None:
            size = _pair(size)
            q = size[0] / hb
        else:
            sf = _pair(sf) if not isinstance(sf, float) else (sf, sf)
            q = float(sf[0])
        if a["mode"] in ("nearest", "nearest-exact") and q.is_integer():
            return _tag(func(*args, **kwargs), BAND)
        if (a["mode"] == "bilinear" and not a["align_corners"]
                and q.is_integer() and not a["antialias"]):
            q = int(q)
            w_out = size[1] if size is not None else int(x.shape[3] * sf[1])
            ext = self._halo(x, 2, 1, 1, "edge")
            y = func(ext, size=(q * (hb + 2), w_out), mode="bilinear",
                     align_corners=False)
            return _tag(y.narrow(2, q, q * hb), BAND)
        raise NotImplementedError(f"a {a['mode']} resize by {q} under a "
                                  f"height split")

    def _reduce(self, func, args, kwargs):
        ba = _REDUCE(args, kwargs)
        x, dims = ba.arguments["input"], ba.arguments["dim"]
        dims = (range(x.dim()) if dims is None else
                [dims] if isinstance(dims, int) else dims)
        if x.dim() != 4 or 2 not in [d % 4 for d in dims]:
            return self._generic(func, args, kwargs)
        total = func(*args, **kwargs).float()
        tdist.all_reduce(total, group=self.group)
        if func in (torch.Tensor.mean, torch.mean):
            total = total / self.n
        return total.to(x.dtype if ba.arguments["dtype"] is None
                        else ba.arguments["dtype"])

    def _dcn(self, binder, func, args, kwargs):
        """The bounded engines reach d + 1 rows above and below a pixel:
        the band with that halo (zeros at the global edges, as the
        engines' own zero padding), the planes padded alike, cut back."""
        ba = binder(args, kwargs)
        a = ba.arguments
        d, x = a["d"], a["x"]
        if any(_kind(a[k]) == FULL for k in ("a0", "b0", "fy", "fx", "wm")):
            raise NotImplementedError("DCN planes of a replicated map on a band")
        halo, hb = d + 1, x.shape[1]
        a["x"] = self._halo(x, 1, halo, halo, 0.0)
        for key in ("a0", "b0", "fy", "fx", "wm"):
            a[key] = F.pad(a[key], (0, 0, 0, 0, halo, halo)).contiguous()
        a["x"] = a["x"].contiguous()
        y = func(*ba.args, **ba.kwargs)
        return _tag(y.narrow(1, halo, hb).contiguous(), BAND)

    def _exact(self, func, args, kwargs):
        """The exact engines' offsets are unbounded: the whole map, then
        the band's rows of the result."""
        ba = _EXACT(args, kwargs)
        a = ba.arguments
        hb = a["x"].shape[1]
        for key in ("x", "offsets", "mask"):
            if a[key] is not None:
                a[key] = self._whole(a[key], 1)
        y = func(*ba.args, **ba.kwargs)
        return _tag(y.narrow(1, self.r * hb, hb).contiguous(), BAND)


def spatial_forward(model: nn.Module, images: torch.Tensor,
                    mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The eval forward of `model` on this rank's band of NHWC `images`
    (`split_rows(images, mesh)`), the height split over the model group.
    Returns the heads' NHWC maps: this rank's band of each, or the whole
    map where a level was gathered. Adds the maps it gathered whole to
    `spatial_forward.gathers`."""
    if model.training:
        raise ValueError("the height split is a forward for serving and "
                         "eval: call model.eval() first")
    if mesh.n_model == 1:
        return model(images)
    mode = _Bands(mesh)
    images = images.view_as(images)
    setattr(images, _KIND, BAND)
    with mode:
        out = model(images)
    spatial_forward.gathers += mode.gathers
    return out


spatial_forward.gathers = 0


def gather_bands(maps: Dict[str, torch.Tensor],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Each band of the NHWC `maps` all-gathered along H over the model
    group; maps already whole pass as they are."""
    if mesh.n_model == 1:
        return dict(maps)
    out = {}
    for k, v in maps.items():
        if _kind(v) != BAND:
            out[k] = v
            continue
        parts = [torch.empty_like(v, memory_format=torch.contiguous_format)
                 for _ in range(mesh.n_model)]
        tdist.all_gather(parts, v.contiguous(), group=mesh.model_group)
        out[k] = torch.cat(parts, 1)
    return out


def spatial_detect(task, model: nn.Module, images: torch.Tensor,
                   mesh: Mesh) -> Dict[str, torch.Tensor]:
    """`spatial_forward`, the heads gathered whole (`gather_bands`), then
    the task's decode from logits on every rank of the model group (on the
    card through the peak kernel, once a batch)."""
    out = gather_bands(spatial_forward(model, images, mesh), mesh)
    return task.decode_detections(out["heatmap"], out["box_2d"],
                                  reid=out.get("reid"), from_logits=True)
