"""JAX package weights -> this package's state dict.

`variables_to_state_dict` takes the `{"params", "batch_stats"}` tree of
`centernet_lightning_tpu` (leaves as numpy arrays, or anything
`np.asarray` reads) and returns the `state_dict` of the port's
`GenericModel`, ready for `load_state_dict(..., strict=True)`:

  - convolution kernels HWIO -> OIHW;
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
    plus `num_batches_tracked` = 0;
  - scopes: `heads_<name>` -> `heads.<name>` (FairMOT's `heads_reid`
    too); `extra_block` keeps its name; `classifier` keeps its name, with
    `Dense_0`/`BatchNorm_0`/`Dense_1` -> `fc1`/`bn`/`fc2`;
    `ConvNormAct_<i>` -> `blocks.<i>` (with `Conv_0`/`BatchNorm_0` ->
    `conv`/`bn`, as inside `DarkConv_<i>` and `ConvBN_<i>`, which are
    `convs.<i>`); `CSPStage_<i>`, `ResBlock_<i>`, `InvertedResidual_<i>`
    -> `blocks.<i>`; `SqueezeExcite_0` -> `se` (`Conv_0`/`Conv_1` with
    bias -> `reduce`/`expand`); `Upsample_<j>` -> `upsamples.<j>` (with
    `ConvTranspose_0`/`BatchNorm_0` -> `conv`/`bn`); `Fuse_<j>` ->
    `fuses.<j>` (leaf `fuse_weights`); ResNet `stem_conv`/`stem_bn` ->
    `conv1`/`bn1`, `layer<s>_block<b>` -> `layer<s>.<b>` (with
    `Conv_<i>`/`BatchNorm_<i>` -> `conv<i+1>`/`bn<i+1>` and
    `downsample_conv`/`downsample_bn` -> `downsample.0`/`downsample.1`);
    VoVNet `OSABlock_<i>` -> `blocks.<i>` (with `ConvBN_<j>` -> `convs.<j>`
    and `ESE_0` -> `ese`, its `Conv_0` -> `conv`); EfficientNet
    `ConvBNSiLU_<i>` -> `convs.<i>` (`conv`/`bn`), `MBConv_<i>` ->
    `blocks.<i>`, `SqueezeExciteSiLU_0` -> `se` (`reduce`/`expand`); DLA's
    named scopes keep their names (`base_conv`, `level0_bn1`, `level3`,
    `tree1`, `tree2`, `root` (`Conv_0`/`BatchNorm_0` -> `conv`/`bn`),
    `project_conv`, `project_bn`), a basic block's (`tree1`/`tree2` of a
    levels-1 Tree) `Conv_<i>`/`BatchNorm_<i>` -> `conv<i+1>`/`bn<i+1>`;
  - kernels: convolutions HWIO -> OIHW (a depthwise (k, k, 1, C) becomes
    (C, 1, k, k)); a transpose conv's (k, k, in, out), which flax applies
    unflipped, -> flip(kernel, (0, 1)) as (in, out, k, k), since torch
    flips it; a Dense kernel (in, out) -> its transpose (out, in);
  - DCN and separable blocks: flax counts `DeformableConvBlock_<j>` and
    `SeparableConvNormAct_<j>` apart from `ConvNormAct_<i>`, and every
    `blocks` list of the port holds its plain blocks first (SimpleNeck
    keeps a plan where its calls interleave them), so such a block is
    `blocks.<P + j>`, P being the number of `ConvNormAct_*` beside it.
    Inside a DCN block, `Conv_0`/`Conv_1`/`BatchNorm_0` ->
    `conv_offset`/`conv_mask`/`bn`, and the tap-major `kernel` (k^2 C, O)
    and `bias` -> `deform.weight` (O, C, k, k) and `deform.bias`.

A scope the port does not have raises KeyError rather than being
dropped.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = ["module_name", "variables_to_state_dict"]

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var",
         "fuse_weights": "fuse_weights"}
# scopes numbered within their parent -> the port's list
_LISTS = {"ConvNormAct": "blocks", "CSPStage": "blocks", "ResBlock": "blocks",
          "InvertedResidual": "blocks", "OSABlock": "blocks", "MBConv": "blocks",
          "DarkConv": "convs", "ConvBN": "convs", "ConvBNSiLU": "convs",
          "Upsample": "upsamples", "Fuse": "fuses"}
# children of a scope class, by flax name
_CHILDREN = {
    "DeformableConvBlock": {"Conv_0": "conv_offset", "Conv_1": "conv_mask",
                            "BatchNorm_0": "bn"},
    "SqueezeExcite": {"Conv_0": "reduce", "Conv_1": "expand"},
    "SqueezeExciteSiLU": {"Conv_0": "reduce", "Conv_1": "expand"},
    "ESE": {"Conv_0": "conv"},
    "root": {"Conv_0": "conv", "BatchNorm_0": "bn"},
    "Upsample": {"ConvTranspose_0": "conv", "BatchNorm_0": "bn"},
    "classifier": {"Dense_0": "fc1", "BatchNorm_0": "bn", "Dense_1": "fc2"},
    **{cls: {"Conv_0": "conv", "BatchNorm_0": "bn"}
       for cls in ("ConvNormAct", "DarkConv", "ConvBN", "ConvBNSiLU")},
}
_PLAIN_RE = re.compile(r"ConvNormAct_\d+")
# DLA's scopes, named in flax, keep their names
_DLA_RE = re.compile(r"(base|level\d+)_(conv|bn)\d*|level\d+|tree[12]|root"
                     r"|project_(conv|bn)")
# parents whose Conv_<i> / BatchNorm_<i> are conv<i+1> / bn<i+1>: a ResNet
# block, and a DLA basic block (a levels-1 Tree's `tree1` / `tree2`)
_BLOCK_RE = re.compile(r"layer\d+_block\d+|tree[12]")


def _scope(name: str, parent: str, siblings) -> str:
    """Torch name of the flax scope `name` inside `parent`, whose params
    subtree holds `siblings`."""
    if name.startswith("heads_"):
        return "heads." + name[len("heads_"):]
    if name in ("backbone", "neck", "out_conv", "extra_block", "classifier"):
        return name
    if name == "stem_conv":
        return "conv1"
    if name == "stem_bn":
        return "bn1"
    if name in ("SqueezeExcite_0", "SqueezeExciteSiLU_0"):
        return "se"
    if name == "ESE_0":
        return "ese"
    m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}"
    parent_cls = parent.rsplit("_", 1)[0]
    if name in _CHILDREN.get(parent_cls, {}):
        return _CHILDREN[parent_cls][name]
    m = re.fullmatch(r"(\w+?)_(\d+)", name)
    if m and m.group(1) in _LISTS:
        return f"{_LISTS[m.group(1)]}.{m.group(2)}"
    if m and m.group(1) in ("DeformableConvBlock", "SeparableConvNormAct"):
        plain = sum(1 for s in siblings if _PLAIN_RE.fullmatch(s))
        return f"blocks.{plain + int(m.group(2))}"
    m = re.fullmatch(r"(Conv|BatchNorm)_(\d+)", name)
    if m and _BLOCK_RE.fullmatch(parent):
        i = int(m.group(2)) + 1
        return f"conv{i}" if m.group(1) == "Conv" else f"bn{i}"
    if name == "downsample_conv":
        return "downsample.0"
    if name == "downsample_bn":
        return "downsample.1"
    if _DLA_RE.fullmatch(name):
        return name
    raise KeyError(f"no port of flax scope {parent}/{name}")


def _walk(tree: Dict[str, Any], path: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _torch_key(path: Tuple[str, ...], params: Dict[str, Any]) -> str:
    """Torch key of the flax leaf at `path`; scopes are resolved against
    the params tree, which holds every scope (batch_stats only those with
    a BatchNorm)."""
    parts = []
    node = params
    for i, name in enumerate(path[:-1]):
        parts.append(_scope(name, path[i - 1] if i else "", node))
        node = node.get(name, {})
    leaf = path[-1]
    if leaf not in _LEAF:
        raise KeyError(f"no port of flax leaf {'/'.join(path)}")
    if len(path) > 1 and path[-2].startswith("DeformableConvBlock_"):
        return ".".join(parts + ["deform", _LEAF[leaf]])
    return ".".join(parts + [_LEAF[leaf]])


def _kernel(path: Tuple[str, ...], arr: np.ndarray, params) -> np.ndarray:
    if arr.ndim == 4 and len(path) > 1 and path[-2].startswith("ConvTranspose"):
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)        # flip, -> (I, O, k, k)
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)                    # HWIO -> OIHW
    if arr.ndim == 2 and re.fullmatch(r"Dense_\d+", path[-2]):
        return arr.T                                        # (in, out) -> (out, in)
    if arr.ndim == 2 and path[-2].startswith("DeformableConvBlock_"):
        # tap-major (k*k*C, O), row (ty*k + tx)*C + c -> (O, C, k, k); the
        # offset conv beside it gives k and C
        node = params
        for name in path[:-1]:
            node = node[name]
        k, _, c, _ = np.shape(node["Conv_0"]["kernel"])
        return arr.reshape(k, k, c, -1).transpose(3, 2, 0, 1)
    raise KeyError(f"no port of dense kernel {'/'.join(path)}")


def variables_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables of the JAX GenericModel -> the port's state_dict."""
    params = variables.get("params", {})
    sd: Dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(col, {})):
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                arr = _kernel(path, arr, params)
            key = _torch_key(path, params)
            sd[key] = torch.from_numpy(np.array(arr))      # own copy
            if path[-1] == "mean":
                sd[f"{key.rsplit('.', 1)[0]}.num_batches_tracked"] = torch.tensor(0)
    return sd


def module_name(flax_path: str, params: Dict[str, Any]) -> str:
    """The port's module name of the flax module at `flax_path`
    ("backbone/stem_conv"), a scope of the `params` tree (how the JAX
    package's quantize.py keys its scales)."""
    path = tuple(flax_path.split("/"))
    node = params
    for name in path:
        node = node[name]
    return _torch_key(path + (next(iter(node)),), params).rsplit(".", 1)[0]
