"""JAX package weights -> this package's state dict.

`variables_to_state_dict` takes the `{"params", "batch_stats"}` tree of
`centernet_lightning_tpu` (leaves as numpy arrays, or anything
`np.asarray` reads) and returns the `state_dict` of the port's
`GenericModel`, ready for `load_state_dict(..., strict=True)`:

  - convolution kernels HWIO -> OIHW;
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
    plus `num_batches_tracked` = 0;
  - scopes: `heads_<name>` -> `heads.<name>`; `ConvNormAct_<i>` ->
    `blocks.<i>` (with `Conv_0`/`BatchNorm_0` -> `conv`/`bn`); ResNet
    `stem_conv`/`stem_bn` -> `conv1`/`bn1`, `layer<s>_block<b>` ->
    `layer<s>.<b>` (with `Conv_<i>`/`BatchNorm_<i>` -> `conv<i+1>`/`bn<i+1>`
    and `downsample_conv`/`downsample_bn` -> `downsample.0`/`downsample.1`).

A scope this slice does not port (DCN, Fuse, SPP, reid classifier) raises
KeyError rather than being dropped.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["variables_to_state_dict"]

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var"}


def _scope(name: str, parent: str) -> str:
    if name.startswith("heads_"):
        return "heads." + name[len("heads_"):]
    if name in ("backbone", "neck", "out_conv"):
        return name
    if name == "stem_conv":
        return "conv1"
    if name == "stem_bn":
        return "bn1"
    m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
    if m:
        return f"layer{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"ConvNormAct_(\d+)", name)
    if m:
        return f"blocks.{m.group(1)}"
    m = re.fullmatch(r"(Conv|BatchNorm)_(\d+)", name)
    if m and parent.startswith("ConvNormAct_") and m.group(2) == "0":
        return "conv" if m.group(1) == "Conv" else "bn"
    if m and re.fullmatch(r"layer\d+_block\d+", parent):
        i = int(m.group(2)) + 1
        return f"conv{i}" if m.group(1) == "Conv" else f"bn{i}"
    if name == "downsample_conv":
        return "downsample.0"
    if name == "downsample_bn":
        return "downsample.1"
    raise KeyError(f"no port of flax scope {parent}/{name} in this slice")


def _walk(tree: Dict[str, Any], path: Tuple[str, ...] = ()
          ) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_walk(v, path + (k,)))
        else:
            out.append((path + (k,), v))
    return out


def _torch_key(path: Tuple[str, ...]) -> str:
    parts = []
    for i, name in enumerate(path[:-1]):
        parts.append(_scope(name, path[i - 1] if i else ""))
    leaf = path[-1]
    if leaf not in _LEAF:
        raise KeyError(f"no port of flax leaf {'/'.join(path)}")
    return ".".join(parts + [_LEAF[leaf]])


def variables_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables of the JAX GenericModel -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(col, {})):
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                if arr.ndim != 4:
                    raise KeyError(f"no port of dense kernel {'/'.join(path)}")
                arr = arr.transpose(3, 2, 0, 1)             # HWIO -> OIHW
            sd[_torch_key(path)] = torch.from_numpy(np.array(arr))  # own copy
            if path[-1] == "mean":
                prefix = _torch_key(path).rsplit(".", 1)[0]
                sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd
