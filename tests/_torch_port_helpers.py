"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_port_*).

Inputs and weights are made with seeded numpy and handed to both packages;
JAX runs on the CPU and the port with device="cpu".
"""
import jax
import numpy as np
import torch

from centernet_lightning_torch.utils.convert import variables_to_state_dict


def to_numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def perturb_batch_norm(variables, rng):
    """Give every BatchNorm non-trivial statistics and affine terms, so the
    zero-initialised last BN of each residual block does not hide a branch.
    Values stay near the identity to keep activations O(1)."""
    def draw(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        if name in ("mean", "bias") and x.ndim == 1 and _is_bn(path):
            return rng.normal(0.0, 0.05, x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(draw, variables)


def _is_bn(path) -> bool:
    keys = [getattr(p, "key", "") for p in path]
    return any("BatchNorm" in k or k.endswith("_bn") for k in keys)


def perturb_dcn(variables, rng, target=1.5):
    """Random offset and mask convolutions (zero at init) whose outputs
    have a std near `target` for O(1) inputs, so offsets reach past +-1."""
    def draw(path, x):
        keys = [getattr(p, "key", "") for p in path]
        # a block's own tree is {"params": {"Conv_0": ...}}
        if (len(keys) >= 3 and keys[-2] in ("Conv_0", "Conv_1")
                and (keys[-3].startswith("DeformableConvBlock")
                     or len(keys) == 3)):
            x = np.asarray(x)
            if keys[-1] == "kernel":
                fan_in = x.shape[0] * x.shape[1] * x.shape[2]
                return rng.normal(scale=target / np.sqrt(fan_in),
                                  size=x.shape).astype(np.float32)
            return rng.normal(scale=0.3 * target, size=x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(draw, variables)


def init_flax_dcn(module, x, rng, **kwargs):
    """Initialise a flax module, then give it non-trivial BatchNorm and
    DCN offset/mask weights (numpy leaves)."""
    v = to_numpy_tree(module.init(jax.random.PRNGKey(0), x, **kwargs))
    return perturb_dcn(perturb_batch_norm(v, rng), rng)


def scoped_state_dict(variables, scope: str, prefix: str):
    """Convert the variables of one flax submodule by nesting them under
    the flax `scope` it would have in a model, then strip the torch
    `prefix` that scope maps to."""
    nested = {col: {scope: tree} for col, tree in variables.items()}
    sd = variables_to_state_dict(nested)
    return {k[len(prefix):]: v for k, v in sd.items()}


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def assert_detections_match(ref, got, rtol=1e-6, atol=1e-6, min_distinct=1):
    """Top-k outputs of the JAX package (`ref`) and the port (`got`).

    The sorted scores must agree everywhere. `lax.top_k` orders equal
    scores by index and `torch.topk` promises no order, so indices, labels
    and boxes are compared only on entries whose score stands apart (by
    more than the tolerance) from every other score of its row and from the
    k-th score; the tied rest is compared as a multiset of scores.
    """
    box_key = "boxes" if "boxes" in ref else "bboxes"
    rs, gs = np.asarray(ref["scores"]), np.asarray(got["scores"])
    assert rs.shape == gs.shape
    np.testing.assert_allclose(gs, rs, rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(rs)
    distinct = 0
    for n in range(rs.shape[0]):
        row = rs[n]
        gap = np.abs(row[:, None] - row[None, :])
        np.fill_diagonal(gap, np.inf)
        apart = (gap.min(axis=1) > 2 * tol[n]) & (row - row[-1] > 2 * tol[n])
        distinct += int(apart.sum())
        for key in ("labels", "indices"):
            if key in ref:
                np.testing.assert_array_equal(np.asarray(got[key])[n][apart],
                                              np.asarray(ref[key])[n][apart])
        np.testing.assert_allclose(np.asarray(got[box_key])[n][apart],
                                   np.asarray(ref[box_key])[n][apart],
                                   rtol=max(rtol, 1e-5), atol=max(atol, 1e-5))
        np.testing.assert_allclose(np.sort(gs[n][~apart]),
                                   np.sort(row[~apart]), rtol=rtol, atol=atol)
    assert distinct >= min_distinct, "comparison had no untied entries"
