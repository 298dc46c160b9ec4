"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_port_*).

Inputs and weights are made with seeded numpy and handed to both packages;
JAX runs on the CPU and the port with device="cpu".
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from centernet_lightning_torch.utils.convert import variables_to_state_dict


# The tests run beside other test processes (pytest-xdist) on small
# models: torch on one intra-op thread keeps the processes from
# oversubscribing the cores. Every worker imports this module as it
# collects the port's tests.
torch.set_num_threads(1)


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
    """A BatchNorm scope: flax's `BatchNorm_<i>`, or one named `*_bn` or
    `*_bn<i>` (ResNet's `stem_bn`, DLA's `base_bn`, `level0_bn0`)."""
    keys = [getattr(p, "key", "") for p in path]
    return any("BatchNorm" in k or re.search(r"_bn\d*$", k) for k in keys)


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


NARROW_DARKNET = {"stage_blocks": (1, 2, 1, 1, 1),
                  "stage_filters": (16, 24, 32, 40, 48)}


def backbone_parity(j, t, x, rng, tol=dict(rtol=1e-4, atol=1e-4), jit=False):
    """A flax backbone and the port's on the same input and converted
    weights (BatchNorm perturbed): the pyramids must agree within `tol`.
    `jit` draws the weights from the traced parameter shapes
    (`random_module_variables`) and compiles the flax apply whole, which
    is faster than initialising and applying op by op for a deep
    backbone. Returns the port's pyramid."""
    if jit:
        v, apply = random_module_variables(j, x, rng), jax.jit(j.apply)
    else:
        v, apply = perturb_batch_norm(to_numpy_tree(
            j.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng), j.apply
    t.load_state_dict(scoped_state_dict(v, "backbone", "backbone."),
                      strict=True)
    t.eval()
    refs = apply(v, jnp.asarray(x))
    with torch.no_grad():
        gots = t(nchw(x))
    assert list(t.out_channels) == list(j.out_channels)
    assert len(gots) == len(refs) == 4
    for ref, got in zip(refs, gots):
        assert got.shape[1] == np.shape(ref)[-1]
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), **tol)
    return gots


def jax_param_count(j, shape=(1, 64, 64, 3)) -> int:
    """Parameters of a flax module, traced (`jax.eval_shape`), not run."""
    tree = jax.eval_shape(j.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(shape, jnp.float32))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(tree["params"]))


def serving_slice_parity(model_cfg, rng, size=64, min_distinct=10):
    """The whole serving slice of `model_cfg` (a model config dict) on
    seeded uint8 images: the port's `build_centernet` (on the CPU) and its
    `gather_detection2d`, against the JAX model with the same weights
    (`random_flax_variables`, traced rather than initialised; the heatmap
    head's output kernel scaled to logits of std 1.5) applied to the same
    preprocessed images, and its decode of them. Head logits within rtol
    1e-4 / atol 1e-4 of their largest magnitude; the detections as
    `assert_detections_match` holds them. Returns the port's predictor."""
    from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
    from centernet_lightning_tpu.ops.preprocess import preprocess

    from centernet_lightning_torch import build_centernet as t_build

    cfg = dict(model_cfg, image_size=[size, size])
    jtask = JCenterNet(**{k: v for k, v in cfg.items()
                          if k in JCenterNet.__dataclass_fields__})
    variables = random_flax_variables(jtask, rng, image_size=(size, size))
    tp = t_build({"model": cfg}, device="cpu")
    images = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    x = np.array(preprocess(jnp.asarray(images)))
    # scale the heatmap head's output kernel so its logits have a std near
    # 1.5: seeded weights reach logits in the hundreds on some models
    # (DLA), whose scores then all tie at 1.0
    tp.model.load_state_dict(variables_to_state_dict(variables), strict=True)
    with torch.no_grad():
        std = tp(x)["heatmap"].std().item()
    out_conv = variables["params"]["heads_heatmap"]["out_conv"]
    out_conv["kernel"] = (out_conv["kernel"] * (1.5 / std)).astype(np.float32)
    tp.model.load_state_dict(variables_to_state_dict(variables), strict=True)
    ref_enc = jax.jit(jtask.model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got_enc = tp(x)
    for key in ("heatmap", "box_2d"):
        r = np.asarray(ref_enc[key])
        np.testing.assert_allclose(got_enc[key].numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=key)
    ref = jtask.decode_detections(ref_enc["heatmap"], ref_enc["box_2d"],
                                  from_logits=True)
    got = tp.gather_detection2d(images)
    ref = {"bboxes" if k == "boxes" else k: np.asarray(v) for k, v in ref.items()}
    assert_detections_match(ref, got,
                            min_distinct=min_distinct, rtol=1e-4, atol=1e-4)
    return tp


def random_flax_variables(task, rng, image_size=(32, 32)):
    """Seeded variables in the shapes of a JAX task's model, traced rather
    than run: convolution kernels he-normal over their fan-in, biases
    small, BatchNorm near the identity with non-trivial statistics, and
    the heatmap head's bias at the prior. Numpy leaves."""
    return _draw_variables(jax.eval_shape(
        lambda key: task.init(key, image_size=image_size),
        jax.random.PRNGKey(0)), rng)


def random_module_variables(module, x, rng):
    """`random_flax_variables` for a flax module applied to `x`."""
    return _draw_variables(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                          jnp.asarray(x)), rng)


def _draw_variables(shapes, rng):

    def draw(path, s):
        keys = [getattr(p, "key", "") for p in path]
        name = keys[-1]
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(scale=np.sqrt(2.0 / fan_in), size=s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, s.shape)
        if name == "bias" and "heads_heatmap" in keys and "out_conv" in keys:
            return np.full(s.shape, -2.19)
        return rng.normal(0.0, 0.05, s.shape)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), variables)


TRAIN_CFG = dict(num_classes=5, backbone="resnet18", neck="FPN",
                 neck_config={"out_channels": 32},
                 head_config={"width": 32, "depth": 1}, box_loss="GIoULoss",
                 box_log=True, box_multiplier=4.0, box_loss_weight=5.0,
                 image_size=(64, 64))
# Learning rates: the two frameworks' f32 gradients differ by rounding,
# and where an activation sits within that rounding of a ReLU's kink, or
# a gradient element within it of zero (Adam's step is then about +-lr
# either way), one step's updates differ; the trajectories then drift
# apart in proportion to the learning rate. These rates keep three steps'
# drift inside the tolerances (test_torch_port_train.py); the update
# rules themselves are held to optax at rtol 1e-6 (test_torch_port_optim.py).
TRAIN_OPT = {"SGD": dict(optimizer="SGD", lr=1e-4),
             "AdamW": dict(optimizer="AdamW", lr=2e-6)}


def detection_batch(rng, n=2, k=8, size=64, num_classes=5):
    """A CollateDetection batch of seeded numpy arrays: uint8 images and
    k padded xywh boxes a image, about 60% of them valid."""
    xy = rng.uniform(0, size * 0.6, size=(n, k, 2))
    wh = rng.uniform(6, size * 0.4, size=(n, k, 2))
    mask = (rng.uniform(size=(n, k)) < 0.6).astype(np.float32)
    mask[:, 0] = 1.0
    return {"image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "boxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "labels": rng.integers(0, num_classes, (n, k)).astype(np.int32),
            "mask": mask}


def _calibrate_dcn(variables, offset_scale=0.03, mask_scale=0.01):
    """Scale the DCN blocks' offset (Conv_0) and mask (Conv_1) convolutions
    of `random_flax_variables`. The maps they read reach magnitudes near
    50, so unscaled offsets have a std near 75 and a 1e-7 change of the
    input moves the logits by 2e-4 of their size; scaled, the offsets' std
    is 0.5-2.3 over the three layers (many past +-1) and the model is as
    well conditioned as with plain merges (6e-6)."""
    def scale(path, x):
        keys = [getattr(p, "key", "") for p in path]
        if any(k.startswith("DeformableConvBlock") for k in keys):
            if "Conv_0" in keys:
                return (x * offset_scale).astype(np.float32)
            if "Conv_1" in keys:
                return (x * mask_scale).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(scale, variables)


def train_step_parity(optimizer: str, frozen_stages: int, steps: int = 3,
                      conv_type: str = "normal", model=None):
    """Three train steps of the JAX package and of the port from the same
    weights on the same batches (see test_torch_port_train.py); `conv_type`
    sets the FPN's merge blocks (the DCN engines) and `model` replaces
    entries of the task's config (another backbone)."""
    import jax.numpy as jnp

    from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
    from centernet_lightning_tpu.train.optim import make_optimizer as j_make
    from centernet_lightning_tpu.train.state import TrainState as JState
    from centernet_lightning_tpu.train.state import make_train_step as j_step

    from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
    from centernet_lightning_torch.train import optim as t_optim
    from centernet_lightning_torch.train import state as t_state

    cfg = dict(TRAIN_CFG, backbone_config={"frozen_stages": frozen_stages},
               neck_config=dict(TRAIN_CFG["neck_config"], conv_type=conv_type))
    cfg.update(model or {})
    opt = dict(TRAIN_OPT[optimizer], weight_decay=1e-3, norm_weight_decay=0.0,
               warmup_epochs=1, warmup_decay=0.1, max_epochs=3,
               steps_per_epoch=2, frozen_stages=frozen_stages)
    rng = np.random.default_rng(100 + frozen_stages)
    jtask = JCenterNet(**cfg)
    variables = random_flax_variables(jtask, rng)
    if conv_type != "normal":
        variables = _calibrate_dcn(variables)
    tx = j_make(variables["params"], **opt)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]), tx=tx,
                    ema_params=variables["params"])
    jstep = j_step(jtask, donate=False, ema_decay=0.9)

    ttask = TCenterNet(**cfg)
    model = ttask.model.to(memory_format=torch.channels_last)
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    tstate = t_state.TrainState(model=model,
                                tx=t_optim.make_optimizer(model, **opt))
    tstate.init_ema()
    tstep = t_state.make_train_step(ttask, ema_decay=0.9)

    for step in range(steps):
        batch = detection_batch(rng)
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tl = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("heatmap", "box_2d", "total"):
            np.testing.assert_allclose(float(tl[key]), float(jl[key]), rtol=1e-5,
                                       err_msg=f"{key} loss, step {step}")
    def close(got_t, ref_t, key):
        ref_a = ref_t.numpy()
        np.testing.assert_allclose(got_t.numpy(), ref_a, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref_a).max()),
                                   err_msg=key)

    ref = variables_to_state_dict({"params": to_numpy_tree(jstate.params),
                                   "batch_stats": to_numpy_tree(jstate.batch_stats)})
    start = variables_to_state_dict(variables)
    got = model.state_dict()
    moved = 0
    for key, value in ref.items():
        if not key.endswith("num_batches_tracked"):
            close(got[key], value, key)
            moved += not torch.equal(got[key], start[key])
    assert moved > len(ref) // 2
    ema = variables_to_state_dict({"params": to_numpy_tree(jstate.ema_params)})
    for key, value in ema.items():
        close(tstate.ema_params[key], value, f"ema {key}")
    if frozen_stages:
        frozen = [k for k, lab in tstate.tx.labels.items() if lab == "frozen"]
        assert frozen and all(torch.equal(got[k], start[k]) for k in frozen)
        for k in ("backbone.bn1.running_mean", "backbone.layer1.0.bn1.running_var"):
            assert torch.equal(got[k], start[k]), k


# ---- the JAX package's own tests, run against the port ---------------------

JAX_PKG, PORT_PKG = "centernet_lightning_tpu", "centernet_lightning_torch"


def _port_module(name: str):
    import importlib

    return importlib.import_module(PORT_PKG + name[len(JAX_PKG):])


def on_port(fn, monkeypatch, modules=()):
    """`fn`, a test function of the JAX package's test suite, rebound to
    the port: each global it reads from the JAX package (a class, function
    or module) becomes the port's object of the same name, helper functions
    of its test module are rebound the same way, and, for the duration of
    the test (`monkeypatch`), importing one of `modules` (JAX package
    module names) inside it imports the port's module of the same path.
    A name the port lacks raises."""
    import importlib
    import sys
    import types

    parents = {}
    for name in modules:
        parent, _, leaf = name.rpartition(".")
        parents[name] = (importlib.import_module(parent), leaf)
    for name in modules:
        port = _port_module(name)
        monkeypatch.setitem(sys.modules, name, port)
        # `import a.b.c as m` reads the attributes of the real packages
        monkeypatch.setattr(*parents[name], port)
    source = fn.__globals__
    rebound = dict(source)
    for key, obj in source.items():
        if isinstance(obj, types.ModuleType):
            if obj.__name__.split(".")[0] == JAX_PKG:
                rebound[key] = _port_module(obj.__name__)
            continue
        origin = getattr(obj, "__module__", None)
        if isinstance(origin, str) and origin.split(".")[0] == JAX_PKG:
            rebound[key] = getattr(_port_module(origin),
                                   getattr(obj, "__name__", key))
        elif isinstance(obj, types.FunctionType) and origin == source["__name__"]:
            rebound[key] = types.FunctionType(obj.__code__, rebound, obj.__name__,
                                              obj.__defaults__, obj.__closure__)
    return types.FunctionType(fn.__code__, rebound, fn.__name__,
                              fn.__defaults__, fn.__closure__)


def jax_test_names(module):
    """The names of `module`'s test functions, in file order."""
    import inspect

    return [name for name, obj in vars(module).items()
            if name.startswith("test_") and inspect.isfunction(obj)]


def run_on_port(module, name, request, monkeypatch, modules):
    """Run `module.<name>` (a JAX package test; "Class.method" for a method
    of a test class) against the port, its fixtures drawn from `request`."""
    import inspect

    owner, _, attr = name.rpartition(".")
    fn = getattr(getattr(module, owner), attr) if owner else getattr(module, name)
    bound = on_port(fn, monkeypatch, modules)
    params = list(inspect.signature(fn).parameters)
    args = []
    if owner:
        args.append(getattr(module, owner)())
        params = params[1:]
    args += [monkeypatch if p == "monkeypatch" else request.getfixturevalue(p)
             for p in params]
    return bound(*args)
