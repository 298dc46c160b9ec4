"""PyTorch port: the (data, model) grid of parallel/mesh.py against the JAX
package, on the CPU.

Four gloo ranks (tests/_torch_port_parallel_worker.py, scenario "mesh")
run twice, once a geometry:

- a (1, 4) grid: the height split (`spatial_forward`, H over 4 bands, the
  heads gathered by `gather_bands`) against the JAX package's unsharded
  forward on the same (converted) weights at rtol 1e-4 and atol 1e-4 of the
  map's largest magnitude (at least 1e-4; seeded full-width weights give
  maps of magnitude up to about 460, and two frameworks' f32 sums differ in
  proportion to them; the JAX package's tests/test_spatial_sharding.py
  compares JAX with JAX at 1e-4), and against the port's own forward on the
  whole images at a tenth of that atol: its own model at 128² (no map
  gathered whole) and at its own 64² (the stride-32 level, one row a band,
  is gathered whole once, and the counter says so); a CSPDarknet with SPP
  (pools up to 13: halos from several bands up and down) and mish; a model
  whose heads are bounded DCN blocks (d + 1 halo rows); narrow
  EfficientNet-B0 (squeeze-excite means over H), VoVNet-19 with bilinear
  upsampling, MobileNetV2 with transposed-conv upsampling, BiFPN and DLA-34
  IDA at 128² (and BiFPN and IDA at 64², where a gathered level meets a band
  in `Fuse`, refused). The column-parallel forward of an FPN-256 model
  within 1e-4, its split weights the set that JAX's `spec_for` picks. The
  column-parallel SGD step against the JAX step on the global batch;
- a (2, 4 / 2) grid: the step with replicated weights and with
  `model_parallel=True`, against the JAX step on the global batch at
  test_torch_port_parallel_step.py's tolerances.

In both, a channel gather whose backward is a reduce-scatter (the
cotangent summed over the model group, n_model times the right one) must
miss those tolerances.

In this process: a spatial primitive without a band rule is refused on a
band before any collective.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet

from centernet_lightning_torch.parallel import mesh as pm
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import (NARROW_DARKNET, TRAIN_CFG, perturb_dcn,
                                 random_flax_variables)
from test_torch_port_parallel import run_ranks
from test_torch_port_parallel_step import compare, global_batch, jax_step

WORLD = 4
NARROW_HEADS = dict(num_classes=3, head_config={"width": 8, "depth": 1})
NARROW_VOVNET = {"stage_channels": (8, 8, 12, 12),
                 "concat_channels": (16, 16, 24, 24)}
# the JAX package's tests/test_spatial_sharding.py model
SPATIAL = dict(num_classes=3, backbone="resnet18", neck="FPN",
               neck_config={"out_channels": 32},
               head_config={"width": 16, "depth": 1})
BANDS = {
    # name: (model config, image size, maps gathered whole)
    "resnet18_fpn32_128": (SPATIAL, 128, 0),
    "resnet18_fpn32_64": (SPATIAL, 64, 1),
    "cspdarknet_spp_mish_128": (dict(
        num_classes=3, backbone="cspdarknet53", backbone_config=NARROW_DARKNET,
        neck="FPN", neck_config={"out_channels": 16},
        extra_block={"name": "SPP", "pool_sizes": [5, 9, 13]},
        head_config={"width": 8, "depth": 1}), 128, 0),
    "dcn_fast_d1_heads_64": (dict(
        num_classes=3, backbone="resnet18", backbone_config={"width": 16},
        neck="FPN", neck_config={"out_channels": 16},
        head_config={"width": 8, "depth": 2, "block": "dcn_fast_d1"}), 64, 1),
    # squeeze-excite means over H (all-reduced), strided depthwise SAME
    "efficientnet_b0_sep_fpn_128": (dict(
        NARROW_HEADS, backbone="efficientnet_b0",
        backbone_config={"width_mult": 0.25}, neck="FPN",
        neck_config={"out_channels": 16, "conv_type": "separable"}), 128, 0),
    # -inf SAME pads of the stage pools, eSE means, bilinear upsampling
    # (one edge-replicated halo row)
    "vovnet19_fpn_bilinear_128": (dict(
        NARROW_HEADS, backbone="vovnet19", backbone_config=NARROW_VOVNET,
        neck="FPN", neck_config={"out_channels": 16,
                                 "upsample_type": "bilinear"}), 128, 0),
    # transposed-conv upsampling and its crop
    "mobilenet_v2_deconv_128": (dict(
        NARROW_HEADS, backbone="mobilenet_v2",
        backbone_config={"width_mult": 0.25}, neck="SimpleNeck",
        neck_config={"upsample_channels": [16, 12, 8],
                     "upsample_type": "conv_transpose"}), 128, 0),
    # Fuse: ceil-mode 2x2 pools and nearest resizes between levels
    "resnet18_bifpn_128": (dict(
        NARROW_HEADS, backbone="resnet18", backbone_config={"width": 8},
        neck="BiFPN", neck_config={"out_channels": 16}), 128, 0),
    "dla34_ida_128": (dict(NARROW_HEADS, backbone="dla34", neck="IDA",
                           neck_config={"out_channels": 16}), 128, 0),
}
# where a level is gathered whole, BiFPN's and IDA's Fuse compare that level's
# height with a band's: the split refuses the model at that size
REFUSED = {"resnet18_bifpn_64": (BANDS["resnet18_bifpn_128"][0], 64),
           "dla34_ida_64": (BANDS["dla34_ida_128"][0], 64)}
COLUMN = dict(num_classes=3, backbone="resnet18", backbone_config={"width": 16},
              neck="FPN", neck_config={"out_channels": 256},
              head_config={"width": 256, "depth": 1})
# an FPN-256 (its seven 256-wide convolutions split) on a width-16
# ResNet-18. On the full-width ResNet-18 one process's step already misses
# the update check against JAX (layer1's BatchNorm bias update 0.34% off,
# a sum with much cancellation), so no grid could be held to it there
STEP_CFG = dict(TRAIN_CFG, backbone_config={"width": 16},
                neck_config={"out_channels": 256})
STEP_OPT = dict(optimizer="SGD", lr=0.05, gradient_clip_val=1.0,
                weight_decay=1e-3, norm_weight_decay=0.0, warmup_epochs=1,
                warmup_decay=0.1, max_epochs=3, steps_per_epoch=2)


def _jax(cfg, size, rng, dcn=False):
    jtask = JCenterNet(**cfg, image_size=(size, size))
    variables = random_flax_variables(jtask, rng, image_size=(size, size))
    if dcn:   # offsets of about +-0.5: the floors reach d + 1 rows away
        variables = perturb_dcn(variables, rng, target=0.5)
    return jtask, variables


def jax_split_names(variables, n_model):
    """The port's names of the kernels JAX's `shard_params(model_parallel=
    True)` splits (`spec_for`: 4-D, out-dim >= 256 and divisible by
    n_model): the converter of a tree that marks them with ones."""
    def mark(x):
        x = np.asarray(x)
        split = x.ndim == 4 and x.shape[-1] % n_model == 0 and x.shape[-1] >= 256
        return np.full(x.shape, 1.0 if split else 0.0, np.float32)
    sd = variables_to_state_dict(jax.tree_util.tree_map(mark, variables))
    return {k for k, v in sd.items() if v.numel() and bool((v == 1).all())}


def _step_case(variants):
    rng = np.random.default_rng(300)
    jtask = JCenterNet(**STEP_CFG)
    variables = random_flax_variables(jtask, rng)
    batch = global_batch(rng, False)
    case = dict(cfg=STEP_CFG, fairmot=False, opt=STEP_OPT)
    start = variables_to_state_dict(variables)
    ref, losses = jax_step(case, variables, batch)
    return (dict(cfg=STEP_CFG, opt=STEP_OPT, state_dict=start, batch=batch,
                 variants=variants),
            (start, ref, losses, jax_split_names(variables, WORLD // 2),
             jax_split_names(variables, WORLD)))


@pytest.fixture(scope="module")
def model_grid(tmp_path_factory):
    """The (1, 4) grid's results and their JAX references."""
    tmp = tmp_path_factory.mktemp("mesh_1x4")
    bands, refs = {}, {}
    for i, (name, (cfg, size, _)) in enumerate(BANDS.items()):
        rng = np.random.default_rng(310 + i)
        jtask, variables = _jax(cfg, size, rng, dcn="dcn" in name)
        x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
        refs["bands", name] = jax.device_get(jax.jit(
            lambda v, x: jtask.model.apply(v, x, train=False))(variables, jnp.asarray(x)))
        bands[name] = dict(cfg=dict(cfg, image_size=(size, size)),
                           state_dict=variables_to_state_dict(variables), images=x)
    refused = {}
    for name, (cfg, size) in REFUSED.items():
        rng = np.random.default_rng(330)
        _, variables = _jax(cfg, size, rng)
        refused[name] = dict(cfg=dict(cfg, image_size=(size, size)),
                             state_dict=variables_to_state_dict(variables),
                             images=rng.normal(size=(2, size, size, 3)
                                               ).astype(np.float32))
    rng = np.random.default_rng(320)
    jtask, variables = _jax(COLUMN, 64, rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    refs["column"] = (jax.device_get(jtask.model.apply(variables, jnp.asarray(x),
                                                       train=False)),
                      jax_split_names(variables, WORLD))
    column = {"fpn256": dict(cfg=dict(COLUMN, image_size=(64, 64)),
                             state_dict=variables_to_state_dict(variables),
                             images=x)}
    step, refs["step"] = _step_case([(True, "own_slice"),
                                     (True, "reduce_scatter")])
    torch.save({"n_data": 1, "bands": bands, "refused": refused,
                "column": column, "steps": {"sgd": step}}, tmp / "mesh_in.pt")
    return refs, run_ranks("mesh", tmp, world=WORLD, timeout=400)


@pytest.fixture(scope="module")
def data_model_grid(tmp_path_factory):
    """The (2, 2) grid's steps and their JAX reference."""
    tmp = tmp_path_factory.mktemp("mesh_2x2")
    step, ref = _step_case([(False, "own_slice"), (True, "own_slice"),
                            (True, "reduce_scatter")])
    torch.save({"n_data": 2, "bands": {}, "column": {}, "steps": {"sgd": step}},
               tmp / "mesh_in.pt")
    return ref, run_ranks("mesh", tmp, world=WORLD, timeout=400)


@pytest.mark.parametrize("name", list(BANDS))
def test_height_split_forward_matches_jax(name, model_grid, record_property):
    """Records each head's max |ref| and largest |difference| (split and
    whole forwards against JAX, split against whole) in the JUnit XML."""
    refs, ranks = model_grid
    ref = refs["bands", name]
    bands = [rank["bands", name] for rank in ranks]
    for key, value in ref.items():
        r = np.asarray(value)
        record_property(f"{key}_max_abs_ref", float(np.abs(r).max()))
        for label, diff in (("split_vs_jax", lambda h, w: h - r),
                            ("whole_vs_jax", lambda h, w: w - r),
                            ("split_vs_whole", lambda h, w: h - w)):
            record_property(f"{key}_max_abs_{label}", max(
                float(np.abs(diff(h[key], w[key])).max()) for h, _, w in bands))
    for rank in ranks:
        heads, gathers, whole = rank["bands", name]
        assert set(heads) == set(ref)
        for key, value in ref.items():
            r = np.asarray(value)
            np.testing.assert_allclose(heads[key], r, rtol=1e-4,
                                       atol=1e-4 * max(1.0, np.abs(r).max()),
                                       err_msg=f"{name} {key}")
            # against the port's own forward on the whole images, ten
            # times tighter: the split's share of the distance to JAX
            np.testing.assert_allclose(heads[key], whole[key], rtol=1e-4,
                                       atol=1e-5 * max(1.0, np.abs(r).max()),
                                       err_msg=f"{name} {key}")
        assert gathers == BANDS[name][2], name
    # the model ranks end with the same gathered maps
    for key in ref:
        assert all(np.array_equal(r["bands", name][0][key],
                                  ranks[0]["bands", name][0][key]) for r in ranks)


@pytest.mark.parametrize("name", list(REFUSED))
def test_height_split_refuses_mismatched_levels(name, model_grid):
    for rank in model_grid[1]:
        assert "needs every level to split" in rank["refused", name]


def test_column_parallel_forward_matches_jax(model_grid):
    refs, ranks = model_grid
    ref, jax_names = refs["column"]
    assert len(jax_names) == 9
    for rank in ranks:
        heads, names = rank["column", "fpn256"]
        assert set(names) == jax_names
        for key, value in ref.items():
            r = np.asarray(value)
            np.testing.assert_allclose(heads[key], r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max(), err_msg=key)


def _check_step(got, refs, n_model, model_parallel):
    start, ref, ref_losses, names_2, names_4 = refs
    compare(got, start, ref, ref_losses, 1e-5, updates=True)
    assert set(got["names"]) == (({2: names_2, 4: names_4}[n_model])
                                 if model_parallel else set())


@pytest.mark.parametrize("grid,model_parallel", [
    ("1x4", True), ("2x2", False), ("2x2", True)],
    ids=["1x4-model_parallel", "2x2-replicated", "2x2-model_parallel"])
def test_grid_step_matches_jax_global_batch(grid, model_parallel, model_grid,
                                            data_model_grid):
    refs, ranks = (model_grid[0]["step"], model_grid[1]) if grid == "1x4" \
        else data_model_grid
    n_model = 4 if grid == "1x4" else 2
    got = ranks[0]["sgd", model_parallel, "own_slice"]
    _check_step(got, refs, n_model, model_parallel)
    for other in ranks[1:]:
        o = other["sgd", model_parallel, "own_slice"]
        assert o["losses"] == got["losses"]
        for key, value in got["state"].items():
            assert torch.equal(value, o["state"][key]), key


@pytest.mark.parametrize("grid", ["1x4", "2x2"])
def test_reduce_scatter_gather_backward_misses(grid, model_grid, data_model_grid):
    """The guard: the same step with the channel gather's backward summed
    over the model group (a reduce-scatter) lands outside the tolerances."""
    refs, ranks = (model_grid[0]["step"], model_grid[1]) if grid == "1x4" \
        else data_model_grid
    with pytest.raises(AssertionError):
        _check_step(ranks[0]["sgd", True, "reduce_scatter"], refs,
                    4 if grid == "1x4" else 2, True)


@pytest.mark.parametrize("op", [
    lambda x: F.adaptive_avg_pool2d(x, 1),
    lambda x: F.pixel_shuffle(x, 2),
    lambda x: F.avg_pool2d(x, 3, 1, 1),
    lambda x: F.interpolate(x, scale_factor=1.5, mode="nearest"),
    lambda x: F.interpolate(x, size=(6, 6), mode="bilinear")],
    ids=["adaptive_pool", "pixel_shuffle", "padded_avg_pool",
         "nearest_by_1.5", "bilinear_by_1.5"])
def test_height_split_refuses_primitives_without_band_rule(op):
    x = torch.zeros(1, 4, 4, 4)
    setattr(x, pm._KIND, pm.BAND)
    with pytest.raises(NotImplementedError, match="height split"):
        with pm._Bands(pm.Mesh(n_model=2, model_rank=1)):
            op(x)
