"""The port's ResNet family and what it brought (``avg_pool``, ``blur_pool``,
``EcaModule``, ``ConvBnAct``, BatchNorm through the trainer) against
``torchok_tpu`` on the same numpy inputs and weights, f32 on the CPU.

Backbones are cut to one block per stage (two in one stage where the block
index matters) and fed 64x64 images; the Flax weights are carried across by
``flax_convert``. The JAX ResNet reaches no Pallas kernel and the port's no
hand-written kernel, so there is no kernel path to pick here.
"""
import copy
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu.constructor import TASKS as JAX_TASKS
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.config_structure import merge_structured as jax_merge
from torchok_tpu.constructor.runner import create_trainer as jax_create_trainer
from torchok_tpu.models.backbones import resnet as jax_resnet
from torchok_tpu.models.modules.blocks.se import EcaModule as FlaxEca
from torchok_tpu.models.modules.bricks.convbnact import ConvBnAct as FlaxConvBnAct
from torchok_tpu.ops import image as jax_image
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.constructor.config import ConfigNode, load_config
from torchok_tpu_torch.constructor.constructor import Constructor, norm_parameter_names
from torchok_tpu_torch.models.backbones import resnet as port_resnet
from torchok_tpu_torch.models.modules.blocks.se import EcaModule
from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
from torchok_tpu_torch.models.modules.bricks.convbnact import ConvBnAct, same_padding
from torchok_tpu_torch.ops import image as port_image
from torchok_tpu_torch.ops.common import LAUNCHES
from torchok_tpu_torch.utils.flax_convert import (flax_to_state_dict, state_dict_to_task_flax,
                                                  task_flax_to_state_dict, task_name_map)
from tests.test_torch_losses_optim import PARAMWISE_CASES, _jax_labels
from tests.test_torch_train_slice import JaxRecorder, PortRecorder, small_config

REPO = Path(__file__).resolve().parent.parent


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _to_torch(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# image ops and bricks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,stride,padding,include", [(2, 2, 0, True), (3, 2, 1, True),
                                                           (3, 2, 1, False), (3, 1, 1, False)])
def test_avg_pool_matches_jax(window, stride, padding, include):
    x = np.random.default_rng(0).normal(size=(2, 9, 11, 5)).astype(np.float32)
    ref = jax_image.avg_pool(jnp.asarray(x), window, stride, padding, include)
    got = port_image.avg_pool(_nchw(x), window, stride, padding, include)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride,kernel", [(2, 3), (2, 5), (1, 3), (3, 3), (2, 4)])
def test_blur_pool_matches_jax(stride, kernel):
    x = np.random.default_rng(1).normal(size=(2, 9, 12, 6)).astype(np.float32)
    ref = jax_image.blur_pool(jnp.asarray(x), stride, kernel)
    got = port_image.blur_pool(_nchw(x), stride, kernel)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # reflect padding: a constant map stays constant up to the border
    flat = port_image.blur_pool(torch.ones(1, 2, 8, 8), stride, kernel)
    torch.testing.assert_close(flat, torch.ones_like(flat))


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_eca_module_matches_flax(kernel_size):
    x = np.random.default_rng(2).normal(size=(3, 5, 4, 16)).astype(np.float32)
    flax_eca = FlaxEca(kernel_size=kernel_size)
    variables = jax.tree_util.tree_map(np.asarray,
                                       flax_eca.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = EcaModule(kernel_size)
    sd = flax_to_state_dict("EcaModule", variables)
    assert {k: v.shape for k, v in sd.items()} == {"conv.weight": (1, 1, kernel_size)}
    port.load_state_dict(_to_torch(sd), strict=True)
    np.testing.assert_allclose(_nhwc(port(_nchw(x))),
                               np.asarray(flax_eca.apply(variables, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="odd"):
        EcaModule(4)


CONV_BN_ACT = {
    "default": dict(kernel_size=3),
    "same_s2": dict(kernel_size=3, stride=2, padding="SAME"),   # pads (0, 1): more at the end
    "same_s2_k5": dict(kernel_size=5, stride=2, padding="SAME"),
    "valid": dict(kernel_size=3, padding="VALID"),
    "int_pad_dilated": dict(kernel_size=3, padding=2, dilation=2),
    "grouped_bias_no_norm": dict(kernel_size=(1, 3), groups=2, use_bias=True, use_norm=False,
                                 act=None),
}


@pytest.mark.parametrize("case", list(CONV_BN_ACT))
def test_conv_bn_act_matches_flax(case):
    kwargs = CONV_BN_ACT[case]
    x = np.random.default_rng(3).normal(size=(4, 10, 10, 4)).astype(np.float32)
    flax_kwargs = dict(kwargs)
    if "act" not in flax_kwargs:
        flax_kwargs["act"] = nn.relu
    flax_brick = FlaxConvBnAct(out_channels=6, **flax_kwargs)
    variables = jax.tree_util.tree_map(
        np.asarray, flax_brick.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False))
    port = ConvBnAct(4, 6, **kwargs)
    port.load_state_dict(_to_torch(flax_to_state_dict("ConvBnAct", variables)), strict=True)
    ref = flax_brick.apply(variables, jnp.asarray(x), train=False)
    got = port.eval()(_nchw(x))
    assert got.shape[2:] == ref.shape[1:3]
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4, atol=1e-5)
    if kwargs.get("use_norm", True):
        ref, updates = flax_brick.apply(variables, jnp.asarray(x), train=True,
                                        mutable=["batch_stats"])
        got = port.train()(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(port.bn.running_var.numpy(),
                                   np.asarray(updates["batch_stats"]["bn"]["var"]),
                                   rtol=1e-5, atol=1e-6)


def test_same_padding_is_xlas():
    assert same_padding(10, 3, 2, 1) == (0, 1) and same_padding(9, 3, 2, 1) == (1, 1)
    assert same_padding(10, 3, 1, 1) == (1, 1) and same_padding(10, 5, 2, 1) == (1, 2)
    with pytest.raises(ValueError, match="SAME"):
        ConvBnAct(4, 4, padding="CIRCULAR")


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------
def _random_variables(model, size, seed):
    """Random leaves of the right shapes at a scale that keeps activations of
    order one through the net: kernels ~ 1/sqrt(fan_in), running variances
    near one, norm scales near one (an eager Flax init is slow and would leave
    every last norm at zero)."""
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda xx: model.init(jax.random.PRNGKey(0), xx, train=False), x)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


ONE = dict(layers=(1, 1, 1, 1))
PYRAMIDS = {
    "resnet18": ("resnet18", dict(layers=(1, 2, 1, 1))),
    "resnet50": ("resnet50", dict(layers=(1, 2, 1, 1))),
    "resnet26d": ("resnet26d", ONE),                   # deep stem, avg_down
    "seresnet18": ("seresnet18", ONE),
    "ecaresnet26t": ("ecaresnet26t", ONE),             # deep_tiered stem, eca
    "resnetblur18": ("resnetblur18", ONE),             # blur pool in stem and blocks
    "seresnetaa50d": ("seresnetaa50d", ONE),
    "resnet50_gn": ("resnet50_gn", ONE),               # GroupNorm(32), eps 1e-6
    "resnetrs50": ("resnetrs50", ONE),                 # a conv replaces the stem pool
    "resnext50_32x4d": ("resnext50_32x4d", ONE),       # grouped 3x3
    "senet154": ("senet154", ONE),                     # 3x3 downsample, reduce_first
    "space_to_depth": ("resnet18", dict(ONE, space_to_depth_stem=True)),
    "output_stride_8": ("resnet50", dict(ONE, output_stride=8)),   # dilated stages
}


@pytest.fixture(scope="module", params=list(PYRAMIDS))
def models(request):
    name, kwargs = PYRAMIDS[request.param]
    flax_model = JAX_BACKBONES.get(name)(**kwargs)
    variables = _random_variables(flax_model, 64, 1)
    port = BACKBONES.get(name)(**kwargs)
    sd = flax_to_state_dict(name, variables)
    assert sorted(sd) == sorted(port.state_dict())
    port.load_state_dict(_to_torch(sd), strict=True)
    return name, flax_model, variables, port


def test_feature_pyramid_matches_flax(models):
    name, flax_model, variables, port = models
    x = np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(np.float32)
    ref = flax_model.apply(variables, jnp.asarray(x), method=flax_model.forward_features)
    before = dict(LAUNCHES)
    with torch.no_grad():
        got = port.eval().forward_features(_nchw(x))
    assert dict(LAUNCHES) == before  # neither a kernel nor a kernel's plain version
    assert len(got) == len(ref) == 6
    assert tuple(g.shape[1] for g in got[1:]) == port.out_encoder_channels \
        == tuple(flax_model.out_encoder_channels)
    assert port.out_channels == flax_model.out_channels
    for level, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert g.shape == (r.shape[0], r.shape[3], r.shape[1], r.shape[2])
        # f32 on both sides, other summation orders in every conv and norm
        np.testing.assert_allclose(_nhwc(g), r, rtol=1e-4, atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"{name} level {level}")
    np.testing.assert_array_equal(_nhwc(port(_nchw(x))), _nhwc(got[-1]))


def test_train_mode_output_and_running_statistics_match_flax(models):
    name, flax_model, variables, port = models
    x = np.random.default_rng(1).normal(size=(4, 64, 64, 3)).astype(np.float32)
    port = copy.deepcopy(port).train()
    if "batch_stats" not in variables:  # resnet50_gn: nothing to update
        assert not [k for k in port.state_dict() if "running" in k]
        return
    ref, updates = flax_model.apply(variables, jnp.asarray(x), True,
                                    method=flax_model.forward_features, mutable=["batch_stats"])
    got = port.forward_features(_nchw(x))
    top = np.abs(np.asarray(ref[-1])).max()
    np.testing.assert_allclose(_nhwc(got[-1]), np.asarray(ref[-1]), rtol=1e-3, atol=1e-4 * top)
    want = flax_to_state_dict(name, {"params": variables["params"], **updates})
    stats = {k: v for k, v in port.state_dict().items() if "running" in k}
    assert len(stats) == len(jax.tree_util.tree_leaves(updates)) and stats
    for key, value in stats.items():
        np.testing.assert_allclose(value.numpy(), want[key], rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(want[key]).max()), err_msg=key)


def test_state_dict_round_trips_both_collections(models):
    name, _, variables, port = models
    task_vars = {c: {"backbone": tree} for c, tree in variables.items()}
    sd = task_flax_to_state_dict(name, task_vars)
    assert sorted(sd) == sorted("backbone." + k for k in port.state_dict())
    for collection, tree in task_vars.items():
        back = state_dict_to_task_flax(name, sd, task_vars, collection)
        flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(a, b)
    assert not set(task_name_map(name, task_vars)) & set(task_name_map(name, task_vars,
                                                                      "batch_stats"))


def test_variant_tables_equal_the_jax_packages():
    assert port_resnet._VARIANTS == jax_resnet._VARIANTS
    assert port_resnet._WEIGHT_ALIASES == jax_resnet._WEIGHT_ALIASES
    names = set(port_resnet._VARIANTS) | set(port_resnet._WEIGHT_ALIASES)
    assert len(names) == 89
    for name in names:
        assert BACKBONES.get(name).__name__ == name and name in JAX_BACKBONES


def _distinct_configs():
    """One registry name per architecture apart from its depth."""
    seen = {}
    for name in (*port_resnet._VARIANTS, *port_resnet._WEIGHT_ALIASES):
        cfg = port_resnet.variant_config(name)
        cfg.pop("layers")
        seen.setdefault(json.dumps(cfg, sort_keys=True), name)
    return sorted(seen.values())


@pytest.mark.parametrize("name", _distinct_configs())
def test_every_architecture_builds_and_its_names_round_trip(name):
    """Every registered name builds at full depth (on the meta device: names
    and shapes, no memory); one name per architecture is held against the Flax
    tree at a cut depth, parameters and running statistics, by name and shape."""
    same = [n for n in (*port_resnet._VARIANTS, *port_resnet._WEIGHT_ALIASES)
            if {k: v for k, v in port_resnet.variant_config(n).items() if k != "layers"}
            == {k: v for k, v in port_resnet.variant_config(name).items() if k != "layers"}]
    for other in same:
        with torch.device("meta"):
            full = BACKBONES.get(other)()
        depth = port_resnet.variant_config(other)["layers"]
        assert [len(getattr(full, f"layer{i + 1}")) for i in range(4)] == list(depth)
        assert f"layer3.{depth[2] - 1}.bn2.weight" in full.state_dict()
    kwargs = dict(layers=(1, 2, 1, 1))
    flax_model = JAX_BACKBONES.get(name)(**kwargs)
    shapes = jax.eval_shape(lambda xx: flax_model.init(jax.random.PRNGKey(0), xx, train=False),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    with torch.device("meta"):
        port = BACKBONES.get(name)(**kwargs)
    sd = flax_to_state_dict(name, variables)
    assert {k: tuple(v.shape) for k, v in sd.items()} \
        == {k: tuple(v.shape) for k, v in port.state_dict().items()}


def test_what_is_not_ported_raises_and_the_stages_are_named():
    with pytest.raises(NotImplementedError, match="pretrained weights are not ported"):
        BACKBONES.get("resnet50")(pretrained=True)
    model = BACKBONES.get("resnet18")(**ONE)
    with pytest.raises(NotImplementedError, match="rfp_feats"):
        model.forward_features(torch.zeros(1, 3, 32, 32), rfp_feats=[None])
    with pytest.raises(ValueError, match="space_to_depth_stem"):
        BACKBONES.get("resnet18d")(space_to_depth_stem=True)
    with pytest.raises(ValueError, match="even input"):
        BACKBONES.get("resnet18")(**ONE, space_to_depth_stem=True)(torch.zeros(1, 3, 31, 32))
    assert model.get_stages(2) == ["conv1", "bn1", "maxpool", "layer1.", "layer2."]
    assert [spec["dilation"] for spec in
            BACKBONES.get("resnet50")(**ONE, output_stride=8)._stage_plan()] == [1, 1, 2, 4]


def test_init_weights_draws_the_jax_packages_law_from_the_generator():
    model = BACKBONES.get("seresnet50")(layers=(1, 1, 1, 1))

    def draw(seed):
        model.init_weights(torch.Generator().manual_seed(seed))
        return {k: v.clone() for k, v in model.state_dict().items()}

    first = draw(3)
    again = draw(3)
    assert all(torch.equal(first[k], again[k]) for k in first)
    assert not torch.equal(draw(4)["conv1.weight"], first["conv1.weight"])
    # variance scaling 2.0 over fan_out = 64 * 49, a truncated normal
    w = first["conv1.weight"]
    assert w.std().item() == pytest.approx((2.0 / (64 * 49)) ** 0.5, rel=0.05)
    assert w.abs().max().item() <= 2 * (2.0 / (64 * 49)) ** 0.5 / 0.8796 + 1e-6
    w = first["layer4.0.conv2.weight"]
    assert w.std().item() == pytest.approx((2.0 / (512 * 9)) ** 0.5, rel=0.02)
    # zero_init_last: each block starts as the identity; the other norms at one
    assert not first["layer1.0.bn3.weight"].any() and not first["layer4.0.bn3.weight"].any()
    assert bool((first["layer1.0.bn1.weight"] == 1).all())
    assert bool((first["layer1.0.downsample.1.weight"] == 1).all())
    assert bool((first["bn1.running_var"] == 1).all()) and not first["bn1.running_mean"].any()
    assert not first["layer1.0.se.fc1.bias"].any()
    # Flax's default for the SE convs: LeCun normal over fan_in = 256
    assert first["layer1.0.se.fc1.weight"].std().item() == pytest.approx(256 ** -0.5, rel=0.1)
    flax_model = JAX_BACKBONES.get("seresnet50")(layers=(1, 1, 1, 1))
    ref = flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)["params"]
    assert not np.asarray(ref["layer1_0"]["bn3"]["scale"]).any()
    assert np.asarray(ref["conv1"]["kernel"]).std() == pytest.approx(w_std := (2 / 3136) ** 0.5,
                                                                     rel=0.05), w_std


@pytest.mark.parametrize("case", list(PARAMWISE_CASES))
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_param_group_labels_equal_jax_leaf_labels(name, case):
    """Every parameter of the full-depth model: conv kernels decay, BatchNorm
    scale and bias are norm parameters whatever timm calls them."""
    opt_cfg, paramwise = PARAMWISE_CASES[case]
    spec = {"name": "Adam", "params": opt_cfg}
    if paramwise:
        spec["paramwise_cfg"] = copy.deepcopy(paramwise)
        if "custom_keys" in paramwise:  # keys that both naming schemes spell alike
            spec["paramwise_cfg"]["custom_keys"] = {
                "layer4": {"lr_mult": 0.1, "decay_mult": 0.3}, "conv3": {"lr_mult": 3.0},
                "head": {"lr_mult": 10.0, "decay_mult": 0.0}}
    jax_backbone = JAX_BACKBONES.get(name)()
    shapes = jax.eval_shape(
        lambda xx: jax_backbone.init(jax.random.PRNGKey(0), xx, train=False),
        jnp.zeros((1, 64, 64, 3), jnp.float32))["params"]
    width = jax_backbone.out_channels
    params = {"backbone": jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes),
              "head": {"fc": {"kernel": np.zeros((width, 10), np.float32),
                              "bias": np.zeros((10,), np.float32)}}}
    ref, ref_lrs = _jax_labels(params, JaxConfigNode(copy.deepcopy(spec)), [])
    with torch.device("meta"):
        backbone = BACKBONES.get(name)()
        model = torch.nn.ModuleDict({
            "backbone": backbone,
            "head": torch.nn.ModuleDict({"fc": torch.nn.Linear(width, 10)})})
    norm_names = norm_parameter_names(model)
    got = Constructor.param_labels(list(model.named_parameters()),
                                   ConfigNode(copy.deepcopy(spec)), [], norm_names)
    name_map = task_name_map(name, {"params": params})
    assert sorted(name_map) == sorted(got)
    for key, path in name_map.items():
        assert got[key] == ref[path], f"{key} <- {'.'.join(path)}"
    assert len(set(got.values())) == len(ref_lrs)
    probe = "backbone.layer2.0.downsample.1.bias"  # a BatchNorm bias with no 'bn' in its name
    assert probe in norm_names and "backbone.layer2.0.downsample.0.weight" not in norm_names
    if case == "mults":  # bias_lr_mult is for biases outside the norms
        assert got[probe] == "lr1.0_wd0.0" and got["head.fc.bias"] == "lr2.0_wd0.0"
        by_name_only = Constructor.param_labels(list(model.named_parameters()),
                                                ConfigNode(copy.deepcopy(spec)), [])
        assert by_name_only[probe] == "lr2.0_wd0.0"


# ---------------------------------------------------------------------------
# the slice: 5 train steps of both packages from the same weights
# ---------------------------------------------------------------------------
def _fit_jax(cfg):
    """torchok_tpu's fit: (initial variables, final variables, recorder), each
    variables dict holding ``params`` and ``batch_stats``."""
    config = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
    task = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    trainer = jax_create_trainer(config)
    recorder = JaxRecorder()
    trainer.callbacks.append(recorder)
    initial = {}
    setup = trainer._setup_state

    def variables():
        return {"params": jax.tree_util.tree_map(np.asarray, trainer.state.params),
                "batch_stats": jax.tree_util.tree_map(np.asarray, trainer.state.batch_stats)}

    def setup_and_capture(task_, ckpt_path=None):
        setup(task_, ckpt_path)
        initial.update(variables())

    trainer._setup_state = setup_and_capture
    trainer.fit(task)
    return initial, variables(), recorder


FITS = {
    # basic blocks, the plain stem; SGD with momentum and weight decay
    "resnet18": ("resnet18", {}, {"name": "SGD", "params": {"lr": 0.01, "momentum": 0.9,
                                                            "weight_decay": 1e-3}}, 5),
    # bottlenecks, the tiered deep stem, an average-pooled shortcut, ECA;
    # gradients accumulated over 2 micro-batches, statistics updated by each
    "ecaresnet26t": ("ecaresnet26t", {"accumulate_grad_batches": 2},
                     {"name": "SGD", "params": {"lr": 0.01}}, 2),
}


@pytest.mark.parametrize("case", list(FITS))
def test_fit_matches_torchok_tpu_over_5_steps(case, tmp_path):
    name, trainer_keys, optimizer, optimizer_steps = FITS[case]
    cfg = small_config(optimizer, backbone_name=name,
                       backbone_params={"layers": [1, 1, 1, 1], "pretrained": False},
                       **trainer_keys)
    initial, final, ref = _fit_jax(cfg)
    assert initial["batch_stats"] and "backbone" in initial["batch_stats"]

    ckpt = tmp_path / "initial.pt"
    torch.save({"state_dict": _to_torch(task_flax_to_state_dict(name, initial))}, ckpt)
    port_cfg = copy.deepcopy(cfg)
    port_cfg["resume_path"] = str(ckpt)
    got = PortRecorder()
    before = dict(LAUNCHES)
    trainer, logs = run(port_cfg, "train", [got])
    assert dict(LAUNCHES) == before  # no kernel and no kernel's plain version on this path

    assert trainer.global_step == 5 and len(got.steps) == len(ref.steps) == 5
    for step, (g, r) in enumerate(zip(got.steps, ref.steps)):
        for key in ("loss", "ce"):
            # f32 on both sides, other summation orders: 1e-4 relative
            assert g[key] == pytest.approx(r[key], rel=1e-4), f"step {step} {key}"
    assert got.steps[0]["loss"] != got.steps[-1]["loss"]
    ref_logs = ref.epochs[-1]
    assert set(logs) == set(ref_logs)
    for key in ("train/loss", "valid/loss"):  # validation runs on the running statistics
        assert logs[key] == pytest.approx(ref_logs[key], rel=1e-4), key
    assert logs["valid/Accuracy"] == ref_logs["valid/Accuracy"]

    want = task_flax_to_state_dict(name, final)
    start = task_flax_to_state_dict(name, initial)
    state_dict = trainer.state.model.state_dict()
    assert sorted(want) == sorted(state_dict)
    stats = set(task_name_map(name, final, "batch_stats"))
    assert stats and all(k.endswith(("running_mean", "running_var")) for k in stats)
    moved = []
    for key, value in state_dict.items():
        if key in stats:
            # 5 updates of 0.1 each from the same batches: f32 rounding only
            np.testing.assert_allclose(value.numpy(), want[key], rtol=1e-4, atol=1e-5,
                                       err_msg=key)
        else:
            # SGD: the difference scales with the gradient difference itself
            np.testing.assert_allclose(value.numpy(), want[key], rtol=0, atol=2e-5, err_msg=key)
        if np.abs(value.numpy() - start[key]).max() > 0:
            moved.append(key)
    assert stats <= set(moved)  # every running statistic moved, by name
    assert len(moved) > 0.9 * len(state_dict)
    assert trainer.state.step == 5 and optimizer_steps == 5 // trainer.accumulate_grad_batches
    # the port's own init (no resume_path) zeroes each block's last norm
    fresh, _ = run({**copy.deepcopy(cfg), "data": {"TEST": cfg["data"]["VALID"]}}, "test")
    last = "bn2" if name == "resnet18" else "bn3"
    assert not fresh.state.model.state_dict()[f"backbone.layer1.0.{last}.weight"].any()


def test_recipes_equal_chip_smoke_configs_and_shapes():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for recipe, cfg in (("classification_resnet50_synthetic", chip_smoke.RESNET_SLICE_CONFIG),
                        ("classification_resnet50_synthetic_train",
                         chip_smoke.RESNET_TRAIN_CONFIG)):
        assert load_config(REPO / "configs", recipe).to_dict() == cfg, recipe
    train = chip_smoke.RESNET_TRAIN_CONFIG
    assert train["data"]["TRAIN"][0]["dataloader"]["batch_size"] == chip_smoke.RESNET_BATCH == 256
    assert train["data"]["TRAIN"][0]["dataset"]["params"]["num_samples"] == 2560
    assert train["data"]["VALID"][0]["dataset"]["params"]["num_samples"] == 512
    smoke = chip_smoke.smoke_train_config(10, train, 224, 256)
    assert smoke["data"]["TRAIN"][0]["dataset"]["params"]["num_samples"] == 256
    # the kernels' shapes are ResNet-50's bottleneck convs at 224x224
    with torch.device("meta"):
        model = BACKBONES.get("resnet50")()
    size = 56
    for (stage, pixels, wide, narrow), (hw, ch), layer in zip(
            chip_smoke.BN_STAGES, chip_smoke.CONV_SHAPES,
            (model.layer1, model.layer2, model.layer3, model.layer4)):
        block = layer[-1]
        assert pixels == size * size and hw == size
        assert tuple(block.conv1.weight.shape) == (narrow, wide, 1, 1)
        assert tuple(block.conv2.weight.shape) == (ch, ch, 3, 3) and ch == narrow
        assert tuple(block.conv3.weight.shape) == (wide, narrow, 1, 1)
        size //= 2


def test_cli_trains_a_small_resnet_on_the_cpu(tmp_path):
    cfg = small_config({"name": "Adam", "params": {"lr": 1e-3}}, backbone_name="resnet50",
                       backbone_params={"layers": [1, 1, 1, 1], "pretrained": False})
    cfg["trainer"]["accelerator"] = "gpu"  # the override below asks for the CPU
    (tmp_path / "small_resnet.yaml").write_text(json.dumps(cfg))  # JSON is valid YAML
    out = subprocess.run(
        [sys.executable, "-m", "torchok_tpu_torch", "-cp", str(tmp_path), "-cn", "small_resnet",
         "trainer.accelerator=cpu", "trainer.max_epochs=2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("epoch ")]
    assert len(lines) == 2 and lines[1].startswith("epoch 1 | ")
    for part in ("train/loss=", "valid/Accuracy=", "valid/loss="):
        assert part in lines[0]
    assert "10 train steps, 40 images" in out.stdout


def test_batchnorm_module_is_what_the_backbone_uses():
    model = BACKBONES.get("resnet18d")(**ONE)
    assert isinstance(model.bn1, BatchNorm2d) and isinstance(model.conv1[1], BatchNorm2d)
    assert isinstance(model.layer2[0].downsample[2], BatchNorm2d)
    assert model.bn1.momentum == 0.9 and model.bn1.eps == 1e-5
    gn = BACKBONES.get("resnet50_gn")(**ONE)
    assert isinstance(gn.layer1[0].bn1, torch.nn.GroupNorm) and gn.layer1[0].bn1.eps == 1e-6
    assert gn.layer1[0].bn1.num_groups == 32
