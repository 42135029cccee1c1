"""The port's EfficientNet and MobileNetV3 families against ``torchok_tpu`` on
the same numpy inputs and weights, f32 on the CPU: every registry name's
stage table, a representative name per arch table and block kind with the
Flax weights and ``batch_stats`` carried across by ``flax_convert``, and the
weight converter both ways. The 5-step fit, the CLI run and the recipes are
``tests/test_torch_efficientnet_fit.py``.

The JAX EfficientNet reaches no Pallas kernel and the port's no hand-written
kernel (the fused MBConv block is ``tests/test_torch_mbconv_fused.py``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu.models.backbones import efficientnet as jax_eff
from torchok_tpu.models.backbones import mobilenetv3 as jax_mnv3
from torchok_tpu.utils.torch_convert import convert_state_dict
from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.backbones import efficientnet as port_eff
from torchok_tpu_torch.models.backbones import efficientnet_blocks as blocks
from torchok_tpu_torch.models.backbones import mobilenetv3 as port_mnv3
from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
from torchok_tpu_torch.ops.common import LAUNCHES
from torchok_tpu_torch.utils.flax_convert import flax_to_state_dict

NAMES = sorted(port_eff._VARIANTS) + sorted(port_mnv3._VARIANTS)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _to_torch(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: at these sizes more threads only
    contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# every registry name
# ---------------------------------------------------------------------------
def test_variant_tables_equal_the_jax_packages():
    assert port_eff._VARIANTS == jax_eff._VARIANTS and len(port_eff._VARIANTS) == 128
    assert port_mnv3._VARIANTS == jax_mnv3._VARIANTS and len(port_mnv3._VARIANTS) == 19
    for name in NAMES:
        assert BACKBONES.get(name).__name__ == name and name in JAX_BACKBONES


@pytest.mark.parametrize("name", NAMES)
def test_every_name_builds_with_the_jax_packages_stage_table(name):
    """At full depth on the meta device (names and shapes, no memory): the
    scaled table, stem, head and pyramid channels, and the blocks built."""
    ref = JAX_BACKBONES.get(name)()
    with torch.device("meta"):
        port = BACKBONES.get(name)()
    assert port._scaled_arch() == ref._scaled_arch()
    assert (port._stem_chs, port._head_chs) == (ref._stem_chs, ref._head_chs)
    assert port.out_encoder_channels == tuple(ref.out_encoder_channels)
    assert port.out_channels == ref.out_channels
    table = port._scaled_arch()
    assert [len(stage) for stage in port.blocks] == [row[1] for row in table]
    for stage, row in zip(port.blocks, table):
        assert type(stage[0]) is blocks.BLOCKS[row[0]]
        assert all(m.eps == 1e-3 for m in stage[0].modules() if isinstance(m, BatchNorm2d))
    assert port.conv_stem.out_channels == port._stem_chs
    assert port.bn2.num_features == port._head_chs


# ---------------------------------------------------------------------------
# representative names against Flax
# ---------------------------------------------------------------------------
REPRESENTATIVES = {
    "efficientnet_b0": "ds/ir with SE, swish",
    "efficientnet_b3": "width and depth scaled",
    "efficientnet_lite0": "relu6, no SE, fixed stem and head",
    "efficientnetv2_s": "cn and er stages",
    "tf_efficientnetv2_b0": "the V2 base table",
    "efficientnet_es": "the edge table, relu",
    "mixnet_s": "mixed kernels (3, 5, 7, 9, 11), remainder to the last",
    "mnasnet_100": "MNasNet B1, relu",
    "semnasnet_100": "MNasNet A1 with SE",
    "mobilenetv2_100": "relu6",
    "fbnetc_100": "ir with exp 1 (no expansion conv)",
    "spnasnet_100": "SPNASNet",
    "fbnetv3_b": "hard_swish in the EfficientNet builder",
    "tinynet_a": "TinyNet",
    "mobilenetv3_large_100": "hard_swish, hard_sigmoid, SE from the expansion",
    "mobilenetv3_small_100": "a ds block with SE and stride 2",
    "tf_mobilenetv3_large_minimal_100": "minimal: 3x3, no SE, relu",
    "lcnet_100": "all ds, SE in the last stage",
}


def cut_depth(name):
    """Keywords that cut a variant to at most two blocks per stage (its first
    block and one residual block), keeping its widths and block kinds."""
    if name in port_mnv3._VARIANTS:
        arch = port_mnv3._VARIANTS[name].get("arch", port_mnv3.MOBILENETV3_LARGE_ARCH)
        return {"arch": tuple((row[0], min(row[1], 2)) + tuple(row[2:]) for row in arch)}
    with torch.device("meta"):
        table = BACKBONES.get(name)()._scaled_arch()
    arch = port_eff._VARIANTS[name].get("arch", port_eff.EFFICIENTNET_ARCH)
    return {"arch": tuple((row[0], min(scaled[1], 2)) + tuple(row[2:])
                          for row, scaled in zip(arch, table)), "depth_mult": 1.0}


def _random_flax_variables(port, seed):
    """Flax variables of the module whose port is ``port``, built from the
    port's state_dict keys (the inverse of the family's path map: no trace of
    the Flax init), with random leaves that keep activations of order one:
    kernels ~ 1/sqrt(fan_in), norm scales and running variances near one."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in port.state_dict().items():
        *path, leaf = key.split(".")
        parts = []
        for p in path:
            if parts[-2:-1] == ["blocks"] and p.isdigit():  # blocks.2.1 -> blocks_2_1
                parts[-2:] = [f"blocks_{parts[-1]}_{p}"]
            else:
                parts.append(p)
        shape = tuple(value.shape)
        if leaf == "weight" and len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])  # OIHW -> HWIO
            leaf, arr = "kernel", rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf in ("weight", "running_var"):
            arr = rng.uniform(0.5, 1.5, size=shape)
        else:
            arr = 0.1 * rng.normal(size=shape)
        collection = "batch_stats" if leaf.startswith("running") else "params"
        leaf = {"weight": "scale", "running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        node = out.setdefault(collection, {})
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = arr.astype(np.float32)
    return out


@pytest.fixture(scope="module", params=list(REPRESENTATIVES))
def models(request):
    """The port with the Flax weights, and the Flax pyramids of one eval
    forward (2 images, 32x32) and one train-mode forward (4 images, 64x64: at
    32x32 the stride-32 maps are 1x1 and each batch statistic is over 4
    values, where cancellation in the variance swamps f32) with the running
    statistics it leaves, both from one compiled function."""
    name = request.param
    kwargs = cut_depth(name)
    flax_model = JAX_BACKBONES.get(name)(**kwargs)
    port = BACKBONES.get(name)(**kwargs)
    variables = _random_flax_variables(port, 3)
    sd = flax_to_state_dict(name, variables)
    assert sorted(sd) == sorted(port.state_dict())
    port.load_state_dict(_to_torch(sd), strict=True)
    x_eval = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_train = np.random.default_rng(1).normal(size=(4, 64, 64, 3)).astype(np.float32)

    def both(v, xe, xt):
        return (flax_model.apply(v, xe, method=flax_model.forward_features),
                flax_model.apply(v, xt, True, method=flax_model.forward_features,
                                 mutable=["batch_stats"]))
    ref_eval, (ref_train, updates) = jax.jit(both)(variables, jnp.asarray(x_eval),
                                                   jnp.asarray(x_train))
    return dict(name=name, variables=variables, port=port, x_eval=x_eval, x_train=x_train,
                ref_eval=ref_eval, ref_train=ref_train, updates=updates)


def test_feature_pyramid_matches_flax(models):
    name, port, ref = models["name"], models["port"], models["ref_eval"]
    before = dict(LAUNCHES)
    with torch.no_grad():
        got = port.eval().forward_features(_nchw(models["x_eval"]))
    assert dict(LAUNCHES) == before  # neither a kernel nor a kernel's plain version
    assert len(got) == len(ref)
    assert tuple(g.shape[1] for g in got[1:]) == port.out_encoder_channels
    for level, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert _nhwc(g).shape == r.shape
        # f32 on both sides, other summation orders in every conv and norm
        np.testing.assert_allclose(_nhwc(g), r, rtol=1e-4, atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"{name} level {level}")


def test_train_mode_output_and_running_statistics_match_flax(models):
    name, ref, updates = models["name"], models["ref_train"], models["updates"]
    port = copy.deepcopy(models["port"]).train()
    got = port.forward_features(_nchw(models["x_train"]))
    top = np.abs(np.asarray(ref[-1])).max()
    np.testing.assert_allclose(_nhwc(got[-1]), np.asarray(ref[-1]), rtol=1e-3, atol=1e-4 * top)
    want = flax_to_state_dict(name, {"params": models["variables"]["params"], **updates})
    stats = {k: v for k, v in port.state_dict().items() if "running" in k}
    assert len(stats) == len(jax.tree_util.tree_leaves(updates)) and stats
    for key, value in stats.items():
        np.testing.assert_allclose(value.numpy(), want[key], rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(want[key]).max()), err_msg=key)


# ---------------------------------------------------------------------------
# the weight converter of torchok_tpu, both ways
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["efficientnet_b0", "mixnet_s", "efficientnetv2_s",
                                  "mobilenetv3_large_100", "lcnet_100"])
def test_convert_state_dict_reads_every_port_key(name):
    """``torchok_tpu.utils.torch_convert.convert_state_dict`` maps a port
    ``state_dict()`` (timm key names; two blocks per stage) onto the Flax
    variables: nothing missing, nothing unused, and ``flax_to_state_dict``
    carries the result back to the same tensors."""
    kwargs = cut_depth(name)
    flax_model = JAX_BACKBONES.get(name)(**kwargs)
    shapes = jax.eval_shape(lambda xx: flax_model.init(jax.random.PRNGKey(0), xx, train=False),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = BACKBONES.get(name)(**kwargs)
    port.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for key, value in port.state_dict().items():  # every leaf its own values
            value.add_(torch.rand(value.shape, generator=torch.Generator().manual_seed(len(key))))
    sd = port.state_dict()
    converted, report = convert_state_dict(name, sd, template)
    assert not report.missing and not report.unused
    assert report.converted == len(sd)
    back = flax_to_state_dict(name, jax.tree_util.tree_map(np.asarray, converted))
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key], value.numpy(), err_msg=key)


# ---------------------------------------------------------------------------
# the modules' own details
# ---------------------------------------------------------------------------
def test_what_is_not_ported_raises_and_the_stages_are_named():
    for name in ("efficientnet_b0", "mobilenetv3_large_100"):
        with pytest.raises(NotImplementedError, match="pretrained weights are not ported"):
            BACKBONES.get(name)(pretrained=True)
    model = BACKBONES.get("efficientnet_b0")(depth_mult=0.5)
    assert model.get_stages(2) == ["conv_stem", "bn1", "blocks.0.", "blocks.1."]
    assert model.get_stages(2) == [p.replace("_", ".") if p.startswith("blocks") else p
                                   for p in JAX_BACKBONES.get("efficientnet_b0")().get_stages(2)]


def test_convs_pad_symmetrically_and_norms_take_eps_1e3():
    model = BACKBONES.get("tf_efficientnet_b0")()
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(m.padding == ((m.kernel_size[0] - 1) // 2,) * 2 for m in convs)
    assert any(m.kernel_size == (5, 5) and m.stride == (2, 2) for m in convs)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert norms and all(m.eps == 1e-3 and m.momentum == 0.9 for m in norms)
    # a stride-2 k5 conv of an even map: (k - 1) // 2 on both sides, not TF's SAME
    out = torch.nn.functional.conv2d(torch.ones(1, 1, 8, 8), torch.ones(1, 1, 5, 5), stride=2,
                                     padding=2)
    assert out.shape[-1] == 4 and out[0, 0, 0, 0] == 9


def test_mixed_block_gives_the_remainder_to_the_last_kernel():
    block = blocks.MixedInvertedResidual(16, 16, kernel=(3, 5, 7), exp_ratio=6.0)
    assert block.splits == [32, 32, 32]
    block = blocks.MixedInvertedResidual(24, 24, kernel=(3, 5, 7, 9, 11), exp_ratio=6.0)
    assert block.splits == [28, 28, 28, 28, 32]
    assert block.conv_dw_4.kernel_size == (11, 11) and block.conv_dw_4.groups == 32


def test_se_width_and_activation_follow_the_family():
    eff = BACKBONES.get("efficientnet_b0")()
    ir = eff.blocks[1][1]
    assert ir.se.fc1.out_channels == 8 and ir.se.gate is torch.sigmoid  # from in_chs 24
    mnv3 = BACKBONES.get("mobilenetv3_large_100")()
    ir = mnv3.blocks[2][0]
    assert ir.se.fc1.in_channels == 72 and ir.se.fc1.out_channels == 24  # from mid 72
    assert ir.se.gate is blocks.hard_sigmoid
    ds = BACKBONES.get("mobilenetv3_small_100")().blocks[0][0]
    assert ds.se.fc1.out_channels == 8 and ds.conv_dw.stride == (2, 2)
    x = torch.linspace(-4, 4, 9)
    torch.testing.assert_close(blocks.hard_sigmoid(x), torch.clamp(x + 3, 0, 6) / 6)
    torch.testing.assert_close(blocks.hard_swish(x), x * torch.clamp(x + 3, 0, 6) / 6)


def test_drop_path_rates_rise_over_the_blocks():
    """``rate * index / (blocks - 1)`` over all blocks, on the residual ones."""
    model = BACKBONES.get("efficientnet_b0")(drop_path_rate=0.2)
    flat = [b for stage in model.blocks for b in stage]
    assert len(flat) == 16
    rates = {i: b.drop_path.rate for i, b in enumerate(flat) if b.drop_path is not None}
    assert sorted(rates) == [2, 4, 6, 7, 9, 10, 12, 13, 14]
    for i, rate in rates.items():
        assert rate == pytest.approx(0.2 * i / 15)


def test_init_weights_draws_the_jax_packages_law():
    model = BACKBONES.get("efficientnet_b0")()
    model.init_weights(torch.Generator().manual_seed(3))
    w = model.conv_head.weight  # 1x1, fan_out 1280
    assert w.std().item() == pytest.approx((2.0 / 1280) ** 0.5, rel=0.05)
    dw = model.blocks[5][0].conv_dw.weight  # 5x5 depthwise, fan_out 672 * 25
    assert dw.std().item() == pytest.approx((2.0 / (672 * 25)) ** 0.5, rel=0.05)
    fc1 = model.blocks[5][0].se.fc1  # Flax's default: LeCun normal over fan_in 672
    assert fc1.weight.std().item() == pytest.approx(672 ** -0.5, rel=0.1)
    assert not fc1.bias.any() and bool((model.bn2.weight == 1).all())
