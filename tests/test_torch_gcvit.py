"""The port's GCViT backbone and its classification slice against
``torchok_tpu``'s, with the Flax weights carried across by ``flax_convert``.

The JAX side runs its fused Pallas window attention (local and global-query
kernels) in interpret mode, as its own tests do; the port runs its plain
versions on the CPU. Both in float32, at a narrow width: two stages of depth 2
(one local and one global block each), 32x32 images, windows of 4.
"""
import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu_torch
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.models.heads.classification.classification_head import \
    ClassificationHead as FlaxHead
from torchok_tpu.utils.torch_convert import convert_state_dict
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.constructor import BACKBONES, HEADS, POOLINGS
from torchok_tpu_torch.constructor.config import ConfigNode, load_config
from torchok_tpu_torch.constructor.constructor import Constructor
from torchok_tpu_torch.ops import window_attention_dot as ops
from torchok_tpu_torch.ops.common import install_dropout_generator
from torchok_tpu_torch.utils.flax_convert import (flax_to_state_dict, state_dict_to_task_flax,
                                                  task_flax_to_state_dict, task_name_map)
from tests.test_torch_losses_optim import PARAMWISE_CASES, _jax_labels
from tests.test_torch_train_slice import _fit_jax, _fit_port, small_config

REPO = Path(__file__).resolve().parent.parent
# maps 8x8 and 4x4, windows 4 and 4: four windows then one; one query level
SMALL = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), img_size=32, window_ratio=(8, 8),
             pretrained=False)
SCALED = dict(SMALL, layer_scale=0.1, mlp_ratio=2.0)
NAME = "gcvit_xxtiny"  # the registry entry that both packages narrow by keyword


def _random_variables(model, size, seed):
    """Random leaves of the right shapes (an eager Flax init is slow and its
    distribution is irrelevant: the bias tables start at zero)."""
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda xx: model.init(jax.random.PRNGKey(0), xx, train=False), x)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32), shapes)


def _to_torch(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.fixture(scope="module", params=["plain", "layer_scale"])
def models(request):
    cfg = SMALL if request.param == "plain" else SCALED
    flax_model = JAX_BACKBONES.get(NAME)(**cfg)
    variables = _random_variables(flax_model, 32, 1)
    port = BACKBONES.get(NAME)(**cfg).eval()
    port.load_state_dict(_to_torch(flax_to_state_dict(NAME, variables)), strict=True)
    return flax_model, variables, port


# 24 px: a 6x6 map padded to 8x8, its 3x3 queries padded to a 4x4 window, then
# a 3x3 map padded to 4x4; no parameter shape depends on the input size
@pytest.mark.parametrize("size", [32, 24], ids=["exact", "padded"])
def test_backbone_matches_flax(monkeypatch, models, size):
    monkeypatch.setenv("TORCHOK_WINDOW_ATTN_PALLAS", "1")  # the fused Pallas path
    flax_model, variables, port = models
    x = np.random.default_rng(0).normal(size=(2, size, size, 3)).astype(np.float32)
    ref = flax_model.apply(variables, jnp.asarray(x), return_features=True)
    before = dict(ops.LAUNCHES)
    with torch.no_grad():
        got = port.forward_features(torch.from_numpy(x).permute(0, 3, 1, 2))
    # one local and one global block per stage, all plain on the CPU
    assert ops.LAUNCHES[ops.PLAIN] == before.get(ops.PLAIN, 0) + 2
    assert ops.LAUNCHES[ops.PLAIN_GLOBAL] == before.get(ops.PLAIN_GLOBAL, 0) + 2
    assert len(got) == len(ref) == 3
    # f32 on both sides; sum order in LayerNorm, the convs and the MLP differs
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


def test_logits_match_flax(monkeypatch, models):
    monkeypatch.setenv("TORCHOK_WINDOW_ATTN_PALLAS", "1")
    flax_model, variables, port = models
    x = np.random.default_rng(2).normal(size=(3, 32, 32, 3)).astype(np.float32)
    pooled = jnp.mean(flax_model.apply(variables, jnp.asarray(x)), axis=(1, 2))
    flax_head = FlaxHead(in_channels=32, num_classes=7)
    head_vars = jax.tree_util.tree_map(np.asarray,
                                       flax_head.init(jax.random.PRNGKey(2), pooled))
    pool = POOLINGS.get("Pooling")(in_channels=port.out_channels)
    head = HEADS.get("ClassificationHead")(in_channels=pool.out_channels, num_classes=7)
    head.load_state_dict(_to_torch(flax_to_state_dict("ClassificationHead", head_vars)),
                         strict=True)
    with torch.no_grad():
        got = head(pool(port(torch.from_numpy(x).permute(0, 3, 1, 2))))
    np.testing.assert_allclose(got.numpy(), np.asarray(flax_head.apply(head_vars, pooled)),
                               rtol=1e-4, atol=1e-4)


def test_state_dict_round_trips(models):
    """The JAX package's own converter (torch -> Flax) gives back the Flax
    values from the port's state_dict, and so does the port's inverse."""
    _, variables, port = models
    back, report = convert_state_dict(NAME, port.state_dict(), variables, strict=True)
    assert report.converted == len(jax.tree_util.tree_leaves(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    params = {"backbone": variables["params"]}
    sd = task_flax_to_state_dict(NAME, {"params": params})
    assert sorted(sd) == sorted("backbone." + k for k in port.state_dict())
    assert sd["backbone.stem.down.conv_block.conv_dw.weight"].shape == (16, 1, 3, 3)
    assert sd["backbone.stages.0.global_block.blocks.conv1.se.fc1.weight"].shape == (8, 16, 1, 1)
    assert sd["backbone.stages.1.blocks.1.attn.qkv.weight"].shape == (64, 32)  # kv only
    again = state_dict_to_task_flax(NAME, sd, {"params": params})
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(again)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(PARAMWISE_CASES))
def test_param_group_labels_equal_jax_leaf_labels(case):
    """``relative_position_bias_table`` (2-D) decays and ``gamma`` (1-D) does
    not, as ``leaf_label`` has it: neither backbone lists a no-decay path."""
    opt_cfg, paramwise = PARAMWISE_CASES[case]
    spec = {"name": "Adam", "params": opt_cfg}
    if paramwise:
        spec["paramwise_cfg"] = paramwise
    jax_backbone = JAX_BACKBONES.get(NAME)(**SCALED)
    params = {"backbone": _random_variables(jax_backbone, 32, 0)["params"],
              "head": {"fc": {"kernel": np.zeros((32, 10), np.float32),
                              "bias": np.zeros((10,), np.float32)}}}
    ref, ref_lrs = _jax_labels(params, JaxConfigNode(copy.deepcopy(spec)),
                               jax_backbone.no_weight_decay())
    backbone = BACKBONES.get(NAME)(**SCALED)
    model = torch.nn.ModuleDict({"backbone": backbone,
                                 "head": torch.nn.ModuleDict({"fc": torch.nn.Linear(32, 10)})})
    assert jax_backbone.no_weight_decay() == [] and not hasattr(backbone, "no_weight_decay")
    got = Constructor.param_labels(list(model.named_parameters()),
                                   ConfigNode(copy.deepcopy(spec)), [])
    name_map = task_name_map(NAME, {"params": params})
    assert sorted(name_map) == sorted(got)
    for key, path in name_map.items():
        assert got[key] == ref[path], f"{key} <- {'.'.join(path)}"
    assert len(set(got.values())) == len(ref_lrs)
    if "weight_decay" in opt_cfg and not (paramwise or {}).get("custom_keys"):
        table = "backbone.stages.0.blocks.0.attn.rel_pos.relative_position_bias_table"
        assert got[table].endswith("wd1.0")
        assert got["backbone.stages.0.blocks.0.ls1.gamma"].endswith("wd0.0")
        assert got["backbone.stem.down.conv_block.conv_dw.weight"].endswith("wd1.0")


def test_registered_variants_have_reference_widths():
    model = BACKBONES.get("gcvit_tiny")(img_size=224)
    assert model.out_encoder_channels == (64, 128, 256, 512)
    assert [len(st.blocks) for st in model.stages] == [3, 4, 19, 5]
    assert [st.blocks[0].attn.num_heads for st in model.stages] == [2, 4, 8, 16]
    assert [st.window_size for st in model.stages] == [7, 7, 14, 7]
    assert [st.global_block.levels for st in model.stages] == [3, 2, 0, 0]
    kinds = [blk.attn.use_global for st in model.stages for blk in st.blocks]
    assert kinds.count(False) == 17 and kinds.count(True) == 14
    assert all(isinstance(blk.ls1, torch.nn.Identity) for st in model.stages for blk in st.blocks)
    assert model.get_stages(2) == ["stem", "stages.0", "stages.1"]
    assert set(BACKBONES.list_models("gcvit*")) == set(
        torchok_tpu_torch.models.backbones.gcvit._VARIANTS) == set(
        JAX_BACKBONES.list_models("gcvit*"))
    base = BACKBONES.get("gcvit_base")(depths=(1, 1, 1, 1))
    assert base.stages[0].blocks[0].ls1.gamma.shape == (128,)
    fixed = BACKBONES.get(NAME)(**{**SMALL, "window_size": (2, 4)})
    assert [st.window_size for st in fixed.stages] == [2, 4]


def test_pretrained_raises():
    with pytest.raises(NotImplementedError, match="pretrained weights are not ported"):
        BACKBONES.get("gcvit_tiny")(pretrained=True)


def _grads(grad_checkpointing, seed):
    backbone = BACKBONES.get(NAME)(**{**SMALL, "drop_path_rate": 0.3,
                                      "grad_checkpointing": grad_checkpointing})
    init = torch.Generator().manual_seed(0)
    for p in backbone.parameters():
        with torch.no_grad():
            p.copy_(0.1 * torch.randn(p.shape, generator=init))
    generator = torch.Generator().manual_seed(seed)
    install_dropout_generator(backbone, generator)
    backbone.train()
    x = torch.randn((4, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    out = backbone(x)
    out.square().mean().backward()
    return out.detach(), {n: p.grad for n, p in backbone.named_parameters()}, generator.get_state()


def test_grad_checkpointing_gives_the_same_gradients_with_drop_path():
    out_a, grads_a, state_a = _grads(False, seed=3)
    before = dict(ops.LAUNCHES)
    out_b, grads_b, state_b = _grads(True, seed=3)
    # every block's forward ran twice (once recomputed), its backward once
    for key, want in ((ops.PLAIN, 4), (ops.PLAIN_GLOBAL, 4), (ops.PLAIN_BWD, 2),
                      (ops.PLAIN_GLOBAL_BWD, 2)):
        assert ops.LAUNCHES[key] - before.get(key, 0) == want, key
    torch.testing.assert_close(out_b, out_a, rtol=0, atol=0)
    # every parameter takes a gradient, the shared query generator included
    assert all(g is not None for g in grads_a.values()) and len(grads_a) > 80
    for name in grads_a:
        torch.testing.assert_close(grads_b[name], grads_a[name], rtol=1e-6, atol=1e-7, msg=name)
    assert torch.equal(state_a, state_b)


# ---------------------------------------------------------------------------
# the slice: 5 train steps of both packages from the same weights
# ---------------------------------------------------------------------------
BACKBONE = dict(embed_dim=16, depths=[2, 2], num_heads=[2, 4], img_size=32,
                window_ratio=[8, 8], pretrained=False)


def test_fit_matches_torchok_tpu_over_5_steps(tmp_path):
    cfg = small_config({"name": "SGD", "params": {"lr": 0.01, "momentum": 0.9,
                                                  "weight_decay": 1e-3}},
                       backbone_name=NAME, backbone_params=BACKBONE)
    initial, final, ref = _fit_jax(cfg)
    trainer, logs, got, launched = _fit_port(cfg, initial, tmp_path)

    # 5 steps + 2 sanity + 2 validation batches; 2 local and 2 global blocks each
    assert launched == {ops.PLAIN: 2 * 9, ops.PLAIN_GLOBAL: 2 * 9, ops.PLAIN_BWD: 2 * 5,
                        ops.PLAIN_GLOBAL_BWD: 2 * 5}
    assert trainer.global_step == 5 and len(got.steps) == len(ref.steps) == 5
    for step, (g, r) in enumerate(zip(got.steps, ref.steps)):
        for key in ("loss", "ce"):
            # f32 on both sides, other summation orders: 1e-4 relative
            assert g[key] == pytest.approx(r[key], rel=1e-4), f"step {step} {key}"
    assert got.steps[0]["loss"] != got.steps[-1]["loss"]
    ref_logs = ref.epochs[-1]
    assert set(logs) == set(ref_logs)
    for key in ("train/loss", "valid/loss"):
        assert logs[key] == pytest.approx(ref_logs[key], rel=1e-4), key
    assert logs["valid/Accuracy"] == ref_logs["valid/Accuracy"]

    want = task_flax_to_state_dict(NAME, {"params": final})
    start = task_flax_to_state_dict(NAME, {"params": initial})
    state_dict = trainer.state.model.state_dict()
    assert sorted(want) == sorted(state_dict)
    moved = []
    for key, value in state_dict.items():
        # SGD: the difference scales with the gradient difference itself
        np.testing.assert_allclose(value.numpy(), want[key], rtol=0, atol=2e-5, err_msg=key)
        if np.abs(value.numpy() - start[key]).max() > 0:
            moved.append(key)
    assert len(moved) > 0.9 * len(state_dict)
    # the bias tables start at zero and learn through the ops' dbias; the
    # query generator learns through dqg
    assert any("relative_position_bias_table" in k for k in moved)
    assert any("global_block" in k for k in moved)


def test_mode_test_runs_the_slice():
    cfg = small_config({"name": "SGD", "params": {"lr": 0.1}}, backbone_name=NAME,
                       backbone_params=BACKBONE)
    cfg["data"]["TEST"] = cfg["data"]["VALID"]
    before = dict(ops.LAUNCHES)
    trainer, logs = run(cfg, "test")
    assert 0.0 <= logs["test/Accuracy"] <= 1.0 and trainer.last_eval["images"] == 8
    assert ops.LAUNCHES[ops.PLAIN] - before.get(ops.PLAIN, 0) == 4
    assert ops.LAUNCHES[ops.PLAIN_BWD] == before.get(ops.PLAIN_BWD, 0)


def test_recipes_equal_chip_smoke_configs():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for recipe, cfg in (("classification_gcvit_tiny_synthetic", chip_smoke.GCVIT_SLICE_CONFIG),
                        ("classification_gcvit_tiny_synthetic_train",
                         chip_smoke.GCVIT_TRAIN_CONFIG),
                        ("classification_davit_t_synthetic_train",
                         chip_smoke.DAVIT_TRAIN_CONFIG)):
        assert load_config(REPO / "configs", recipe).to_dict() == cfg, recipe
    model = BACKBONES.get("gcvit_tiny")(img_size=224)
    stages = [(56 >> i, 56 >> i, 64 << i, st.blocks[0].attn.num_heads, st.window_size,
               sum(not b.attn.use_global for b in st.blocks),
               sum(b.attn.use_global for b in st.blocks)) for i, st in enumerate(model.stages)]
    assert tuple(stages) == chip_smoke.GCVIT_STAGES
    assert (chip_smoke.GCVIT_LOCAL, chip_smoke.GCVIT_GLOBAL) == (17, 14)
    assert chip_smoke.DAVIT_SPATIAL == 6
