"""The port's DaViT backbone and its classification slice against
``torchok_tpu``'s, with the Flax weights carried across by ``flax_convert``.

The JAX side runs its fused Pallas window attention (no-bias mode) in
interpret mode; the port runs its plain version on the CPU. Both in float32,
at a narrow width: two stages of one dual block each, windows of 4.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu_torch
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.utils.torch_convert import convert_state_dict
from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.constructor.constructor import Constructor
from torchok_tpu_torch.ops import window_attention_dot as ops
from torchok_tpu_torch.ops.common import install_dropout_generator
from torchok_tpu_torch.utils.flax_convert import (flax_to_state_dict, state_dict_to_task_flax,
                                                  task_flax_to_state_dict, task_name_map)
from tests.test_torch_gcvit import _random_variables, _to_torch
from tests.test_torch_losses_optim import PARAMWISE_CASES, _jax_labels
from tests.test_torch_train_slice import _fit_jax, _fit_port, small_config

NAME = "davit_t"  # the registry entry that both packages narrow by keyword
SMALL = dict(embed_dims=(16, 32), num_heads=(2, 4), depths=(1, 1), window_size=4,
             drop_path_rate=0.0, pretrained=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: at these sizes more threads only
    contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    flax_model = JAX_BACKBONES.get(NAME)(**SMALL)
    variables = _random_variables(flax_model, 32, 2)
    port = BACKBONES.get(NAME)(**SMALL).eval()
    port.load_state_dict(_to_torch(flax_to_state_dict(NAME, variables)), strict=True)
    return flax_model, variables, port


# 40 px: a 10x10 map padded to 12x12 for ws 4, then a 5x5 map padded to 8x8;
# 12 px: a 3x3 map that shrinks the window to 3, then a 1x1 map
@pytest.mark.parametrize("size", [32, 40, 12], ids=["exact", "padded", "shrunk"])
def test_backbone_matches_flax(monkeypatch, models, size):
    monkeypatch.setenv("TORCHOK_WINDOW_ATTN_PALLAS", "1")  # the fused Pallas path
    flax_model, variables, port = models
    x = np.random.default_rng(0).normal(size=(2, size, size, 3)).astype(np.float32)
    # one compiled function (eager, each primitive and the Pallas kernels in
    # interpret mode would compile on their own)
    ref, ref_out = jax.jit(lambda v, xx: (flax_model.apply(v, xx, return_features=True),
                                          flax_model.apply(v, xx)))(variables, jnp.asarray(x))
    before = dict(ops.LAUNCHES)
    with torch.no_grad():
        image = torch.from_numpy(x).permute(0, 3, 1, 2)
        got, got_out = port.forward_features(image), port(image)
    assert ops.LAUNCHES[ops.PLAIN] == before.get(ops.PLAIN, 0) + 4  # 2 spatial blocks, twice
    assert len(got) == len(ref) == 3
    # f32 on both sides; sum order in LayerNorm, the convs and the MLP differs
    for g, r in zip(got[1:] + [got_out], list(ref[1:]) + [ref_out]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


def test_state_dict_round_trips(models):
    _, variables, port = models
    back, report = convert_state_dict(NAME, port.state_dict(), variables, strict=True)
    assert report.converted == len(jax.tree_util.tree_leaves(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    params = {"backbone": variables["params"]}
    sd = task_flax_to_state_dict(NAME, {"params": params})
    assert sorted(sd) == sorted("backbone." + k for k in port.state_dict())
    assert sd["backbone.main_blocks.1.0.1.cpe.1.proj.weight"].shape == (32, 1, 3, 3)
    assert sd["backbone.patch_embeds.0.proj.weight"].shape == (16, 3, 7, 7)
    again = state_dict_to_task_flax(NAME, sd, {"params": params})
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(again)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(PARAMWISE_CASES))
def test_param_group_labels_equal_jax_leaf_labels(case):
    opt_cfg, paramwise = PARAMWISE_CASES[case]
    spec = {"name": "Adam", "params": opt_cfg}
    if paramwise:
        spec["paramwise_cfg"] = paramwise
    jax_backbone = JAX_BACKBONES.get(NAME)(**SMALL)
    params = {"backbone": _random_variables(jax_backbone, 32, 0)["params"],
              "head": {"fc": {"kernel": np.zeros((32, 10), np.float32),
                              "bias": np.zeros((10,), np.float32)}}}
    ref, ref_lrs = _jax_labels(params, JaxConfigNode(copy.deepcopy(spec)),
                               jax_backbone.no_weight_decay())
    backbone = BACKBONES.get(NAME)(**SMALL)
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


def test_registered_variants_have_reference_widths():
    model = BACKBONES.get("davit_t")()
    assert model.out_encoder_channels == (96, 192, 384, 768) and model.out_channels == 768
    assert [len(duals) for duals in model.main_blocks] == [1, 1, 3, 1]
    assert [duals[0][0].attn.num_heads for duals in model.main_blocks] == [3, 6, 12, 24]
    assert all(duals[0][0].window_size == 7 for duals in model.main_blocks)
    # drop path grows linearly over the 12 blocks up to 0.1
    assert model.main_blocks[3][0][1].drop_path.rate == pytest.approx(0.1)
    assert model.main_blocks[0][0][0].drop_path.rate == 0.0
    assert model.get_stages(1) == ["patch_embeds.0", "main_blocks.0", "patch_embeds.1"]
    assert set(BACKBONES.list_models("davit*")) == set(
        torchok_tpu_torch.models.backbones.davit._VARIANTS) == set(
        JAX_BACKBONES.list_models("davit*"))
    with pytest.raises(NotImplementedError, match="pretrained weights are not ported"):
        BACKBONES.get("davit_s")(pretrained=True)


def test_channel_attention_keeps_its_logits_in_f32_under_autocast():
    """k^T v stays f32 through the softmax; only the weights are rounded."""
    attn = torchok_tpu_torch.models.backbones.davit.ChannelAttention(16, 2, qkv_bias=True)
    x = torch.randn((2, 9, 16), generator=torch.Generator().manual_seed(0))
    ref = attn(x)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = attn(x)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=3e-2)


def test_grad_checkpointing_gives_the_same_gradients_with_drop_path():
    def grads(grad_checkpointing):
        backbone = BACKBONES.get(NAME)(**{**SMALL, "drop_path_rate": 0.3,
                                          "grad_checkpointing": grad_checkpointing})
        init = torch.Generator().manual_seed(0)
        for p in backbone.parameters():
            with torch.no_grad():
                p.copy_(0.1 * torch.randn(p.shape, generator=init))
        generator = torch.Generator().manual_seed(3)
        install_dropout_generator(backbone, generator)
        backbone.train()
        out = backbone(torch.randn((4, 3, 32, 32), generator=torch.Generator().manual_seed(1)))
        out.square().mean().backward()
        return out.detach(), {n: p.grad for n, p in backbone.named_parameters()}, \
            generator.get_state()

    out_a, grads_a, state_a = grads(False)
    before = dict(ops.LAUNCHES)
    out_b, grads_b, state_b = grads(True)
    assert ops.LAUNCHES[ops.PLAIN] - before.get(ops.PLAIN, 0) == 4  # each forward twice
    assert ops.LAUNCHES[ops.PLAIN_BWD] - before.get(ops.PLAIN_BWD, 0) == 2
    torch.testing.assert_close(out_b, out_a, rtol=0, atol=0)
    assert all(g is not None for g in grads_a.values()) and len(grads_a) > 60
    for name in grads_a:
        torch.testing.assert_close(grads_b[name], grads_a[name], rtol=1e-6, atol=1e-7, msg=name)
    assert torch.equal(state_a, state_b)


def test_fit_matches_torchok_tpu_over_5_steps(tmp_path):
    backbone = dict(embed_dims=[16, 32], num_heads=[2, 4], depths=[1, 1], window_size=4,
                    drop_path_rate=0.0, pretrained=False)
    cfg = small_config({"name": "SGD", "params": {"lr": 0.01, "momentum": 0.9,
                                                  "weight_decay": 1e-3}},
                       backbone_name=NAME, backbone_params=backbone)
    initial, final, ref = _fit_jax(cfg)
    trainer, logs, got, launched = _fit_port(cfg, initial, tmp_path)
    # 5 steps + 2 sanity + 2 validation batches, 2 spatial blocks, no bias
    assert launched == {ops.PLAIN: 2 * 9, ops.PLAIN_BWD: 2 * 5}
    assert len(got.steps) == len(ref.steps) == 5
    for step, (g, r) in enumerate(zip(got.steps, ref.steps)):
        # f32 on both sides, other summation orders: 1e-4 relative
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-4), f"step {step}"
    assert logs["valid/loss"] == pytest.approx(ref.epochs[-1]["valid/loss"], rel=1e-4)
    want = task_flax_to_state_dict(NAME, {"params": final})
    state_dict = trainer.state.model.state_dict()
    assert sorted(want) == sorted(state_dict)
    for key, value in state_dict.items():
        np.testing.assert_allclose(value.numpy(), want[key], rtol=0, atol=2e-5, err_msg=key)
