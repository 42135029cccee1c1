"""The port's BEiT backbone against ``torchok_tpu``'s, with the Flax weights
carried across by ``flax_convert``: forwards and gradients in float32 at a
narrow width (width 32, depth 2, 2 heads, patch 8), per-block and shared
relative position bias, absolute position embedding on and off, square and
non-square grids, held to 1e-5 of the largest magnitude; the relative
position index, the initial law, the bridge both ways, checkpointing and the
tables' sizing by a task's ``inputs``. The JAX BEiT calls no Pallas kernel.
"""
import jax
import numpy as np
import pytest
import torch

import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu.models.backbones.beit import _rel_pos_index as jax_rel_pos_index
from torchok_tpu_torch.constructor import BACKBONES, TASKS
from torchok_tpu_torch.constructor.config import config_from_dict
from torchok_tpu_torch.constructor.config_structure import merge_structured
from torchok_tpu_torch.models.backbones.beit import rel_pos_index
from torchok_tpu_torch.ops.common import install_dropout_generator
from torchok_tpu_torch.utils.flax_convert import flax_to_state_dict, state_dict_to_task_flax
from tests.test_torch_vit import check_parity, law_moments, random_variables, to_torch

NAME = "beit_base_patch16_224"
TINY = dict(embed_dim=32, depth=2, num_heads=2, patch_size=8, img_size=32, init_values=0.1)

CASES = {
    "per_block": (TINY, (32, 32)),
    "shared": (dict(TINY, use_rel_pos_bias=False, use_shared_rel_pos_bias=True), (32, 32)),
    "abs_pos": (dict(TINY, use_abs_pos_emb=True), (32, 32)),
    "abs_pos_no_rel": (dict(TINY, use_abs_pos_emb=True, use_rel_pos_bias=False,
                            init_values=None, qkv_bias=False), (32, 32)),
    "non_square": (dict(TINY, use_abs_pos_emb=True, use_shared_rel_pos_bias=True), (32, 48)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_flax(case):
    """The tables are zero at init: random ones make the bias count."""
    cfg, hw = CASES[case]
    check_parity(NAME, cfg, hw, hw)


@pytest.mark.parametrize("grid", [(4, 4), (3, 5), (6, 2)])
def test_relative_position_index(grid):
    np.testing.assert_array_equal(rel_pos_index(grid), jax_rel_pos_index(grid))


def test_another_grid_raises():
    port = BACKBONES.get(NAME)(**TINY)
    with pytest.raises(ValueError, match="position tables hold"):
        port(torch.zeros(1, 3, 40, 32))


def test_initial_law_matches_flax():
    cfg = dict(embed_dim=64, depth=2, num_heads=2, patch_size=8, img_size=64,
               use_abs_pos_emb=True, use_shared_rel_pos_bias=True)
    law_moments(NAME, JAX_BACKBONES.get(NAME)(**cfg), BACKBONES.get(NAME)(**cfg),
                (1, 64, 64, 3))


@pytest.mark.parametrize("case", ["per_block", "shared"])
def test_weights_carry_both_ways(case):
    cfg, hw = CASES[case]
    variables = random_variables(JAX_BACKBONES.get(NAME)(**cfg), (1, *hw, 3), 5)
    sd = flax_to_state_dict(NAME, variables)
    want = ("blocks.1.attn.relative_position_bias_table" if case == "per_block"
            else "rel_pos_bias.relative_position_bias_table")
    assert {want, "patch_embed.proj.weight", "blocks.0.gamma_1", "blocks.0.attn.q_bias"} <= set(sd)
    port = BACKBONES.get(NAME)(**cfg)
    port.load_state_dict(to_torch(sd), strict=True)
    state = {f"backbone.{k}": v for k, v in port.state_dict().items()}
    back = state_dict_to_task_flax(NAME, state, {"params": {"backbone": variables["params"]}})
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back["backbone"]))
    for path, leaf in flat:
        node = back["backbone"]
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_grad_checkpointing_gives_the_same_gradients():
    cfg = dict(TINY, drop_path_rate=0.3, drop_rate=0.1, use_shared_rel_pos_bias=True)
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    grads = []
    for checkpointing in (False, True):
        port = BACKBONES.get(NAME)(**cfg, grad_checkpointing=checkpointing).train()
        port.init_weights(torch.Generator().manual_seed(3))
        with torch.no_grad():  # tables off zero, so their gradients are not trivial
            for n, p in port.named_parameters():
                if "relative_position" in n:
                    p.normal_(0, 0.5, generator=torch.Generator().manual_seed(4))
        install_dropout_generator(port, torch.Generator().manual_seed(11))
        out = port(x)
        (out * torch.arange(out.shape[-1])).sum().backward()
        grads.append({n: p.grad.clone() for n, p in port.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=1e-6, msg=n)


def test_a_task_sizes_the_tables_by_its_inputs():
    """As the JAX package's init sizes them from the example input."""
    cfg = {"task": {"name": "ClassificationTask",
                    "params": {"backbone_name": NAME,
                               "backbone_params": dict(TINY, use_abs_pos_emb=True),
                               "head_name": "ClassificationHead",
                               "head_params": {"num_classes": 3},
                               "inputs": [{"shape": [3, 40, 56], "dtype": "float32"}]}},
           "data": {}, "trainer": {"accelerator": "cpu"}}
    config = merge_structured(config_from_dict(cfg))
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    backbone = task.model.backbone
    assert backbone.grid == (5, 7)
    assert backbone.pos_embed.shape == (1, 36, 32)
    assert backbone.blocks[0].attn.relative_position_bias_table.shape == (9 * 13 + 3, 2)
    task.init_weights(torch.Generator().manual_seed(0))
    out = task.model({"image": torch.zeros(2, 3, 40, 56)})
    assert out["prediction"].shape == (2, 3)
