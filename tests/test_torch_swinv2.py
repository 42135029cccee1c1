"""The port's SwinV2 backbone, pooling and head against ``torchok_tpu``'s,
with the Flax weights carried across by ``flax_to_state_dict``.

The JAX side runs its fused Pallas attention in interpret mode (as its own
tests do); the port runs its plain attention on the CPU. Both in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu_torch
from torchok_tpu.models.backbones.swin import SwinTransformerV2 as FlaxSwinV2
from torchok_tpu.models.heads.classification.classification_head import \
    ClassificationHead as FlaxHead
from torchok_tpu.utils.torch_convert import convert_state_dict
from torchok_tpu_torch.constructor import BACKBONES, HEADS, POOLINGS
from torchok_tpu_torch.utils.flax_convert import flax_to_state_dict

SMALL = dict(img_size=32, patch_size=4, window_size=4, embed_dim=16,
             depths=(2, 2), num_heads=(2, 4), drop_path_rate=0.0)
# 24 px: a 6x6 map padded to 8x8 for ws 4, then a 3x3 map that shrinks ws to 3
PADDED = dict(SMALL, img_size=24)


def _perturbed(variables, seed):
    """Init values leave q/v biases at 0 and logit scales equal; move every
    leaf so that each parameter reaches the output."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32), variables)


def _to_torch(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def small_variables():
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return _perturbed(FlaxSwinV2(**SMALL).init(jax.random.PRNGKey(0), x), 1)


@pytest.mark.parametrize("cfg", [SMALL, PADDED], ids=["small", "padded"])
def test_backbone_matches_flax(monkeypatch, small_variables, cfg):
    monkeypatch.setenv("TORCHOK_WINDOW_ATTN_PALLAS", "1")  # the fused Pallas path
    x = np.random.default_rng(0).normal(size=(2, cfg["img_size"], cfg["img_size"], 3))
    x = x.astype(np.float32)
    flax_model = FlaxSwinV2(**cfg)
    # no parameter shape depends on the input size
    variables = small_variables
    ref = flax_model.apply(variables, jnp.asarray(x), return_features=True)

    port = BACKBONES.get("swinv2_custom")(**cfg).eval()
    port.load_state_dict(_to_torch(flax_to_state_dict("swinv2_custom", variables)),
                         strict=True)
    with torch.no_grad():
        got = port.forward_features(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref)
    # sum order in LayerNorm and the MLP differs between the two frameworks
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=5e-4, atol=5e-5)


def test_state_dict_round_trip_is_exact(small_variables):
    """convert_state_dict (torch -> Flax, the JAX package's own converter)
    must give back the original Flax values from the port's state_dict."""
    variables = small_variables
    port = BACKBONES.get("swinv2_custom")(**SMALL)
    port.load_state_dict(_to_torch(flax_to_state_dict("swinv2_custom", variables)),
                         strict=True)
    back, report = convert_state_dict("swinv2_custom", port.state_dict(), variables,
                                      strict=True)
    assert report.converted == len(jax.tree_util.tree_leaves(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pooling_and_head_match_flax():
    feats = np.random.default_rng(3).normal(size=(3, 4, 4, 32)).astype(np.float32)
    pooled = np.asarray(jnp.mean(jnp.asarray(feats), axis=(1, 2)))
    pool = POOLINGS.get("Pooling")(in_channels=32)
    got_pooled = pool(torch.from_numpy(feats).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_pooled.numpy(), pooled, rtol=1e-6, atol=1e-6)
    assert pool.out_channels == 32 and not list(pool.parameters())

    flax_head = FlaxHead(in_channels=32, num_classes=7)
    variables = _perturbed(flax_head.init(jax.random.PRNGKey(2), jnp.asarray(pooled)), 4)
    head = HEADS.get("ClassificationHead")(in_channels=32, num_classes=7)
    head.load_state_dict(_to_torch(flax_to_state_dict("ClassificationHead", variables)),
                         strict=True)
    with torch.no_grad():
        got = head(got_pooled)
    np.testing.assert_allclose(got.numpy(), np.asarray(flax_head.apply(variables, pooled)),
                               rtol=1e-5, atol=1e-6)
    back, _ = convert_state_dict("swinv2_custom", head.state_dict(), variables, strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_registered_variants_have_reference_widths():
    model = BACKBONES.get("swinv2_tiny_window8_256")()
    assert model.out_encoder_channels == (96, 192, 384, 768)
    heads = [blk.attn.num_heads for st in model.layers for blk in st.blocks]
    assert heads == [3] * 2 + [6] * 2 + [12] * 6 + [24] * 2
    assert set(BACKBONES.list_models("swinv2*")) == set(
        torchok_tpu_torch.models.backbones.swin._VARIANTS) | {"swinv2_custom"}
