"""The port's ViT backbone against ``torchok_tpu``'s, with the Flax weights
carried across by ``flax_convert``.

Both packages in float32 at a narrow width (width 32, depth 2, 2 heads,
patch 8, 32 to 48 px images); the JAX applies are jitted. Forwards and
parameter gradients are held to 1e-5 of the largest magnitude (f32 rounding
in other orders of summation through two blocks). The JAX ViT calls no
Pallas kernel, so nothing here runs one either.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.ops.common import install_dropout_generator
from torchok_tpu_torch.ops.image import resize_linear
from torchok_tpu_torch.utils.flax_convert import flax_to_state_dict, state_dict_to_task_flax

NAME = "vit_tiny_patch16_224"  # the registry entry both packages narrow by keyword
TINY = dict(embed_dim=32, depth=2, num_heads=2, patch_size=8, img_size=32)
TOL = 1e-5  # of the largest magnitude


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_variables(model, shape, seed, scale=0.1):
    """Random leaves of the shapes an init at ``shape`` (NHWC) gives."""
    x = jnp.zeros(shape, jnp.float32)
    shapes = jax.eval_shape(lambda xx: model.init(jax.random.PRNGKey(0), xx, train=False), x)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.normal(size=s.shape)).astype(np.float32), shapes)


def to_torch(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def check_parity(name, cfg, init_hw, hw, seed=0):
    """Forward (pooled and ``return_features``) and every parameter's
    gradient of a scalar loss, port against Flax, at input ``hw``."""
    flax_model = JAX_BACKBONES.get(name)(**cfg)
    variables = random_variables(flax_model, (1, *init_hw, 3), seed)
    port = BACKBONES.get(name)(**cfg)
    if hasattr(port, "set_input_size"):
        port.set_input_size(init_hw)
    port.load_state_dict(to_torch(flax_to_state_dict(name, variables)), strict=True)
    x = np.random.default_rng(seed + 1).normal(size=(2, *hw, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def loss_fn(params, xx):
        pooled = flax_model.apply({"params": params}, xx)
        fmap = flax_model.apply({"params": params}, xx, return_features=True)[-1]
        return jnp.sum(pooled * jnp.cos(pooled)) + jnp.sum(jnp.sin(fmap)), (pooled, fmap)

    (_, (pooled, fmap)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], jnp.asarray(x))
    pooled_t = port(xt)
    feats = port.forward_features(xt)
    assert len(feats) == 5 and feats[0] is xt and all(f is feats[1] for f in feats[1:])
    (torch.sum(pooled_t * torch.cos(pooled_t)) + torch.sum(torch.sin(feats[-1]))).backward()
    assert rel_err(pooled_t.detach(), pooled) <= TOL
    assert rel_err(feats[-1].detach().permute(0, 2, 3, 1), fmap) <= TOL
    ref_grads = flax_to_state_dict(name, {"params": jax.tree_util.tree_map(np.asarray, grads)})
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(ref_grads)
    largest = max(np.abs(g).max() for g in ref_grads.values())
    for n, g in ref_grads.items():
        assert np.abs(got[n].numpy() - g).max() <= TOL * largest, n
    return port


# grid 4x4 at the table's own size, a non-square one that grows (5x6), one
# that shrinks in both axes (a 6x6 table at 4x5: antialiased) and one that
# shrinks one axis and grows the other
CASES = {
    "class_token": (TINY, (32, 32), (32, 32)),
    "no_class_token": (dict(TINY, class_token=False), (32, 32), (32, 32)),
    "no_embed_class": (dict(TINY, no_embed_class=True), (32, 32), (40, 48)),
    "init_values": (dict(TINY, init_values=0.1), (32, 32), (32, 32)),
    "grows_non_square": (TINY, (32, 32), (40, 48)),
    "shrinks": (dict(TINY, img_size=48), (48, 48), (32, 40)),
    "shrinks_and_grows": (dict(TINY, img_size=48, no_embed_class=True), (48, 48), (24, 64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_flax(case):
    cfg, init_hw, hw = CASES[case]
    check_parity(NAME, cfg, init_hw, hw)


@pytest.mark.parametrize("hw,size", [((4, 4), (5, 6)), ((6, 6), (4, 5)), ((6, 6), (3, 9)),
                                     ((14, 14), (25, 42)), ((24, 24), (14, 14))])
def test_resize_linear_is_jax_image_resize(hw, size):
    """The position table's resampling: ``jax.image.resize(..., "linear")``,
    antialiased where an axis shrinks (two-tap bilinear is not)."""
    x = np.random.default_rng(0).normal(size=(1, *hw, 8)).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (1, *size, 8), "linear"))
    got = resize_linear(torch.from_numpy(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    if size[0] < hw[0]:
        plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size,
                                                mode="bilinear", align_corners=False)
        assert np.abs(plain.permute(0, 2, 3, 1).numpy() - ref).max() > 1e-2


def _grads(cfg, checkpointing, x, seed=3):
    port = BACKBONES.get(NAME)(**cfg, grad_checkpointing=checkpointing).train()
    port.init_weights(torch.Generator().manual_seed(seed))
    generator = torch.Generator().manual_seed(11)
    install_dropout_generator(port, generator)
    out = port(x)
    (out * torch.arange(out.shape[-1])).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in port.named_parameters()}


def test_grad_checkpointing_gives_the_same_gradients():
    """Recomputed blocks (drop path 0.3, dropout 0.1 on the generator) give
    the gradients of kept activations."""
    cfg = dict(TINY, drop_path_rate=0.3, drop_rate=0.1, init_values=0.5)
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    out_a, a = _grads(cfg, False, x)
    out_b, b = _grads(cfg, True, x)
    assert torch.equal(out_a, out_b)
    for n in a:
        torch.testing.assert_close(b[n], a[n], rtol=0, atol=1e-6, msg=n)


def law_moments(name, flax_model, port, shape):
    """Per tensor: both packages' initial draws have the same law (mean,
    spread, largest magnitude); constants are equal."""
    params = jax.jit(lambda key: flax_model.init(key, jnp.zeros(shape), train=False))(
        jax.random.PRNGKey(0))["params"]
    ref = flax_to_state_dict(name, {"params": jax.tree_util.tree_map(np.asarray, params)})
    port.init_weights(torch.Generator().manual_seed(0))
    got = {n: p.detach().numpy() for n, p in port.named_parameters()}
    assert set(got) == set(ref)
    for n, r in ref.items():
        g = got[n]
        if r.std() == 0:
            np.testing.assert_array_equal(g, r, err_msg=n)
            continue
        assert abs(g.std() / r.std() - 1) < 0.15, (n, g.std(), r.std())
        assert abs(g.mean() - r.mean()) < 5 * r.std() / np.sqrt(r.size), n
        assert 0.75 < np.abs(g).max() / np.abs(r).max() < 1.33, n


def test_initial_law_matches_flax():
    cfg = dict(embed_dim=64, depth=2, num_heads=2, patch_size=8, img_size=64, init_values=0.3)
    law_moments(NAME, JAX_BACKBONES.get(NAME)(**cfg), BACKBONES.get(NAME)(**cfg),
                (1, 64, 64, 3))


def test_weights_carry_both_ways():
    cfg = dict(TINY, init_values=0.2)
    variables = random_variables(JAX_BACKBONES.get(NAME)(**cfg), (1, 32, 32, 3), 5)
    sd = flax_to_state_dict(NAME, variables)
    port = BACKBONES.get(NAME)(**cfg)
    port.load_state_dict(to_torch(sd), strict=True)
    assert "blocks.1.ls2.gamma" in sd and "patch_embed.proj.weight" in sd
    state = {f"backbone.{k}": v for k, v in port.state_dict().items()}
    back = state_dict_to_task_flax(NAME, state, {"params": {"backbone": variables["params"]}})
    back = back["backbone"]
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def _config(name, cfg):
    if "beit" in name:
        keys = ("embed_dim", "depth", "num_heads", "patch_size", "img_size", "mlp_ratio",
                "qkv_bias", "init_values", "use_abs_pos_emb", "use_rel_pos_bias",
                "use_shared_rel_pos_bias")
    else:
        keys = ("embed_dim", "depth", "num_heads", "patch_size", "img_size", "mlp_ratio",
                "qkv_bias", "init_values", "class_token", "no_embed_class")
    return {k: getattr(cfg, k) for k in keys}


def port_config(name, m):
    """A meta-device port model's configuration, read off its modules."""
    blk = m.blocks[0]
    proj = m.patch_embed.proj
    cfg = {"embed_dim": m.embed_dim, "depth": len(m.blocks), "num_heads": blk.attn.num_heads,
           "patch_size": proj.kernel_size[0],
           "mlp_ratio": blk.mlp.fc1.out_features / m.embed_dim}
    if "beit" in name:
        cfg.update(img_size=m.grid[0] * proj.kernel_size[0], qkv_bias=blk.attn.q_bias is not None,
                   init_values=blk.init_values, use_abs_pos_emb=m.pos_embed is not None,
                   use_rel_pos_bias=blk.attn.rel is not None,
                   use_shared_rel_pos_bias=m.rel_pos_bias is not None)
    else:
        cfg.update(img_size=m.base_grid * proj.kernel_size[0],
                   qkv_bias=blk.attn.qkv.bias is not None,
                   init_values=getattr(blk.ls1, "init_values", None),
                   class_token=m.cls_token is not None, no_embed_class=m.no_embed_class)
    return cfg


def test_all_53_names_resolve_to_their_jax_configs():
    """Every ViT and BEiT name of the JAX registry is in the port's and
    builds the same architecture (the port's on the meta device: the
    gigantic ViT has 1.8 billion parameters)."""
    names = sorted(n for n in JAX_BACKBONES.entries if n.startswith(("vit_", "beit_")))
    ours = sorted(n for n in BACKBONES.entries if n.startswith(("vit_", "beit_")))
    assert names == ours
    assert (sum(n.startswith("vit_") for n in names), sum(n.startswith("beit_") for n in names)) \
        == (46, 7)
    for name in names:
        want = _config(name, JAX_BACKBONES.get(name)())
        with torch.device("meta"):
            got = port_config(name, BACKBONES.get(name)())
        # int(c * mlp_ratio) hidden units in both: compare the widths built
        want["mlp_ratio"] = int(want["embed_dim"] * want["mlp_ratio"]) / want["embed_dim"]
        assert got == want, name


def test_recipes_equal_chip_smoke_configs():
    """The four ViT and BEiT recipes are the dicts chip_smoke.py drives
    (bench.py's vit_small_224_bs128 and beit_base_224_bs128: no pooling)."""
    import importlib.util
    from pathlib import Path

    from torchok_tpu_torch.constructor.config import load_config
    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    for recipe, cfg in (("classification_vit_small_synthetic", chip_smoke.VIT_SLICE_CONFIG),
                        ("classification_vit_small_synthetic_train", chip_smoke.VIT_TRAIN_CONFIG),
                        ("classification_beit_base_synthetic", chip_smoke.BEIT_SLICE_CONFIG),
                        ("classification_beit_base_synthetic_train",
                         chip_smoke.BEIT_TRAIN_CONFIG)):
        assert load_config(repo / "configs", recipe).to_dict() == cfg, recipe
        assert "pooling_name" not in cfg["task"]["params"]
