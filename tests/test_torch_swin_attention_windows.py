"""The port's fused SwinV2 attention at every window size of the registered
variants against ``torchok_tpu``'s, and the recipes that run those windows on
the card.

On the CPU the port's op runs its plain versions (forward and the
hand-written backward), held against the JAX package on the same numpy
inputs: at ws 6, 12 and 16 its Pallas kernels in interpret mode, at ws 24
(L = 576) its XLA formulation ``window_attention``, which is what the JAX
package itself runs there (its Pallas kernel's VMEM gate sends L = 576
away). The Hopper kernels are held against the plain versions on the card in
``test_torch_cuda_kernels.py``.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.models.backbones.swin import _shift_window_region_ids
from torchok_tpu.ops import swin_attention as jax_ops
from torchok_tpu.ops.window_attention import window_attention as jax_window_attention
from torchok_tpu.parallel import mesh as jax_mesh
from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.constructor.config import load_config
from torchok_tpu_torch.models.backbones import swin as swin_module
from torchok_tpu_torch.ops import swin_attention as ops

REPO = Path(__file__).resolve().parent.parent
HEADS, HEAD_DIM = 2, 8  # batch 1, two heads, a 2 x 2 window grid


@pytest.fixture(autouse=True)
def no_active_mesh(monkeypatch):
    """The JAX package's ops shard over an active multi-device mesh and
    refuse a batch that does not divide it; a fit run earlier in this
    process may have left its mesh active."""
    monkeypatch.setattr(jax_mesh, "_CURRENT_MESH", None)


def _inputs(ws, masked, seed):
    rng = np.random.default_rng(seed)
    hp = wp = 2 * ws
    L = ws * ws
    qkv = rng.normal(size=(1, hp, wp, 3 * HEADS * HEAD_DIM)).astype(np.float32)
    logit_scale = (np.log(10.0) + 0.3 * rng.normal(size=(HEADS,))).astype(np.float32)
    bias = (16.0 / (1.0 + np.exp(-rng.normal(size=(HEADS, L, L))))).astype(np.float32)
    dout = rng.normal(size=(1, hp, wp, HEADS * HEAD_DIM)).astype(np.float32)
    mask = None
    if masked:
        ids = _shift_window_region_ids(hp, wp, ws, ws // 2)
        mask = np.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0).astype(np.float32)
    return qkv, logit_scale, bias, mask, dout


def _jax_pallas(ws, mask):
    m = None if mask is None else jnp.asarray(mask)

    def f(qkv, logit_scale, bias):
        return jax_ops.fused_swin_attention(qkv, logit_scale, bias, m, ws=ws, nheads=HEADS,
                                            interpret=True)
    return f


def _jax_xla(ws, mask):
    """The JAX package's XLA formulation on the windows of the spatial map."""
    m = None if mask is None else jnp.asarray(mask)

    def f(qkv, logit_scale, bias):
        b, hp, wp, _ = qkv.shape
        win = jax_ops.window_partition(qkv, ws)  # (B * nW, L, 3C)
        win = win.reshape(win.shape[0], ws * ws, 3, HEADS, HEAD_DIM).transpose(2, 0, 3, 1, 4)
        out = jax_window_attention(win[0], win[1], win[2], logit_scale, bias, m)
        out = out.transpose(0, 2, 1, 3).reshape(-1, ws * ws, HEADS * HEAD_DIM)
        return jax_ops.window_reverse(out, ws, hp, wp)
    return f


def _jax(fn, qkv, logit_scale, bias, dout):
    """out and the three input gradients, as one jitted call (the interpreter
    and the einsums then compile once instead of dispatching op by op)."""
    def out_and_grads(q, s, b, d):
        out, vjp = jax.vjp(fn, q, s, b)
        return (out, *vjp(d))
    got = jax.jit(out_and_grads)(*(jnp.asarray(a) for a in (qkv, logit_scale, bias, dout)))
    return [np.asarray(t) for t in got]


def _port(ws, qkv, logit_scale, bias, mask, dout):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qkv, logit_scale, bias)]
    m = None if mask is None else torch.from_numpy(mask)
    out = ops.fused_swin_attention(*leaves, m, ws=ws, nheads=HEADS)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    return [t.detach().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("ws", [6, 12, 16, 24], ids=["ws6_L36", "ws12_L144", "ws16_L256",
                                                      "ws24_L576"])
def test_forward_and_backward_match_the_reference_at_every_window_size(ws):
    """out, dqkv, dlogit_scale and dbias, f32, unmasked and with the shift
    mask. f32 throughout, so only the summation order (and, at ws 24, the
    reference's x / (|x| + eps) against rsqrt(|x|^2 + eps)) differs: out and
    dqkv within 1e-5 of their largest entry, the sums over every window and
    token (dlogit_scale, dbias) within 1e-4 of theirs."""
    reference = _jax_xla if ws == 24 else _jax_pallas
    for masked in (False, True):
        qkv, logit_scale, bias, mask, dout = _inputs(ws, masked, seed=ws)
        ref = _jax(reference(ws, mask), qkv, logit_scale, bias, dout)
        got = _port(ws, qkv, logit_scale, bias, mask, dout)
        for name, g, r, rel in zip(("out", "dqkv", "dlogit_scale", "dbias"), got, ref,
                                   (1e-5, 1e-5, 1e-4, 1e-4)):
            assert g.shape == r.shape, (masked, name)
            assert np.abs(g - r).max() <= rel * max(np.abs(r).max(), 1.0), (masked, name)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("recipe,config,windows", [
    ("classification_swinv2_tiny_window16_synthetic", "WINDOW16_SLICE_CONFIG", (16, 16, 16, 8)),
    ("classification_swinv2_tiny_window16_synthetic_train", "WINDOW16_TRAIN_CONFIG",
     (16, 16, 16, 8)),
    ("classification_swinv2_base_window24_384_synthetic", "BASE384_SLICE_CONFIG",
     (24, 24, 24, 12)),
])
def test_window_recipes_equal_chip_smoke_configs_and_stage_windows(recipe, config, windows,
                                                                   monkeypatch):
    """Each recipe is the dict chip_smoke.py runs, and its model (built on the
    meta device, the attention stubbed) gives its stages these windows."""
    chip_smoke = _chip_smoke()
    cfg = getattr(chip_smoke, config)
    assert load_config(REPO / "configs", recipe).to_dict() == cfg
    params = cfg["task"]["params"]
    size = params["inputs"][0]["shape"][1]
    assert cfg["data"][next(iter(cfg["data"]))][0]["dataset"]["params"]["image_size"] \
        == [size, size]
    seen = []

    def attention(qkv, logit_scale, bias, mask, ws, nheads):
        seen.append(ws)
        assert bias.shape == (nheads, ws * ws, ws * ws)
        return qkv[..., : qkv.shape[-1] // 3]

    monkeypatch.setattr(swin_module, "fused_swin_attention", attention)
    # the position-bias MLP runs under autocast, which has no meta device
    monkeypatch.setattr(swin_module.WindowAttention, "relative_position_bias",
                        lambda self, ws, device: torch.zeros((self.num_heads, ws ** 4)).view(
                            self.num_heads, ws * ws, ws * ws))
    with torch.device("meta"):
        model = BACKBONES.get(params["backbone_name"])().eval()
        model(torch.zeros((1, 3, size, size)))
    depths = [len(stage.blocks) for stage in model.layers]
    starts = np.cumsum([0] + depths[:-1])
    assert len(seen) == sum(depths)
    assert tuple(seen[s] for s in starts) == windows
    assert all(len(set(seen[s:s + d])) == 1 for s, d in zip(starts, depths))
