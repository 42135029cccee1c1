"""A CPU rehearsal of the order in which the bf16 tensor-core forward of
SwinV2's cosine window attention (``csrc/swin_attention_fwd_mma.cuh``) does
its work, held against the plain forward and the JAX package's.

``emulate_forward`` is a test-only PyTorch transcription of the kernel's
loop: L cut into ceil(L / 64) tiles of one height, a multiple of 16 (48 at
L = 36 and 144, else 64), L padded to a multiple of 16; per query tile the
key tiles are walked twice, first to the row statistics (max and sum merged
tile by tile in flash form with base-2 exponentials), then to a32 =
exp(logit - m) / l with the final statistics, a = bf16(a32) and the output
summed tile by tile as a v. The operands of both products are rounded to the
input dtype where the kernel's bf16 operands are. Also tested: the sizing of
the grid and scratch (``ops.swin_attention.forward_scratch``) at every stage
shape of ``chip_smoke.SWIN_MODELS``.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.models.backbones.swin import _shift_window_region_ids
from torchok_tpu.ops import swin_attention as jax_ops
from torchok_tpu.parallel import mesh as jax_mesh
from torchok_tpu_torch.ops import swin_attention as ops
from torchok_tpu_torch.ops.common import LN_100

REPO = Path(__file__).resolve().parent.parent
TILE = 64
LOG2E = 1.4426950408889634
EPS = 1e-12


@pytest.fixture(autouse=True)
def no_active_mesh(monkeypatch):
    """The JAX package's ops shard over an active multi-device mesh; a fit
    run earlier in this process may have left one active."""
    monkeypatch.setattr(jax_mesh, "_CURRENT_MESH", None)


def _pad_rows(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def _normalize(x, dtype):
    return (x * torch.rsqrt((x * x).sum(-1, keepdim=True) + EPS)).to(dtype).float()


def emulate_forward(qkv, scale, bias, mask, ws, nheads):
    """The output computed in the kernel's order (see the module docstring).
    qkv in its dtype; everything else f32."""
    dtype = qkv.dtype
    _, hp, wp, _ = qkv.shape
    L = ws * ws
    l16 = -(-L // 16) * 16
    ntiles = -(-L // TILE)
    tr = -(-(-(-L // ntiles)) // 16) * 16  # the tile height
    lk = ntiles * tr
    q, k, v = (_pad_rows(t.float(), lk) for t in ops.to_windows(qkv, ws, 3, nheads))
    nw = q.shape[2]
    s = scale.view(1, nheads, 1, 1, 1)
    real = torch.arange(lk) < L
    bm = torch.zeros((nheads, lk, lk))
    bm[:, :L, :L] = bias
    bm = bm.view(1, nheads, 1, lk, lk)
    if mask is not None:
        mp = torch.zeros((nw, lk, lk))
        mp[:, :L, :L] = mask
        bm = bm + mp.view(1, 1, nw, lk, lk)  # added once per launch into a scratch
    qn, kn = _normalize(q, dtype), _normalize(k, dtype)
    out = torch.zeros_like(q)
    for q0 in range(0, L, tr):
        rows = slice(q0, q0 + tr)

        def logits(k0):
            """One key tile's logits; the mma runs only up to the 16-padded
            length, so columns past it are 0 before they become -inf."""
            cols = slice(k0, k0 + tr)
            sc = qn[..., rows, :] @ kn[..., cols, :].transpose(-1, -2)
            sc[..., torch.arange(lk)[cols] >= l16] = 0.0
            return torch.where(real[cols], torch.addcmul(bm[..., rows, cols], sc, s),
                               torch.tensor(-float("inf")))

        # sweep 1: the row statistics, merged tile by tile
        m = torch.full(q[..., rows, 0].shape, -float("inf"))
        l = torch.zeros_like(m)
        for k0 in range(0, L, tr):
            logit = logits(k0)
            mnew = torch.maximum(m, logit.amax(-1))
            m2 = mnew * LOG2E
            l = l * torch.exp2(m * LOG2E - m2) + torch.exp2(logit * LOG2E - m2[..., None]).sum(-1)
            m = mnew
        m2, linv = m * LOG2E, 1.0 / l
        # sweep 2: a = bf16(a32) against v, tile by tile
        for k0 in range(0, L, tr):
            a32 = torch.exp2(logits(k0) * LOG2E - m2[..., None]) * linv[..., None]
            out[..., rows, :] += a32.to(dtype).float() @ v[..., k0:k0 + tr, :]
    return ops.from_windows(out[None, ..., :L, :].to(dtype), ws, hp, wp)


# (Hp, Wp, heads, ws): a 2 x 2 window grid at every SwinV2 window size
SHAPES = {36: (12, 12, 2, 6), 64: (16, 16, 2, 8), 144: (24, 24, 1, 12), 256: (32, 32, 1, 16),
          576: (48, 48, 1, 24)}
# as the card's K1 checks (chip_smoke.TOLERANCE)
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _inputs(shape, masked, b=2, seed=0, dtype=torch.float32):
    hp, wp, heads, ws = shape
    rng = np.random.default_rng(seed)
    L = ws * ws
    qkv = 0.5 * rng.normal(size=(b, hp, wp, 3 * heads * 32))
    scale = np.exp(np.minimum(np.log(10.0) + rng.normal(size=heads), np.log(100.0)))
    bias = 16.0 / (1.0 + np.exp(-rng.normal(size=(heads, L, L))))
    mask = None
    if masked:
        ids = _shift_window_region_ids(hp, wp, ws, ws // 2)
        mask = torch.from_numpy(np.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0)).float()
    return (torch.from_numpy(qkv).to(dtype), torch.from_numpy(scale).float(),
            torch.from_numpy(bias).float(), mask, ws, heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", list(SHAPES))
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_tile_order_matches_plain_forward(dtype, L, masked):
    qkv, scale, bias, mask, ws, heads = _inputs(SHAPES[L], masked, dtype=dtype)
    got = emulate_forward(qkv, scale, bias, mask, ws, heads)
    ref = ops.swin_attention_fwd_plain(qkv, scale, bias, mask, ws, heads)
    assert got.shape == ref.shape and got.dtype == ref.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() <= TOLERANCE[dtype]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_tile_order_matches_pallas_forward(masked):
    """At L = 36 (padded to 48 inside one tile) against the JAX package's
    Pallas kernel in interpret mode, f32."""
    qkv, scale, bias, mask, ws, heads = _inputs(SHAPES[36], masked, seed=5)
    logit_scale = torch.log(scale)
    ref = jax_ops.fused_swin_attention(
        jnp.asarray(qkv.numpy()), jnp.asarray(logit_scale.numpy()), jnp.asarray(bias.numpy()),
        None if mask is None else jnp.asarray(mask.numpy()), ws=ws, nheads=heads,
        interpret=True)
    scale_t = torch.exp(torch.clamp(logit_scale, max=LN_100))
    got = emulate_forward(qkv, scale_t, bias, mask, ws, heads)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOLERANCE[torch.float32]


def _swin_models():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.SWIN_MODELS


@pytest.mark.parametrize("model", list(_swin_models()))
def test_forward_scratch_sizes_grid_and_scratch(model):
    """The bf16 forward's grid and scratch at every stage shape of the
    SwinV2 models that ``chip_smoke.py`` times: a block per (window
    position, query tile, head, two images) with a warp per 16 rows of a
    tile, kn the size of the output, bias + mask only in shifted blocks."""
    batch, stages = _swin_models()[model]
    for hp, wp, c, heads, ws, _ in stages:
        L = ws * ws
        nw = (hp // ws) * (wp // ws)
        for masked in (False, True):
            plan = ops.forward_scratch(batch, hp, wp, heads, ws, masked)
            tiles = -(-L // 64)
            assert plan.tile_rows == (48 if L in (36, 144) else 64)
            assert plan.tile_rows % 16 == 0 and tiles * plan.tile_rows >= L
            assert (tiles - 1) * plan.tile_rows < L  # no tile lies wholly in the padding
            assert plan.images_per_block == 2  # each bias tile serves two images
            assert plan.threads == 32 * plan.tile_rows // 16
            assert plan.grid == (nw * tiles, heads, batch // 2)
            assert plan.kn == batch * hp * wp * c
            assert plan.bias_mask == (nw * heads * L * L if masked else 0)
            # enough blocks for three on each SM of a 132-SM card
            assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 3 * 132


def test_forward_routes_are_named():
    assert ops.FWD_ROUTES == ("templates", "tiled", "mma")


def test_forward_scratch_takes_a_ragged_last_slice():
    """An odd batch leaves the last block one image; a batch of one takes
    one image a block."""
    plan = ops.forward_scratch(5, 16, 16, 2, 8)
    assert plan.images_per_block == 2 and plan.grid == (4, 2, 3)
    assert ops.forward_scratch(1, 16, 16, 2, 8).images_per_block == 1
