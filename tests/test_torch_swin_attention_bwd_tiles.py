"""A CPU rehearsal of the order in which the bf16 tensor-core backward of
SwinV2's cosine window attention (``csrc/swin_attention_bwd_mma.cuh``) does
its work, held against the plain backward and the JAX package's.

``emulate_backward`` is a test-only PyTorch transcription of the two passes:
L cut into ceil(L / 64) tiles of one height, a multiple of 16 (48 at L = 36
and 144, else 64), L padded to a multiple of 16; pass 1 walks the key tiles
twice per query tile (the row statistics merged tile by tile in flash
form with base-2 exponentials, then dq = dls kn); pass 2 walks the query
tiles per key tile (dv, dk, and the block's dbias column summed over the
images of its slice in image order; the kernel splits each query tile
between two warps and adds their dk, dv at the end of the image); the dbias
slabs and dscale slots are added in slot order. The operands of every product are rounded to the
input dtype where the kernel's bf16 operands are. Also tested: the sizing
of the grid and scratch (``ops.swin_attention.backward_scratch``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.models.backbones.swin import _shift_window_region_ids
from torchok_tpu.ops import swin_attention as jax_ops
from torchok_tpu_torch.ops import swin_attention as ops
from torchok_tpu_torch.ops.common import LN_100

TILE = 64
LOG2E = 1.4426950408889634
EPS = 1e-12


def _pad_rows(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def _normalize(x, dtype):
    r = torch.rsqrt((x * x).sum(-1, keepdim=True) + EPS)
    return (x * r).to(dtype).float(), r


def _normalize_backward(x, r, d):
    return r * d - r ** 3 * x * (x * d).sum(-1, keepdim=True)


def emulate_backward(qkv, scale, bias, mask, dout, ws, nheads, images_per_block):
    """(dqkv, dbias, dscale) computed in the kernel's order (see the module
    docstring). qkv/dout in their dtype; everything else f32."""
    dtype = qkv.dtype
    b, hp, wp, _ = qkv.shape
    L = ws * ws
    l16 = -(-L // 16) * 16
    ntiles = -(-L // TILE)
    tr = -(-(-(-L // ntiles)) // 16) * 16  # the tile height
    lk = ntiles * tr
    q, k, v = (_pad_rows(t.float(), lk) for t in ops.to_windows(qkv, ws, 3, nheads))
    do = _pad_rows(ops.to_windows(dout, ws, 1, nheads)[0].float(), lk)
    nw = q.shape[2]
    s = scale.view(1, nheads, 1, 1, 1)
    real = torch.arange(lk) < L
    bm = torch.zeros((nheads, lk, lk))
    bm[:, :L, :L] = bias
    bm = bm.view(1, nheads, 1, lk, lk)
    if mask is not None:
        mp = torch.zeros((nw, lk, lk))
        mp[:, :L, :L] = mask
        bm = bm + mp.view(1, 1, nw, lk, lk)  # bias and mask of a real pair, else 0
    qn, rq = _normalize(q, dtype)
    kn, rk = _normalize(k, dtype)

    def tile_products(rows, cols):
        """cos and da of query rows x key cols; the mma runs only up to the
        16-padded length, so columns past it are 0 (their logits -inf)."""
        sc = qn[..., rows, :] @ kn[..., cols, :].transpose(-1, -2)
        dp = do[..., rows, :] @ v[..., cols, :].transpose(-1, -2)
        beyond = torch.arange(lk)[cols] >= l16
        sc[..., beyond] = 0.0
        dp[..., beyond] = 0.0
        logit = torch.where(real[cols], torch.addcmul(bm[..., rows, cols], sc, s),
                            torch.tensor(-float("inf")))
        return sc, dp, logit

    # pass 1: row statistics over the key tiles (flash form), then dq
    everything = slice(0, lk)
    m = torch.full(q.shape[:-1], -float("inf"))
    l = torch.zeros(q.shape[:-1])
    dsum = torch.zeros(q.shape[:-1])
    for k0 in range(0, L, tr):
        _, dp, logit = tile_products(everything, slice(k0, k0 + tr))
        mnew = torch.maximum(m, logit.amax(-1))
        m2 = mnew * LOG2E
        rescale = torch.exp2(m * LOG2E - m2)
        x = torch.exp2(logit * LOG2E - m2[..., None])
        l = l * rescale + x.sum(-1)
        dsum = dsum * rescale + (x * dp).sum(-1)
        m = mnew
    m2 = m * LOG2E
    linv = 1.0 / l
    dot = dsum * linv
    dqn = torch.zeros_like(q)
    for k0 in range(0, L, tr):
        cols = slice(k0, k0 + tr)
        _, dp, logit = tile_products(everything, cols)
        a32 = torch.exp2(logit * LOG2E - m2[..., None]) * linv[..., None]
        dls = (a32 * (dp - dot[..., None]) * s).to(dtype).float()
        dqn += dls @ kn[..., cols, :]
    dq = _normalize_backward(q, rq, dqn)

    # the statistics as pass 2 reads them: zeros for padded query rows
    m2, linv, dot = (torch.where(real, t, torch.zeros(())) for t in (m2, linv, dot))

    # pass 2: per key tile, over the query tiles; dl kept whole for the slabs
    dkn = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    dl_all = torch.zeros(q.shape[:-1] + (lk,))
    dl_cos = torch.zeros(q.shape[:-1] + (lk,))
    for k0 in range(0, lk, tr):
        cols = slice(k0, k0 + tr)
        for q0 in range(0, lk, tr):
            rows = slice(q0, q0 + tr)
            sc, dp, logit = tile_products(rows, cols)
            a32 = torch.exp2(logit * LOG2E - m2[..., rows, None]) * linv[..., rows, None]
            dl = a32 * (dp - dot[..., rows, None])
            dl_all[..., rows, cols] = dl
            dl_cos[..., rows, cols] = dl * sc
            a = a32.to(dtype).float()
            dls = (dl * s).to(dtype).float()
            dv[..., cols, :] += a.transpose(-1, -2) @ do[..., rows, :]
            dkn[..., cols, :] += dls.transpose(-1, -2) @ qn[..., rows, :]
    dk = _normalize_backward(k, rk, dkn)

    # each (window, slice) slab sums its images in order; slots in order
    dbias = torch.zeros((nheads, L, L))
    dscale = torch.zeros((nheads,))
    for w in range(nw):
        for b0 in range(0, b, images_per_block):
            slab = torch.zeros((nheads, lk, lk))
            for img in range(b0, min(b, b0 + images_per_block)):
                slab += dl_all[img, :, w]
            dbias += slab[:, :L, :L]
            dscale += dl_cos[b0:b0 + images_per_block, :, w].sum(dim=(0, 2, 3))
    dwin = torch.stack([dq, dk, dv])[..., :L, :].to(dtype)
    return ops.from_windows(dwin, ws, hp, wp), dbias, dscale


# (Hp, Wp, heads, ws): a 2 x 2 window grid at every SwinV2 window size
SHAPES = {36: (12, 12, 2, 6), 64: (16, 16, 2, 8), 144: (24, 24, 1, 12), 256: (32, 32, 1, 16),
          576: (48, 48, 1, 24)}
# relative to the reference's largest entry, as the card's K2 checks
TOLERANCE = {torch.float32: (1e-4, 1e-3, 1e-3), torch.bfloat16: (2e-2, 1e-3, 1e-3)}


def _inputs(shape, masked, b=2, seed=0, dtype=torch.float32):
    hp, wp, heads, ws = shape
    rng = np.random.default_rng(seed)
    L = ws * ws
    qkv = 0.5 * rng.normal(size=(b, hp, wp, 3 * heads * 32))
    scale = np.exp(np.minimum(np.log(10.0) + rng.normal(size=heads), np.log(100.0)))
    bias = 16.0 / (1.0 + np.exp(-rng.normal(size=(heads, L, L))))
    dout = rng.normal(size=(b, hp, wp, heads * 32))
    mask = None
    if masked:
        ids = _shift_window_region_ids(hp, wp, ws, ws // 2)
        mask = torch.from_numpy(np.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0)).float()
    return (torch.from_numpy(qkv).to(dtype), torch.from_numpy(scale).float(),
            torch.from_numpy(bias).float(), mask, torch.from_numpy(dout).to(dtype), ws, heads)


def _close(got, ref, tolerance):
    for g, r, tol in zip(got, ref, tolerance):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", list(SHAPES))
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_tile_order_matches_plain_backward(dtype, L, masked):
    qkv, scale, bias, mask, dout, ws, heads = _inputs(SHAPES[L], masked, dtype=dtype)
    got = emulate_backward(qkv, scale, bias, mask, dout, ws, heads, images_per_block=1)
    ref = ops.swin_attention_bwd_plain(qkv, scale, bias, mask, dout, ws, heads)
    _close(got, ref, TOLERANCE[dtype])


def test_tile_order_sums_several_images_per_slab():
    """Five images, three to a block (the last slice ragged)."""
    qkv, scale, bias, mask, dout, ws, heads = _inputs(SHAPES[144], True, b=5, seed=3,
                                                      dtype=torch.bfloat16)
    got = emulate_backward(qkv, scale, bias, mask, dout, ws, heads, images_per_block=3)
    ref = ops.swin_attention_bwd_plain(qkv, scale, bias, mask, dout, ws, heads)
    _close(got, ref, TOLERANCE[torch.bfloat16])


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_tile_order_matches_pallas_backward(masked):
    """At L = 36 (padded to 48 inside one tile) against jax.vjp through the
    JAX package's Pallas kernels in interpret mode, f32: the same gradients
    up to the summation order."""
    qkv, scale, bias, mask, dout, ws, heads = _inputs(SHAPES[36], masked, seed=5)
    logit_scale = torch.log(scale)
    m = None if mask is None else jnp.asarray(mask.numpy())

    def f(q, ls, bi):
        return jax_ops.fused_swin_attention(q, ls, bi, m, ws=ws, nheads=heads, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(qkv.numpy()), jnp.asarray(logit_scale.numpy()),
                     jnp.asarray(bias.numpy()))
    dq_ref, dls_ref, db_ref = (np.asarray(g) for g in vjp(jnp.asarray(dout.numpy())))
    scale_t = torch.exp(torch.clamp(logit_scale, max=LN_100))
    dqkv, dbias, dscale = emulate_backward(qkv, scale_t, bias, mask, dout, ws, heads, 1)
    # d logit_scale = dscale * scale (the clamp is inactive at these draws)
    got = (dqkv.numpy(), (dscale * scale_t).numpy(), dbias.numpy())
    for g, r in zip(got, (dq_ref, dls_ref, db_ref)):
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()


def test_backward_scratch_sizes_grid_and_scratch(monkeypatch):
    """The grid and scratch of both routes at swinv2_base_window12to24's
    stages at batch 32 (384x384) and swinv2_tiny_window16's at batch 128,
    on a 132-SM card."""
    monkeypatch.setattr(ops, "_sm_count", lambda device: 132)
    cpu = torch.device("cpu")
    # (batch, nW, heads, ws) of each stage
    base384 = [(32, 16, 4, 24), (32, 4, 8, 24), (32, 1, 16, 24), (32, 1, 32, 12)]
    window16 = [(128, 16, 3, 16), (128, 4, 6, 16), (128, 1, 12, 16), (128, 1, 24, 8)]
    f32 = ops.backward_scratch(*base384[0], torch.float32, cpu)
    assert f32.slots == 80 and f32.row_stats == 0  # the FMA templates' 425 MB of slabs
    assert f32.nbytes(4, 576) > 424e6
    for b, nw, heads, ws in base384 + window16:
        L = ws * ws
        tiles = -(-L // 64)
        for masked in (False, True):
            plan = ops.backward_scratch(b, nw, heads, ws, torch.bfloat16, cpu, masked)
            slices = -(-b // plan.images_per_block)
            assert plan.slots == nw * slices and plan.scale_slots == plan.slots * tiles
            assert plan.row_stats == 3 * b * heads * nw * L
            # bias + mask of a shifted block, then 1 / |k|
            assert plan.work == (nw * heads * L * L if masked else 0) + b * nw * L * heads
            assert 1 <= plan.images_per_block <= b
            # the dk/dv pass aims at four waves of one block per SM (to whole
            # images per block), its slabs under 64 MiB (and then over half of
            # it) unless one slice alone is larger
            slab = nw * heads * L * L * 4
            positions = nw * tiles * heads
            want = min(4 * 132, positions * b)
            assert positions * slices >= 0.9 * want or 2 * slices * slab > 2 ** 26
            assert slices == 1 or slices * slab <= 2 ** 26
            # far under the FMA templates' 425 MB
            assert plan.nbytes(heads, L) <= (200e6 if masked else 115e6)
    plan = ops.backward_scratch(32, 16, 4, 24, torch.bfloat16, cpu)
    assert plan.images_per_block == 32 and plan.slots == 16  # 576 blocks of one image slice


def test_backward_routes_are_named():
    assert ops.BWD_ROUTES == ("templates", "tiled", "mma")
