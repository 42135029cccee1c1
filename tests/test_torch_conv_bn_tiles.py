"""A CPU rehearsal of how K7's bf16 route (``csrc/matmul_bn_wgmma.cuh``: the
1x1-conv GEMM with the BatchNorm prologue and statistics on wgmma) splits
its work and orders its sums, held against the plain version and the JAX
package's Pallas kernel.

``block_tiles`` is the kernel's schedule: block ``b`` takes column tile ``b
% tiles_n`` and row tiles ``b // tiles_n``, ``+ groups``, ... of
``ops.conv_bn.forward_plan``. ``emulate`` is a test-only PyTorch
transcription of what a block does with a 128-row tile: x zero past M and K
(TMA's fill), scale and bias zero past K, the affine as one FMA in f32, the
ReLU, one rounding to the input type, the product in f32, one rounding of y;
rows past M are stored nowhere and left out of the statistics. The column
sums run as the kernel runs them: a thread's two rows (g and g + 8 of its
warp's 16), the reduce-scatter over the eight lanes of a column (lanes 16,
8, 4 apart), the eight warps in order, the block's tiles in order, then the
blocks' partial rows in order. Tolerances are those of
``tests/test_torch_conv_bn.py``: y 1e-5, statistics rtol 1e-4 / atol 1e-2
(f32); one bf16 ulp of the largest |y| and atol 5e-2 (bf16).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.ops import conv_bn as jcb
from torchok_tpu_torch.ops import conv_bn as cb

REPO = Path(__file__).resolve().parent.parent
SMS = 132  # an H100's SMs
TILE_K = 64  # a slab of the kernel


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
# (M, K, N) of chip_smoke's K7 phase: every ResNet-50 1x1 stage at batch 256
# both ways, and the ragged stage-4 case
STAGE_SHAPES = [(CS.RESNET_BATCH * px, k, n) for _, px, wide, narrow in CS.BN_STAGES
                for k, n in ((wide, narrow), (narrow, wide))]
STAGE_SHAPES.append((CS.RESNET_BATCH * 14 * 14 - 59, 1024, 256))
# (M, K, N) of the card cases in tests/test_torch_cuda_kernels.py
CARD_SHAPES = [(256, 128, 128), (200, 64, 256), (130, 128, 128), (3000, 256, 64), (1, 8, 8),
               (777, 72, 40), (300, 64, 128), (1000, 136, 328), (64, 64, 64),
               (256 * 56 * 56, 256, 64), (256 * 56 * 56, 64, 256)]


def _inputs(m, k, n, seed=0, dtype=torch.float32, bias_shift=0.0):
    gen = np.random.default_rng(seed)
    x = gen.normal(0, 1, (m, k)).astype(np.float32)
    w = gen.normal(0, 0.05, (k, n)).astype(np.float32)
    scale = gen.uniform(0.5, 1.5, (k,)).astype(np.float32)
    bias = (gen.normal(0, 0.2, (k,)) + bias_shift).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
            torch.from_numpy(scale), torch.from_numpy(bias))


def block_tiles(plan, m):
    """{block: (column tile, [row tiles in the order it walks them])}."""
    m_tiles = -(-m // cb.TILE_M)
    return {b: (b % plan.tiles_n, list(range(b // plan.tiles_n, m_tiles, plan.groups)))
            for b in range(plan.tiles_n * plan.groups)}


def _lane_tree(t):
    """The reduce-scatter over the eight lanes of a column: t (..., 8 lanes,
    cols) -> (..., cols), lanes 4 apart first (shuffle 16), then 2, then 1."""
    p = t[..., 0:4, :] + t[..., 4:8, :]
    q = p[..., 0:2, :] + p[..., 2:4, :]
    return q[..., 0, :] + q[..., 1, :]


def emulate(x, w, scale, bias, relu_in, with_affine, plan, leak_padded_rows=False):
    """(y, s1, s2) as the kernel computes them (see the module docstring).
    ``leak_padded_rows`` gives the variant the checks must refuse: rows past
    M (relu(bias) @ w after the affine) counted in the statistics."""
    m, k = x.shape
    n = w.shape[1]
    dtype = x.dtype
    bm, bn = cb.TILE_M, plan.tile_n
    kp = -(-k // TILE_K) * TILE_K
    sc = torch.zeros(kp, dtype=torch.float64)
    bi = torch.zeros(kp, dtype=torch.float64)
    if with_affine:
        sc[:k], bi[:k] = scale.double(), bias.double()
    else:
        sc[:k] = 1.0
    y = torch.empty((m, n), dtype=dtype)
    partial = torch.zeros((2, plan.groups, n), dtype=torch.float32)
    for b, (nt, row_tiles) in block_tiles(plan, m).items():
        n0 = nt * bn
        cols = min(bn, n - n0)
        wt = torch.zeros((kp, bn), dtype=torch.float32)
        wt[:k, :cols] = w[:, n0:n0 + cols].float()
        sums = torch.zeros((2, bn), dtype=torch.float32)
        for mt in row_tiles:
            m0 = mt * bm
            rows = min(bm, m - m0)
            xt = torch.zeros((bm, kp), dtype=torch.float64)
            xt[:rows, :k] = x[m0:m0 + rows].double()
            a = (xt * sc + bi).float()  # one FMA: exact in f64, one rounding
            if relu_in:
                a = torch.relu(a)
            yt = torch.matmul(a.to(dtype).float(), wt).to(dtype).float()
            y[m0:m0 + rows, n0:n0 + cols] = yt[:rows, :cols].to(dtype)
            if not leak_padded_rows:
                yt[rows:] = 0.0
            v = yt.reshape(bm // 16, 2, 8, bn)  # (warp, top / bottom, lane g, column)
            top, bot = v[:, 0], v[:, 1]
            t1 = top + bot
            t2 = (top.double() * top.double() + bot.double() * bot.double()).float()
            per_warp = torch.stack([_lane_tree(t1), _lane_tree(t2)])  # (2, warps, bn)
            tile = per_warp[:, 0].clone()
            for warp in range(1, bm // 16):
                tile += per_warp[:, warp]
            sums += tile
        partial[:, b // plan.tiles_n, n0:n0 + cols] = sums[:, :cols]
    s = partial[:, 0].clone()
    for group in range(1, plan.groups):
        s += partial[:, group]
    return y, s[0], s[1]


def _plan(m, k, n, sms=SMS):
    return cb.forward_plan(m, k, n, sms, cb.forward_route(torch.bfloat16, m, k, n))


def test_route_per_dtype():
    assert cb.forward_route(torch.bfloat16, 777, 72, 40) == "wgmma"
    assert cb.forward_route(torch.float32, 777, 72, 40) == "fma"
    assert cb.ROUTES == ("fma", "wgmma")
    with pytest.raises(TypeError):
        cb.forward_route(torch.float16, 8, 8, 8)
    with pytest.raises(ValueError, match="multiples of 8"):
        cb.forward_route(torch.bfloat16, 8, 60, 8)
    with pytest.raises(ValueError, match="M >= 1"):
        cb.forward_route(torch.bfloat16, 0, 8, 8)


@pytest.mark.parametrize("m,k,n", STAGE_SHAPES + CARD_SHAPES)
def test_plan_covers_every_tile_once(m, k, n):
    """The whole of N up to 256 in one tile (the next width of 64, 128, 256),
    tiles of 128 or 256 above; no more blocks than SMs; each (row tile,
    column tile) taken by exactly one block. The FMA route keeps its grid of
    at most two blocks an SM."""
    plan = _plan(m, k, n)
    if n <= 256:
        assert plan.tile_n == min(t for t in cb.WGMMA_TILE_N if t >= n)
    else:
        assert plan.tile_n in (128, 256)
    assert plan.tiles_n == -(-n // plan.tile_n)
    assert 1 <= plan.tiles_n * plan.groups <= SMS
    m_tiles = -(-m // cb.TILE_M)
    taken = [(mt, nt) for nt, rows in block_tiles(plan, m).values() for mt in rows]
    assert sorted(taken) == [(mt, nt) for mt in range(m_tiles) for nt in range(plan.tiles_n)]
    fma = cb.forward_plan(m, k, n, SMS, "fma")
    assert fma.tile_n == cb.FMA_TILE_N and fma.tiles_n == -(-n // cb.FMA_TILE_N)
    assert 1 <= fma.groups <= m_tiles and fma.tiles_n * fma.groups <= max(2 * SMS, fma.tiles_n)


def test_plan_at_resnet50s_stages():
    """stage: (tile, column tiles, groups) for wide -> narrow and back."""
    want = {2: ((64, 1, 132), (256, 1, 132)), 3: ((128, 1, 132), (256, 2, 66)),
            4: ((256, 1, 132), (256, 4, 33)), 5: ((128, 4, 33), (128, 16, 8))}
    for stage, px, wide, narrow in CS.BN_STAGES:
        m = CS.RESNET_BATCH * px
        got = (tuple(_plan(m, wide, narrow)), tuple(_plan(m, narrow, wide)))
        assert got == want[stage], stage


@pytest.mark.parametrize("m,k,n,sms", [(777, 72, 40, SMS), (777, 72, 40, 3), (130, 128, 128, 2),
                                       (300, 64, 328, 4), (1, 8, 8, SMS)])
@pytest.mark.parametrize("relu_in,with_affine", [(False, False), (True, False), (False, True),
                                                 (True, True)])
def test_kernel_order_matches_plain_version_in_bf16(m, k, n, sms, relu_in, with_affine):
    """Ragged M, K = 72 (a slab past K), N = 40 and 328 (partial column
    tiles), several row tiles a block (sms 2 to 4)."""
    args = _inputs(m, k, n, seed=1, dtype=torch.bfloat16)
    got = emulate(*args, relu_in, with_affine, _plan(m, k, n, sms))
    ref = cb.matmul_bn_plain(*args, relu_in, with_affine)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (m, n)
    top = ref[0].float().abs().max().item()
    assert (got[0].float() - ref[0].float()).abs().max().item() <= 2.0 ** -7 * top
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=5e-2)


@pytest.mark.parametrize("m,k,n,sms", [(777, 72, 40, 3), (200, 64, 256, SMS),
                                       (300, 64, 328, 4)])
@pytest.mark.parametrize("relu_in,with_affine", [(False, False), (True, True)])
def test_kernel_order_matches_the_pallas_kernel(m, k, n, sms, relu_in, with_affine):
    """f32 inputs through the bf16 route's order (every rounding the
    identity) against ``torchok_tpu.ops.conv_bn.matmul_bn``, which interprets
    its Pallas kernel off the TPU."""
    args = _inputs(m, k, n, seed=2)
    ref = jcb.matmul_bn(*(jnp.asarray(t.numpy()) for t in args), relu_in, with_affine)
    got = emulate(*args, relu_in, with_affine, _plan(m, k, n, sms))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4, atol=1e-2)


def test_kernel_order_matches_the_pallas_kernel_in_bf16():
    args = _inputs(777, 72, 40, seed=3, dtype=torch.bfloat16)
    jx, jw = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in args[:2])
    ref = jcb.matmul_bn(jx, jw, jnp.asarray(args[2].numpy()), jnp.asarray(args[3].numpy()),
                        True, True)
    got = emulate(*args, True, True, _plan(777, 72, 40, 3))
    y_ref = np.asarray(ref[0], np.float32)
    assert np.abs(got[0].float().numpy() - y_ref).max() <= 2.0 ** -7 * np.abs(y_ref).max()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=5e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4, atol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_padded_rows_stay_out_of_the_statistics(dtype):
    """With relu(bias) > 0 a padded row's y is relu(bias) @ w, not 0: the
    statistics of 130 rows (two tiles, the second with 2 real rows) hold
    only with those rows left out, and the variant that counts them fails."""
    m, k, n = 130, 72, 40
    args = _inputs(m, k, n, seed=4, dtype=dtype, bias_shift=1.0)
    assert bool((args[3] > 0).all())
    ref = cb.matmul_bn_plain(*args, True, True)
    plan = _plan(m, k, n, 1)
    got = emulate(*args, True, True, plan)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-2)
    leaked = emulate(*args, True, True, plan, leak_padded_rows=True)
    assert torch.equal(leaked[0], got[0])  # y is stored for real rows only
    assert (leaked[1] - ref[1]).abs().max().item() > 1.0
