"""A CPU rehearsal of the order in which the bf16 tensor-core forward does
its work in its plain-dot modes (``csrc/swin_attention_fwd_mma.cuh``: K3a,
the local window attention forward of GCViT and DaViT, with and without a
bias; K4, GCViT's global-query forward), held against the plain forwards and
the JAX package's Pallas kernels.

``emulate_forward`` is a test-only PyTorch transcription of the kernel's
loop: L cut into ceil(L / 64) tiles of one height, a multiple of 16 (64 at
L = 49 and 196: the last of 196's four tiles holds 4 real rows), L padded
to a multiple of 16. With one key tile (L = 49) each window takes one sweep:
the row max, e = exp(logit - m) in base 2, l = sum e and a32 = e (1 / l)
from one QK^T; in global mode a block takes the image's q tile once and
walks a slice of the image's windows in order with it. With several key
tiles (L = 196) each query tile walks the key tiles twice: the row
statistics merged tile by tile in flash form, then a32 with the final
statistics against v. The operands of both products are rounded to the
input dtype where the kernel's bf16 operands are (a = bf16(a32)). Also
tested: the route names and the sizing of the grid, the window slices and
the scratch (``ops.window_attention_dot.forward_scratch``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.ops import swin_attention as jax_ops
from torchok_tpu.parallel import mesh as jax_mesh
from torchok_tpu_torch.ops import swin_attention as swin_ops
from torchok_tpu_torch.ops import window_attention_dot as ops

TILE = 64
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def no_active_mesh(monkeypatch):
    """The JAX package's ops shard over an active multi-device mesh; a fit
    run earlier in this process may have left one active."""
    monkeypatch.setattr(jax_mesh, "_CURRENT_MESH", None)


def _pad_rows(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def emulate_forward(proj, qg, scale, bias, ws, nheads, windows_per_block=1):
    """The output computed in the kernel's order (see the module docstring).
    ``qg`` None is the local mode (proj = qkv), else the global one (proj =
    kv); ``windows_per_block`` is the global walk's slice. proj and qg in
    their dtype; everything else f32."""
    dtype = proj.dtype
    b, hp, wp, _ = proj.shape
    L = ws * ws
    l16 = -(-L // 16) * 16
    ntiles = -(-L // TILE)
    tr = 64 if -(-(-(-L // ntiles)) // 16) * 16 > 48 else 48  # the tile height
    lk = ntiles * tr
    if qg is None:
        q, k, v = (_pad_rows(t.float(), lk) for t in ops.to_windows(proj, ws, 3, nheads))
    else:
        k, v = (_pad_rows(t.float(), lk) for t in ops.to_windows(proj, ws, 2, nheads))
        # (B, H, lk, D): the image's shared queries
        q = _pad_rows(qg.reshape(b, L, nheads, -1).permute(0, 2, 1, 3).float(), lk)
    nw = k.shape[2]
    s = scale.view(1, nheads, 1, 1)
    real = torch.arange(lk) < L
    bm = torch.zeros((1, nheads, lk, lk))
    if bias is not None:
        bm[0, :, :L, :L] = bias
    out = torch.zeros_like(v)

    def logits(qt, w, rows, cols):
        """The logits of query rows ``rows`` (operand qt) against window w's
        key tile ``cols``; the mma runs only up to the 16-padded length, so
        columns past it are 0 before they become -inf."""
        sc = qt @ k[:, :, w, cols].transpose(-1, -2)
        sc[..., torch.arange(lk)[cols] >= l16] = 0.0
        return torch.where(real[cols], torch.addcmul(bm[..., rows, cols], sc, s),
                           torch.tensor(-float("inf")))

    if ntiles == 1:
        everything = slice(0, lk)
        # global: a block per slice of windows, its q tile taken once
        slices = range(0, nw, windows_per_block) if qg is not None else range(nw)
        for w0 in slices:
            qt = q[:, :, everything] if qg is not None else None
            for w in range(w0, min(nw, w0 + (windows_per_block if qg is not None else 1))):
                logit = logits(q[:, :, w] if qg is None else qt, w, everything, everything)
                m2 = logit.amax(-1, keepdim=True) * LOG2E
                e = torch.exp2(logit * LOG2E - m2)
                a32 = e * (1.0 / e.sum(-1, keepdim=True))
                out[:, :, w] = a32.to(dtype).float() @ v[:, :, w]
    else:
        for w in range(nw):
            for q0 in range(0, L, tr):
                rows = slice(q0, q0 + tr)
                qt = (q[:, :, w] if qg is None else q)[:, :, rows]
                # sweep 1: the row statistics, merged tile by tile
                m = torch.full(qt.shape[:-1], -float("inf"))
                l = torch.zeros_like(m)
                for k0 in range(0, L, tr):
                    logit = logits(qt, w, rows, slice(k0, k0 + tr))
                    mnew = torch.maximum(m, logit.amax(-1))
                    m2 = mnew * LOG2E
                    l = l * torch.exp2(m * LOG2E - m2) + torch.exp2(
                        logit * LOG2E - m2[..., None]).sum(-1)
                    m = mnew
                m2, linv = m * LOG2E, 1.0 / l
                # sweep 2: a = bf16(a32) against v, tile by tile
                for k0 in range(0, L, tr):
                    cols = slice(k0, k0 + tr)
                    a32 = torch.exp2(logits(qt, w, rows, cols) * LOG2E - m2[..., None]) \
                        * linv[..., None]
                    out[:, :, w, rows] += a32.to(dtype).float() @ v[:, :, w, cols]
    return ops.from_windows(out[None, ..., :L, :].to(dtype), ws, hp, wp)


# (Hp, Wp, heads, ws): 2 x 3 windows of L = 49 (GCViT's stages 1, 2, 4 and
# DaViT's), 2 x 1 windows of L = 196 (GCViT's stage 3 has one)
SHAPES = {49: (14, 21, 2, 7), 196: (28, 14, 1, 14)}
MODES = ("bias", "nobias", "global")
# as the card's K3a/K4 checks (chip_smoke.TOLERANCE): absolute, on outputs
# of magnitude up to about 3 (N(0, 1) v)
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _inputs(shape, mode, b=2, seed=0, dtype=torch.float32):
    """numpy draws as chip_smoke.dot_inputs makes them on the card: N(0, 1)
    projections, queries and bias, scale head_dim ** -0.5."""
    hp, wp, heads, ws = shape
    rng = np.random.default_rng(seed)
    L, c = ws * ws, heads * 32
    parts = 2 if mode == "global" else 3
    proj = torch.from_numpy(rng.normal(size=(b, hp, wp, parts * c))).to(dtype)
    qg = torch.from_numpy(rng.normal(size=(b, L, c))).to(dtype) if parts == 2 else None
    scale = torch.full((heads,), 32 ** -0.5)
    bias = (torch.from_numpy(rng.normal(size=(heads, L, L))).float()
            if mode != "nobias" else None)
    return proj, qg, scale, bias, ws, heads


def _plain(proj, qg, scale, bias, ws, heads):
    if qg is None:
        return ops.window_attention_fwd_plain(proj, scale, bias, ws, heads)
    return ops.window_attention_global_fwd_plain(proj, qg, scale, bias, ws, heads)


def _close(got, ref, dtype):
    assert got.shape == ref.shape and got.dtype == ref.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() <= TOLERANCE[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_tile_order_matches_plain_forward(dtype, L, mode):
    args = _inputs(SHAPES[L], mode, dtype=dtype)
    _close(emulate_forward(*args, windows_per_block=4), _plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_global_walk_takes_an_odd_batch_and_a_ragged_last_slice(dtype):
    """Three images, six windows walked four and two to a block."""
    args = _inputs(SHAPES[49], "global", b=3, seed=3, dtype=dtype)
    _close(emulate_forward(*args, windows_per_block=4), _plain(*args), dtype)


@pytest.mark.parametrize("L", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_tile_order_matches_pallas_forward(L, mode):
    """Against the JAX package's Pallas kernels (fused_window_attention
    (_global), reached by window_attention_spatial) in interpret mode, f32:
    the same outputs up to the summation order."""
    proj, qg, scale, bias, ws, heads = _inputs(SHAPES[L], mode, b=1, seed=5)
    ref = jax_ops.window_attention_spatial(
        jnp.asarray(proj.numpy()), jnp.asarray(scale.numpy()),
        None if bias is None else jnp.asarray(bias.numpy()), ws=ws, nheads=heads,
        q_global=None if qg is None else jnp.asarray(qg.numpy()), interpret=True)
    got = emulate_forward(proj, qg, scale, bias, ws, heads, windows_per_block=2)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOLERANCE[torch.float32]


# gcvit_tiny's four stages at 224x224 and davit_t's: (nW, heads, ws)
GCVIT = [(64, 2, 7), (16, 4, 7), (1, 8, 14), (1, 16, 7)]
DAVIT = [(64, 3, 7), (16, 6, 7), (4, 12, 7), (1, 24, 7)]


def test_forward_scratch_sizes_grid_slices_and_scratch(monkeypatch):
    """The bf16 forward's grid at gcvit_tiny's and davit_t's stages at batch
    128 on a 132-SM card: local (and global at L = 196) a block per (window
    position, query tile, head, two images); the global walk at L = 49 as
    many window slices as give about four blocks to every SM (stage 1: two
    slices of 32 windows); the bias in rows of 52 floats at L = 49 but in
    the walk, which loads it once per slice."""
    monkeypatch.setattr(swin_ops, "_sm_count", lambda device: 132)
    cpu = torch.device("cpu")
    b = 128
    for nw, heads, ws in GCVIT + DAVIT:
        L = ws * ws
        tiles = -(-L // 64)
        hp = wp = int(nw ** 0.5) * ws
        modes = ((True, False), (False, False)) + (((True, True),) if (nw, heads, ws) in GCVIT
                                                   else ())
        for has_bias, global_queries in modes:
            plan = ops.forward_scratch(b, hp, wp, heads, ws, cpu, has_bias, global_queries)
            assert plan.tile_rows == 64 and plan.threads == 128
            walk = global_queries and tiles == 1
            assert plan.work == (heads * L * 52 if has_bias and ws == 7 and not walk else 0)
            if walk:
                assert plan.images_per_block == 1
                slices = -(-nw // plan.windows_per_block)
                assert plan.grid == (slices, heads, b)
                # the card's 4 x 132 slots about filled, in one wave where
                # windows x heads x images allow
                assert 0.9 * min(4 * 132, nw * heads * b) <= slices * heads * b
                assert slices == 1 or slices * heads * b <= 4 * 132
            else:
                assert plan.images_per_block == 2 and plan.windows_per_block == 1
                assert plan.grid == (nw * tiles, heads, b // 2)
    stage1 = ops.forward_scratch(b, 56, 56, 2, 7, cpu, True, True)
    assert stage1.windows_per_block == 32 and stage1.grid == (2, 2, 128)
    # three slices of 22, 22 and 20 windows
    ragged = ops.forward_scratch(88, 56, 56, 2, 7, cpu, True, True)
    assert ragged.windows_per_block == 22 and ragged.grid == (3, 2, 88)
    # an odd batch: the last local block takes one image
    assert ops.forward_scratch(5, 14, 14, 2, 7, cpu).grid == (4, 2, 3)


def test_forward_routes_are_named():
    assert ops.FWD_ROUTES == ("templates", "mma")
