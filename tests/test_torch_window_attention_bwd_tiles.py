"""A CPU rehearsal of the order in which the bf16 tensor-core backward does
its work in its plain-dot modes (``csrc/swin_attention_bwd_mma.cuh``: K3b,
the local window attention backward of GCViT and DaViT, with and without a
bias; K5, GCViT's global-query backward), held against the plain backwards
and the JAX package's.

``emulate_backward`` is a test-only PyTorch transcription of the two passes:
L cut into ceil(L / 64) tiles of one height, a multiple of 16 (64 at L = 49
and 196: the last of 196's four tiles holds 4 real rows), L padded to a
multiple of 16; pass 1 walks the key tiles twice per query tile and window
(the row statistics merged tile by tile in flash form with base-2
exponentials, then dq += dls k), in global mode over the image's windows in
order with one dq accumulator, which is dqg; pass 2 walks the query tiles
per key tile (dv, dk, and the block's dbias column summed over the images of
its slice in image order); the dbias slabs are added in slot order. The
operands of every product are rounded to the input dtype where the kernel's
bf16 operands are. Also tested: the route names and the sizing of the grid
and scratch (``ops.window_attention_dot.backward_scratch``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.ops import swin_attention as jax_ops
from torchok_tpu_torch.ops import swin_attention as swin_ops
from torchok_tpu_torch.ops import window_attention_dot as ops

TILE = 64
LOG2E = 1.4426950408889634


def _pad_rows(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def emulate_backward(proj, qg, scale, bias, dout, ws, nheads, images_per_block):
    """(dproj, dqg or None, dbias or None) computed in the kernel's order (see
    the module docstring). ``qg`` None is the local mode (proj = qkv), else
    the global one (proj = kv). proj, qg, dout in their dtype; all else f32."""
    dtype = proj.dtype
    b, hp, wp, _ = proj.shape
    L = ws * ws
    l16 = -(-L // 16) * 16
    ntiles = -(-L // TILE)
    tr = -(-(-(-L // ntiles)) // 16) * 16  # the tile height
    lk = ntiles * tr
    if qg is None:
        q, k, v = (_pad_rows(t.float(), lk) for t in ops.to_windows(proj, ws, 3, nheads))
    else:
        k, v = (_pad_rows(t.float(), lk) for t in ops.to_windows(proj, ws, 2, nheads))
        q = _pad_rows(qg.reshape(b, L, nheads, -1).permute(0, 2, 1, 3).float(), lk)[:, :, None]
        q = q.expand_as(k)
    do = _pad_rows(ops.to_windows(dout, ws, 1, nheads)[0].float(), lk)
    nw = k.shape[2]
    s = scale.view(1, nheads, 1, 1)
    real = torch.arange(lk) < L
    bm = torch.zeros((1, nheads, lk, lk))
    if bias is not None:
        bm[0, :, :L, :L] = bias

    def tile_products(w, rows, cols):
        """logits and da of window w's query rows x key cols; the mma runs
        only up to the 16-padded length, so columns past it are 0 (their
        logits -inf)."""
        sc = q[:, :, w, rows] @ k[:, :, w, cols].transpose(-1, -2)
        dp = do[:, :, w, rows] @ v[:, :, w, cols].transpose(-1, -2)
        beyond = torch.arange(lk)[cols] >= l16
        sc[..., beyond] = 0.0
        dp[..., beyond] = 0.0
        logit = torch.where(real[cols], torch.addcmul(bm[..., rows, cols], sc, s),
                            torch.tensor(-float("inf")))
        return dp, logit

    # pass 1, per window in order: row statistics over the key tiles (flash
    # form), then dq; in global mode one accumulator across the windows
    everything = slice(0, lk)
    m2 = torch.zeros(q.shape[:-1])
    linv = torch.zeros(q.shape[:-1])
    dot = torch.zeros(q.shape[:-1])
    dq = torch.zeros_like(q)
    dq_sum = torch.zeros((b, nheads, lk, q.shape[-1]))
    for w in range(nw):
        m = torch.full((b, nheads, lk), -float("inf"))
        l = torch.zeros((b, nheads, lk))
        dsum = torch.zeros((b, nheads, lk))
        for k0 in range(0, L, tr):
            dp, logit = tile_products(w, everything, slice(k0, k0 + tr))
            mnew = torch.maximum(m, logit.amax(-1))
            tm2 = mnew * LOG2E
            rescale = torch.exp2(m * LOG2E - tm2)
            x = torch.exp2(logit * LOG2E - tm2[..., None])
            l = l * rescale + x.sum(-1)
            dsum = dsum * rescale + (x * dp).sum(-1)
            m = mnew
        m2[:, :, w] = m * LOG2E
        linv[:, :, w] = 1.0 / l
        dot[:, :, w] = dsum / l
        acc = dq_sum if qg is not None else torch.zeros_like(dq_sum)
        for k0 in range(0, L, tr):
            cols = slice(k0, k0 + tr)
            dp, logit = tile_products(w, everything, cols)
            a32 = torch.exp2(logit * LOG2E - m2[:, :, w, :, None]) * linv[:, :, w, :, None]
            dls = (a32 * (dp - dot[:, :, w, :, None]) * s).to(dtype).float()
            acc += dls @ k[:, :, w, cols]
        dq[:, :, w] = acc

    # the statistics as pass 2 reads them: zeros for padded query rows
    m2, linv, dot = (torch.where(real, t, torch.zeros(())) for t in (m2, linv, dot))

    # pass 2: per key tile, over the query tiles; dl kept whole for the slabs
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    dl_all = torch.zeros(k.shape[:-1] + (lk,))
    for w in range(nw):
        for k0 in range(0, lk, tr):
            cols = slice(k0, k0 + tr)
            for q0 in range(0, lk, tr):
                rows = slice(q0, q0 + tr)
                dp, logit = tile_products(w, rows, cols)
                a32 = (torch.exp2(logit * LOG2E - m2[:, :, w, rows, None])
                       * linv[:, :, w, rows, None])
                dl = a32 * (dp - dot[:, :, w, rows, None])
                dl_all[:, :, w, rows, cols] = dl
                a = a32.to(dtype).float()
                dls = (dl * s).to(dtype).float()
                dv[:, :, w, cols] += a.transpose(-1, -2) @ do[:, :, w, rows]
                dk[:, :, w, cols] += dls.transpose(-1, -2) @ q[:, :, w, rows]

    # each (window, slice) slab sums its images in order; slots in order
    dbias = None
    if bias is not None:
        dbias = torch.zeros((nheads, L, L))
        for w in range(nw):
            for b0 in range(0, b, images_per_block):
                slab = torch.zeros((nheads, lk, lk))
                for img in range(b0, min(b, b0 + images_per_block)):
                    slab += dl_all[img, :, w]
                dbias += slab[:, :L, :L]
    if qg is None:
        dwin = torch.stack([dq, dk, dv])[..., :L, :].to(dtype)
        return ops.from_windows(dwin, ws, hp, wp), None, dbias
    dqg = dq_sum[:, :, :L].permute(0, 2, 1, 3).reshape(b, L, -1)
    dwin = torch.stack([dk, dv])[..., :L, :].to(dtype)
    return ops.from_windows(dwin, ws, hp, wp), dqg, dbias


# (Hp, Wp, heads, ws): 2 x 2 windows of L = 49 (GCViT's stages 1, 2, 4 and
# DaViT's), 2 x 1 windows of L = 196 (GCViT's stage 3 has one)
SHAPES = {49: (14, 14, 2, 7), 196: (28, 14, 1, 14)}
MODES = ("bias", "nobias", "global")
# relative to the reference's largest entry, as the card's K3b/K5 checks
# (chip_smoke.DOT_BWD_TOLERANCE): dproj, dqg, dbias
TOLERANCE = {torch.float32: (1e-4, 1e-4, 1e-3), torch.bfloat16: (2e-2, 2.0 ** -8, 1e-3)}


def _inputs(shape, mode, b=2, seed=0, dtype=torch.float32):
    """numpy draws as chip_smoke.dot_inputs makes them on the card: N(0, 1)
    projections, queries, bias and dout, scale head_dim ** -0.5."""
    hp, wp, heads, ws = shape
    rng = np.random.default_rng(seed)
    L, c = ws * ws, heads * 32
    parts = 2 if mode == "global" else 3
    proj = torch.from_numpy(rng.normal(size=(b, hp, wp, parts * c))).to(dtype)
    qg = torch.from_numpy(rng.normal(size=(b, L, c))).to(dtype) if parts == 2 else None
    scale = torch.full((heads,), 32 ** -0.5)
    bias = (torch.from_numpy(rng.normal(size=(heads, L, L))).float()
            if mode != "nobias" else None)
    dout = torch.from_numpy(rng.normal(size=(b, hp, wp, c))).to(dtype)
    return proj, qg, scale, bias, dout, ws, heads


def _plain(proj, qg, scale, bias, dout, ws, heads):
    """(dproj, dqg or None, dbias or None) of the plain backwards."""
    if qg is None:
        dqkv, dbias = ops.window_attention_bwd_plain(proj, scale, bias, dout, ws, heads)
        return dqkv, None, dbias
    return ops.window_attention_global_bwd_plain(proj, qg, scale, bias, dout, ws, heads)


def _close(got, ref, tolerance):
    for g, r, tol in zip(got, ref, tolerance):
        assert (g is None) == (r is None)
        if g is None:
            continue
        assert g.shape == r.shape and g.dtype == r.dtype
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_tile_order_matches_plain_backward(dtype, L, mode):
    args = _inputs(SHAPES[L], mode, dtype=dtype)
    got = emulate_backward(*args, images_per_block=1)
    _close(got, _plain(*args), TOLERANCE[dtype])


@pytest.mark.parametrize("mode", ["bias", "global"])
def test_tile_order_sums_several_images_per_slab(mode):
    """Five images, three to a dk/dv block (the last slice ragged)."""
    args = _inputs(SHAPES[49], mode, b=5, seed=3, dtype=torch.bfloat16)
    got = emulate_backward(*args, images_per_block=3)
    _close(got, _plain(*args), TOLERANCE[torch.bfloat16])


def test_global_dqg_is_the_sum_over_the_windows():
    """dqg must hang on every window: keeping only the last window's dq (a
    fault the card's checks must see) breaks the tolerance by far."""
    args = _inputs(SHAPES[49], "global", seed=4, dtype=torch.bfloat16)
    proj, qg, scale, bias, dout, ws, heads = args
    _, dqg, _ = _plain(*args)
    # the last window alone: the other windows' dout set to zero
    last = torch.zeros_like(dout)
    last[:, ws:, ws:] = dout[:, ws:, ws:]
    _, dqg_last, _ = _plain(proj, qg, scale, bias, last, ws, heads)
    err = (dqg_last - dqg).abs().max().item()
    assert err > 16 * TOLERANCE[torch.bfloat16][1] * dqg.abs().max().item()


@pytest.mark.parametrize("L", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_tile_order_matches_pallas_backward(L, mode):
    """Against jax.vjp through the JAX package's Pallas kernels
    (fused_window_attention(_global), reached by window_attention_spatial)
    in interpret mode, f32: the same gradients up to the summation order."""
    proj, qg, scale, bias, dout, ws, heads = _inputs(SHAPES[L], mode, b=1, seed=5)
    operands = [jnp.asarray(proj.numpy())]
    if qg is not None:
        operands.append(jnp.asarray(qg.numpy()))
    if bias is not None:
        operands.append(jnp.asarray(bias.numpy()))

    def f(*xs):
        xs = list(xs)
        p = xs.pop(0)
        q = xs.pop(0) if qg is not None else None
        bi = xs.pop(0) if bias is not None else None
        return jax_ops.window_attention_spatial(p, jnp.asarray(scale.numpy()), bi, ws=ws,
                                                nheads=heads, q_global=q, interpret=True)

    _, vjp = jax.vjp(f, *operands)
    refs = [np.asarray(g) for g in vjp(jnp.asarray(dout.numpy()))]
    got = [t.numpy() for t in emulate_backward(proj, qg, scale, bias, dout, ws, heads, 1)
           if t is not None]
    assert len(got) == len(refs)
    for g, r in zip(got, refs):
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()


# gcvit_tiny's four stages at 224x224 and davit_t's: (nW, heads, ws)
GCVIT = [(64, 2, 7), (16, 4, 7), (1, 8, 14), (1, 16, 7)]
DAVIT = [(64, 3, 7), (16, 6, 7), (4, 12, 7), (1, 24, 7)]


def test_backward_scratch_sizes_grid_and_scratch(monkeypatch):
    """The grid and scratch of both routes at gcvit_tiny's and davit_t's
    stages at batch 128 on a 132-SM card."""
    monkeypatch.setattr(swin_ops, "_sm_count", lambda device: 132)
    cpu = torch.device("cpu")
    b = 128
    peak = 0
    for nw, heads, ws in GCVIT + DAVIT:
        L = ws * ws
        tiles = -(-L // 64)
        for has_bias, global_queries in ((True, False), (False, False), (True, True)):
            # f32: as before the tensor-core route, on the FMA template
            f32 = ops.backward_scratch(b, nw, heads, ws, torch.float32, cpu, has_bias,
                                       global_queries)
            positions = heads if global_queries else nw * heads
            assert f32.images_per_block == swin_ops._images_per_block(b, positions, cpu)
            slices = -(-b // f32.images_per_block)
            assert f32.slots == (slices if global_queries else nw * slices)
            assert f32.row_stats == f32.work == 0
            plan = ops.backward_scratch(b, nw, heads, ws, torch.bfloat16, cpu, has_bias,
                                        global_queries)
            slices = -(-b // plan.images_per_block)
            assert 1 <= plan.images_per_block <= b
            assert plan.slots == (nw * slices if has_bias else 0)
            assert plan.row_stats == 3 * b * heads * nw * L
            # the bias in rows of 52 floats at L = 49, none at 196
            assert plan.work == (heads * L * 52 if has_bias and ws == 7 else 0)
            # the dk/dv pass: about four waves of one block per SM (to
            # whole images per block), its slabs under 64 MiB
            blocks = nw * tiles * heads * slices
            assert blocks >= 0.9 * min(4 * 132, nw * tiles * heads * b)
            assert slices * nw * heads * L * L * 4 * has_bias <= 2 ** 26
            peak = max(peak, plan.nbytes(heads, L))
    # the largest: gcvit_tiny's stage 3, 16 slices of 8 images with 19.7 MB
    # of dbias slabs and 2.4 MB of statistics
    stage3 = ops.backward_scratch(b, 1, 8, 14, torch.bfloat16, cpu)
    assert peak == stage3.nbytes(8, 196) < 23e6
    # stage 4 (one window, one key tile, 16 heads): 32 slices of 4 images
    assert ops.backward_scratch(b, 1, 16, 7, torch.bfloat16, cpu).images_per_block == 4


def test_backward_routes_are_named():
    assert ops.BWD_ROUTES == ("templates", "mma")
