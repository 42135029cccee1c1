"""A CPU rehearsal of the order in which K6's bf16 tensor-core forward
(``csrc/window_attention_mw_mma.cuh``: cosine window attention on
pre-partitioned head-major windows) does its work, held against the plain
version and the JAX package's Pallas kernel.

``emulate_forward`` is a test-only PyTorch transcription of the kernel's
loop: a block per (mask row w, head, slice of the windows w + j n_mask) as
``ops.window_attention.forward_plan`` sizes it, each window taking the
block's one mask row; q k^T on the raw bf16 rows (exact products, f32
sums), scaled by rq rk s with the inverse norms rsqrt(sum x^2 + 1e-12) in
f32, the bias added in the same step and the mask after it; one sweep (row
max, e = exp(logit - m) in base 2, l, a32 = e (1 / l)); a32 split into hi =
bf16(a32) and lo = bf16(a32 - hi), each against v; one rounding. Also
tested: the route per (dtype, L, D), the sizing of the slices (every window
once, each with its own mask row, a ragged last slice too), and that the
one-ulp check of ``chip_smoke.py`` sees a version that rounds the weights
or the unit vectors to bf16.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.ops import window_attention as jwa
from torchok_tpu_torch.ops import window_attention as wa
from torchok_tpu_torch.ops.common import LN_100

REPO = Path(__file__).resolve().parent.parent
LOG2E = 1.4426950408889634
NW, IMAGES, HEADS = 4, 3, 3  # window types, images, heads
MASKS = {"none": 0, "one": 1, "compact": NW, "tiled": NW * IMAGES}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def _inputs(L, d, rows, seed=0, b=NW * IMAGES):
    """numpy draws as chip_smoke.mw_inputs makes them on the card (q, k, v
    0.5 N(0, 1), temperatures about 10, bias in (0, 16), 30% of the mask
    -100), with head 0's temperature clamped at 100; bf16 q, k, v."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(0.5 * rng.normal(size=(b, HEADS, L, d))).bfloat16()
               for _ in range(3))
    logit_scale = torch.from_numpy(np.log(10.0) + 0.5 * rng.normal(size=HEADS)).float()
    logit_scale[0] = 5.0
    bias = torch.from_numpy(16.0 / (1.0 + np.exp(-rng.normal(size=(HEADS, L, L))))).float()
    mask = (torch.from_numpy(-100.0 * (rng.uniform(size=(rows, L, L)) < 0.3)).float()
            if rows else None)
    return q, k, v, logit_scale, bias, mask


def block_windows(plan, b, n_mask):
    """(block, mask row, windows) as the kernel's blocks take them."""
    rows = max(n_mask, 1)
    per = plan.windows_per_block
    for x in range(plan.grid[0]):
        w, j0 = x % rows, (x // rows) * per
        yield x, w, [w + (j0 + j) * rows for j in range(min(per, b // rows - j0))]


def emulate_forward(q, k, v, logit_scale, bias, mask, plan, round_weights=False,
                    round_unit_vectors=False):
    """The output computed in the kernel's order (see the module docstring);
    all heads of a window at once. ``round_weights`` / ``round_unit_vectors``
    give the variants the one-ulp check must refuse: bf16(a32) against v
    alone, or qn and kn rounded to bf16 before the product."""
    b = q.shape[0]
    n_mask = 0 if mask is None else mask.shape[0]
    s = torch.exp(torch.clamp(logit_scale.float(), max=LN_100))[:, None, None]
    out = torch.empty_like(q)
    for _, w, windows in block_windows(plan, b, n_mask):
        for win in windows:
            qf, kf, vf = q[win].float(), k[win].float(), v[win].float()
            rq = torch.rsqrt((qf * qf).sum(-1) + 1e-12)
            rk = torch.rsqrt((kf * kf).sum(-1) + 1e-12)
            if round_unit_vectors:
                dot = ((qf * rq[..., None]).bfloat16().float()
                       @ (kf * rk[..., None]).bfloat16().float().transpose(-1, -2))
                logit = torch.addcmul(bias, dot, s.expand_as(dot))
            else:
                logit = torch.addcmul(bias, qf @ kf.transpose(-1, -2),
                                      (rq[..., :, None] * s) * rk[..., None, :])
            if mask is not None:
                logit = logit + mask[w]
            m2 = logit.amax(-1, keepdim=True) * LOG2E
            e = torch.exp2(logit * LOG2E - m2)
            a32 = e * (1.0 / e.sum(-1, keepdim=True))
            hi = a32.bfloat16().float()
            lo = torch.zeros_like(a32) if round_weights else (a32 - hi).bfloat16().float()
            out[win] = (hi @ vf + lo @ vf).bfloat16()
    return out


def _plan(q, mask, windows=None):
    """forward_plan's slices on a 132-SM card, or ``windows`` a block."""
    b, heads, L, _ = q.shape
    n_mask = 0 if mask is None else mask.shape[0]
    if windows is None:
        return _forward_plan(b, heads, n_mask, L)
    rows = max(n_mask, 1)
    return wa.ForwardPlan(windows, (rows * -(-(b // rows) // windows), heads), 128)


def _forward_plan(b, heads, n_mask, L, sms=132):
    real = wa.swin_attention._sm_count
    wa.swin_attention._sm_count = lambda device: sms
    try:
        return wa.forward_plan.__wrapped__(b, heads, n_mask, L, torch.device("cpu"))
    finally:
        wa.swin_attention._sm_count = real


def _close(got, ref, v):
    """bf16 outputs: within one bf16 ulp element by element (chip_smoke's
    check), and within 2e-2 (the card's bf16 tolerance)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.bfloat16
    assert CS.outside_one_ulp(got, ref, v) == 0
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("n_mask", list(MASKS))
@pytest.mark.parametrize("L,d", [(64, 32), (16, 32), (64, 8), (16, 8)])
def test_tile_order_matches_plain_version(L, d, n_mask):
    """Also at head dim 8, which takes the FMA route on the card: the
    rewrites hold at that width too."""
    args = _inputs(L, d, MASKS[n_mask])
    got = emulate_forward(*args, _plan(args[0], args[5]))
    _close(got, wa.window_attention_mw_plain(*args), args[2])


@pytest.mark.parametrize("n_mask", list(MASKS))
@pytest.mark.parametrize("L,d", [(64, 32), (16, 8)])
def test_tile_order_matches_the_pallas_kernel(L, d, n_mask):
    """Against ``_window_attention_pallas_mw`` in interpret mode on the same
    bf16 inputs (f32 inside, one rounding); no mask is its zeros row."""
    q, k, v, ls, bias, mask = _inputs(L, d, MASKS[n_mask], seed=1)
    jm = np.zeros((1, L, L), np.float32) if mask is None else mask.numpy()
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    ref = jwa._window_attention_pallas_mw(jq, jk, jv, jnp.asarray(ls.numpy()),
                                          jnp.asarray(bias.numpy()), jnp.asarray(jm),
                                          interpret=True)
    ref = torch.from_numpy(np.asarray(ref, np.float32)).bfloat16()
    _close(emulate_forward(q, k, v, ls, bias, mask, _plan(q, mask)), ref, v)


def test_a_ragged_last_slice_takes_its_own_windows_and_mask_row():
    """Slices of 3 of each mask row's 3 x 5 windows: rows w take windows w,
    w + 4, ..., the last slice of each row two of them."""
    args = _inputs(64, 32, NW, seed=2, b=NW * 5)
    plan = _plan(args[0], args[5], windows=3)
    assert plan.grid == (NW * 2, HEADS)
    _close(emulate_forward(*args, plan), wa.window_attention_mw_plain(*args), args[2])


@pytest.mark.parametrize("variant", ["round_weights", "round_unit_vectors"])
def test_the_one_ulp_check_refuses_bf16_weights_or_unit_vectors(variant):
    """What K1's bf16 kernel does (a = bf16(a32); qn, kn in bf16) is outside
    one ulp of the plain version in many elements, where the kernel's order
    is in none."""
    args = _inputs(64, 32, NW, seed=3)
    ref = wa.window_attention_mw_plain(*args)
    got = emulate_forward(*args, _plan(args[0], args[5]), **{variant: True})
    assert CS.outside_one_ulp(got, ref, args[2]) > 100
    assert CS.outside_one_ulp(emulate_forward(*args, _plan(args[0], args[5])), ref, args[2]) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("L", [16, 64])
@pytest.mark.parametrize("d", [8, 32])
def test_forward_route_per_dtype_and_shape(dtype, L, d):
    """bf16 at head dim 32 on the tensor cores; f32, and bf16 at head dim 8,
    on the FMA template."""
    want = "mma" if dtype == torch.bfloat16 and d == 32 else "fma"
    assert wa.forward_route(dtype, L, d) == want
    assert wa.FWD_ROUTES == ("fma", "mma")


def test_forward_route_refuses_other_shapes_and_types():
    with pytest.raises(ValueError, match="head dim"):
        wa.forward_route(torch.bfloat16, 49, 32)
    with pytest.raises(ValueError, match="head dim"):
        wa.forward_route(torch.bfloat16, 64, 16)
    with pytest.raises(TypeError):
        wa.forward_route(torch.float16, 64, 32)


@pytest.mark.parametrize("b,heads,n_mask,L", [
    (128 * 64, 3, 64, 64), (128 * 64, 3, 0, 64), (128 * 16, 6, 16, 64), (128 * 4, 12, 4, 64),
    (128, 24, 0, 64), (20, 3, 4, 16), (12, 3, 12, 64), (7, 5, 1, 16), (88 * 64, 3, 64, 64)])
def test_forward_plan_covers_every_window_once_with_its_mask_row(b, heads, n_mask, L):
    plan = _forward_plan(b, heads, n_mask, L)
    rows = max(n_mask, 1)
    assert plan.threads == 128 and plan.grid[1] == heads
    seen = []
    for _, w, windows in block_windows(plan, b, n_mask):
        assert 1 <= len(windows) <= plan.windows_per_block
        assert all(win % rows == w for win in windows)  # the block's one mask row
        seen += windows
    assert sorted(seen) == list(range(b))


def test_forward_plan_at_swinv2_tinys_stages():
    """About one wave of blocks on a 132-SM card (3 an SM with the mask
    tile, 4 without) at swinv2_tiny's four stages at bs 128."""
    stages = [(64, 3), (16, 6), (4, 12), (1, 24)]
    for nw, heads in stages:
        for n_mask in ((0, nw) if nw > 1 else (0,)):
            plan = _forward_plan(128 * nw, heads, n_mask, 64)
            blocks = plan.grid[0] * plan.grid[1]
            slots = (3 if n_mask else 4) * 132
            assert 0.9 * slots <= blocks <= 1.1 * slots
    assert _forward_plan(128 * 64, 3, 64, 64).windows_per_block == 64
    assert _forward_plan(128, 24, 0, 64).grid == (22, 24)
