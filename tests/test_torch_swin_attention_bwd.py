"""The port's fused SwinV2 window attention backward against ``torchok_tpu``'s.

On the CPU the port's autograd function runs its plain backward, held
against ``jax.vjp`` through the Pallas kernels in interpret mode on the same
numpy inputs and cotangent. The Hopper kernel itself is held against the
plain backward on the card in ``test_torch_cuda_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.models.backbones.swin import _shift_window_region_ids
from torchok_tpu.ops import swin_attention as jax_ops
from torchok_tpu_torch.ops import swin_attention as ops
from torchok_tpu_torch.ops.window_attention import LN_100

# (B, Hp, Wp, ws, heads, head_dim); the second has the slice's L = 64
GEOMETRIES = [(2, 8, 12, 4, 2, 8), (2, 16, 16, 8, 2, 8)]


def _inputs(b, hp, wp, ws, h, d, masked, seed=0):
    rng = np.random.default_rng(seed)
    L = ws * ws
    qkv = rng.normal(size=(b, hp, wp, 3 * h * d)).astype(np.float32)
    logit_scale = (np.log(10.0) + 0.3 * rng.normal(size=(h,))).astype(np.float32)
    bias = (16.0 / (1.0 + np.exp(-rng.normal(size=(h, L, L))))).astype(np.float32)
    dout = rng.normal(size=(b, hp, wp, h * d)).astype(np.float32)
    mask = None
    if masked:
        ids = _shift_window_region_ids(hp, wp, ws, ws // 2)
        mask = np.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0).astype(np.float32)
    return qkv, logit_scale, bias, mask, dout


def _jax_grads(qkv, logit_scale, bias, mask, dout, ws, h, dtype):
    m = None if mask is None else jnp.asarray(mask)

    def f(q, s, b):
        return jax_ops.fused_swin_attention(q, s, b, m, ws=ws, nheads=h, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(qkv, dtype), jnp.asarray(logit_scale), jnp.asarray(bias))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dout, dtype))]


def _port_grads(qkv, logit_scale, bias, mask, dout, ws, h, dtype):
    q = torch.from_numpy(qkv).to(dtype).requires_grad_(True)
    s = torch.from_numpy(logit_scale).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    m = None if mask is None else torch.from_numpy(mask)
    out = ops.fused_swin_attention(q, s, b, m, ws=ws, nheads=h)
    grads = torch.autograd.grad(out, (q, s, b), torch.from_numpy(dout).to(dtype))
    assert grads[0].dtype == dtype and grads[1].dtype == grads[2].dtype == torch.float32
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["ws4", "ws8"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_gradients_match_pallas_kernel_f32(geometry, masked):
    b, hp, wp, ws, h, d = geometry
    args = _inputs(b, hp, wp, ws, h, d, masked)
    ref = _jax_grads(*args, ws, h, jnp.float32)
    got = _port_grads(*args, ws, h, torch.float32)
    for g, r, name in zip(got, ref, ("dqkv", "dlogit_scale", "dbias")):
        assert g.shape == r.shape, name
        # f32 throughout; only the summation order differs: 1e-5 of the
        # tensor's largest entry
        assert np.abs(g - r).max() <= 1e-5 * max(np.abs(r).max(), 1.0), name


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_gradients_match_pallas_kernel_bf16(masked):
    """bf16 qkv and dout: both round qn/kn, the attention weights and the
    scaled logit gradient to bf16 at the same points, so dqkv agrees to a
    bf16 ulp of its largest entry (2^-7 relative covers a flipped rounding)
    and the f32 sums dbias/dlogit_scale to 1e-2 of theirs."""
    b, hp, wp, ws, h, d = GEOMETRIES[1]
    args = _inputs(b, hp, wp, ws, h, d, masked, seed=1)
    ref = _jax_grads(*args, ws, h, jnp.bfloat16)
    got = _port_grads(*args, ws, h, torch.bfloat16)
    for g, r, rel in zip(got, ref, (2.0 ** -7, 1e-2, 1e-2)):
        assert np.abs(g - r).max() <= rel * np.abs(r).max()
    # and it is not the f32 result: the rounding is really there
    f32 = _port_grads(*args, ws, h, torch.float32)
    assert np.abs(got[0] - f32[0]).max() > 1e-3


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["ws4", "ws8"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_plain_backward_matches_autograd_of_plain_forward(geometry, masked):
    """In f32 nothing is rounded, so the hand-written backward must equal
    autograd through the plain forward (to f32 rounding, 1e-5 relative)."""
    b, hp, wp, ws, h, d = geometry
    qkv, logit_scale, bias, mask, dout = (None if a is None else torch.from_numpy(a)
                                          for a in _inputs(b, hp, wp, ws, h, d, masked, seed=2))
    scale = torch.exp(torch.clamp(logit_scale, max=LN_100))
    leaves = [t.clone().requires_grad_(True) for t in (qkv, scale, bias)]
    out = ops.swin_attention_fwd_plain(leaves[0], leaves[1], leaves[2], mask, ws, h)
    ref = torch.autograd.grad(out, leaves, dout)
    dqkv, dbias, dscale = ops.swin_attention_bwd_plain(qkv, scale, bias, mask, dout, ws, h)
    for g, r in zip((dqkv, dscale, dbias), ref):
        assert (g - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1.0)


def test_cpu_backward_takes_plain_path_and_skips_unneeded_grads():
    qkv, logit_scale, bias, mask, dout = _inputs(*GEOMETRIES[0], masked=True)
    q = torch.from_numpy(qkv).requires_grad_(True)
    before = dict(ops.LAUNCHES)
    out = ops.fused_swin_attention(q, torch.from_numpy(logit_scale), torch.from_numpy(bias),
                                   torch.from_numpy(mask), ws=4, nheads=2)
    out.backward(torch.from_numpy(dout).transpose(1, 2).contiguous().transpose(1, 2))  # strided
    assert q.grad is not None and q.grad.shape == q.shape
    assert ops.LAUNCHES[ops.PLAIN_BWD] == before.get(ops.PLAIN_BWD, 0) + 1
    assert ops.LAUNCHES[ops.KERNEL_BWD] == before.get(ops.KERNEL_BWD, 0)


def test_no_graph_without_grad():
    """Eval runs under inference_mode: the op must not go through the
    autograd function or keep anything alive."""
    qkv, logit_scale, bias, _, _ = _inputs(*GEOMETRIES[0], masked=False)
    s = torch.from_numpy(logit_scale).requires_grad_(True)
    with torch.inference_mode():
        out = ops.fused_swin_attention(torch.from_numpy(qkv), s, torch.from_numpy(bias),
                                       None, ws=4, nheads=2)
    assert out.grad_fn is None and not out.requires_grad


def test_backward_wrapper_refusals():
    qkv, logit_scale, bias, mask, dout = (None if a is None else torch.from_numpy(a)
                                          for a in _inputs(*GEOMETRIES[1], masked=False))
    with pytest.raises(ValueError, match="CUDA"):
        ops.swin_attention_bwd_cuda(qkv, logit_scale, bias, None, dout, 8, 2)
    q = qkv.clone().requires_grad_(True)
    out = ops.fused_swin_attention(q, logit_scale, bias, None, ws=8, nheads=2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.SwinAttentionFunction.backward(out.grad_fn, dout.double())
