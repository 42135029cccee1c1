"""The port's plain (dot-product) window attention against ``torchok_tpu``'s.

``window_attention_spatial`` of both packages on the same numpy inputs: the
JAX one with ``interpret=True`` so that its Pallas kernels run (the spatial
layout for a window divisible by 8, the windowed one for 7 and 14, the
global-query kernels with ``q_global``), the port's on the CPU, where it takes
the plain versions. Gradients through ``jax.vjp`` and ``torch.autograd.grad``
with the same cotangent. The Hopper kernels themselves are held against the
plain versions on the card in ``test_torch_cuda_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.ops import swin_attention as jax_ops
from torchok_tpu_torch.ops import window_attention_dot as ops

# (B, Hp, Wp, ws, heads, head_dim, with_bias)
LOCAL = {
    "ws7_bias": (2, 14, 14, 7, 2, 8, True),       # GCViT local, windowed on the TPU
    "ws7_nobias": (2, 14, 7, 7, 3, 8, False),     # DaViT
    "ws14_bias": (2, 14, 14, 14, 2, 8, True),     # GCViT stage 3: one window per image
    "ws8_bias": (2, 8, 16, 8, 2, 8, True),        # the JAX spatial layout
    "ws8_nobias": (2, 16, 8, 8, 2, 8, False),
    "ws4_d32": (1, 8, 8, 4, 2, 32, True),         # the kernels' head dim
}
GLOBAL = {
    "ws7": (2, 14, 14, 7, 2, 8),
    "ws14": (2, 14, 14, 14, 2, 8),
    "ws8": (2, 8, 16, 8, 2, 8),
    "ws4_d32": (1, 8, 12, 4, 2, 32),
}


def _inputs(b, hp, wp, ws, h, d, with_bias, parts, seed=0):
    rng = np.random.default_rng(seed)
    L = ws * ws
    proj = rng.normal(size=(b, hp, wp, parts * h * d)).astype(np.float32)
    scale = np.full((h,), d ** -0.5, np.float32)
    bias = rng.normal(size=(h, L, L)).astype(np.float32) if with_bias else None
    qg = rng.normal(size=(b, L, h * d)).astype(np.float32) if parts == 2 else None
    dout = rng.normal(size=(b, hp, wp, h * d)).astype(np.float32)
    return proj, scale, bias, qg, dout


def _jax_run(proj, scale, bias, qg, dout, ws, h, dtype):
    """(out, grads of the differentiable inputs in order proj, [qg], [bias])."""
    operands = [jnp.asarray(proj, dtype)]
    if qg is not None:
        operands.append(jnp.asarray(qg, dtype))
    if bias is not None:
        operands.append(jnp.asarray(bias))

    def f(*xs):
        xs = list(xs)
        p = xs.pop(0)
        q = xs.pop(0) if qg is not None else None
        bi = xs.pop(0) if bias is not None else None
        return jax_ops.window_attention_spatial(p, jnp.asarray(scale), bi, ws=ws, nheads=h,
                                                q_global=q, interpret=True)

    out, vjp = jax.vjp(f, *operands)
    grads = vjp(jnp.asarray(dout, dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port_run(proj, scale, bias, qg, dout, ws, h, dtype):
    p = torch.from_numpy(proj).to(dtype).requires_grad_(True)
    leaves = [p]
    q = bi = None
    if qg is not None:
        q = torch.from_numpy(qg).to(dtype).requires_grad_(True)
        leaves.append(q)
    if bias is not None:
        bi = torch.from_numpy(bias).requires_grad_(True)
        leaves.append(bi)
    out = ops.window_attention_spatial(p, torch.from_numpy(scale), bi, ws, h, q_global=q)
    assert out.dtype == dtype
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout).to(dtype))
    assert grads[0].dtype == dtype
    if qg is not None:
        assert grads[1].dtype == dtype
    if bias is not None:
        assert grads[-1].dtype == torch.float32
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


def _torch_inputs(*args, **kwargs):
    return [None if a is None else torch.from_numpy(a) for a in _inputs(*args, **kwargs)]


def _close(got, ref, rel, name):
    assert got.shape == ref.shape, name
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1.0), name


@pytest.mark.parametrize("case", list(LOCAL))
def test_local_forward_and_gradients_match_pallas_f32(case):
    b, hp, wp, ws, h, d, with_bias = LOCAL[case]
    args = _inputs(b, hp, wp, ws, h, d, with_bias, parts=3)
    before = dict(ops.LAUNCHES)
    out, grads = _port_run(*args, ws, h, torch.float32)
    assert ops.LAUNCHES[ops.PLAIN] == before.get(ops.PLAIN, 0) + 1
    assert ops.LAUNCHES[ops.PLAIN_BWD] == before.get(ops.PLAIN_BWD, 0) + 1
    ref_out, ref_grads = _jax_run(*args, ws, h, jnp.float32)
    # f32 throughout, only the summation order differs: 1e-5 of the largest entry
    _close(out, ref_out, 1e-5, "out")
    assert len(grads) == len(ref_grads) == 1 + with_bias
    for g, r, name in zip(grads, ref_grads, ("dqkv", "dbias")):
        _close(g, r, 1e-5, name)


@pytest.mark.parametrize("case", list(GLOBAL))
def test_global_forward_and_gradients_match_pallas_f32(case):
    b, hp, wp, ws, h, d = GLOBAL[case]
    args = _inputs(b, hp, wp, ws, h, d, True, parts=2, seed=1)
    before = dict(ops.LAUNCHES)
    out, grads = _port_run(*args, ws, h, torch.float32)
    assert ops.LAUNCHES[ops.PLAIN_GLOBAL] == before.get(ops.PLAIN_GLOBAL, 0) + 1
    assert ops.LAUNCHES[ops.PLAIN_GLOBAL_BWD] == before.get(ops.PLAIN_GLOBAL_BWD, 0) + 1
    ref_out, ref_grads = _jax_run(*args, ws, h, jnp.float32)
    _close(out, ref_out, 1e-5, "out")
    for g, r, name in zip(grads, ref_grads, ("dkv", "dqg", "dbias")):
        _close(g, r, 1e-5, name)


@pytest.mark.parametrize("mode", ["local", "local_nobias", "global"])
def test_bf16_matches_pallas(mode):
    """bf16 projection, queries and dout: both sides round the weights and the
    scaled logit gradient to bf16 at the same points, so the outputs and the
    bf16 gradients agree to a bf16 ulp of their largest entry (2^-7 relative
    covers a flipped rounding) and the f32 dbias sum to 1e-2 of its largest."""
    parts = 2 if mode == "global" else 3
    b, hp, wp, ws, h, d = 2, 14, 14, 7, 2, 8
    args = _inputs(b, hp, wp, ws, h, d, mode != "local_nobias", parts, seed=2)
    out, grads = _port_run(*args, ws, h, torch.bfloat16)
    ref_out, ref_grads = _jax_run(*args, ws, h, jnp.bfloat16)
    _close(out, ref_out, 2.0 ** -7, "out")
    names = {"local": ("dqkv", "dbias"), "local_nobias": ("dqkv",),
             "global": ("dkv", "dqg", "dbias")}[mode]
    for g, r, name in zip(grads, ref_grads, names):
        _close(g, r, 1e-2 if name == "dbias" else 2.0 ** -7, name)
    # and it is not the f32 result: the rounding is really there
    f32_out, _ = _port_run(*args, ws, h, torch.float32)
    assert np.abs(out - f32_out).max() > 1e-3


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_plain_backward_matches_autograd_of_plain_forward(with_bias):
    """In f32 nothing is rounded, so the hand-written backwards must equal
    autograd through the plain forwards (to f32 rounding, 1e-5 relative)."""
    b, hp, wp, ws, h, d = 2, 14, 7, 7, 2, 8
    qkv, scale, bias, _, dout = _torch_inputs(b, hp, wp, ws, h, d, with_bias, 3, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (qkv, bias) if t is not None]
    out = ops.window_attention_fwd_plain(leaves[0], scale, leaves[1] if with_bias else None, ws, h)
    ref = torch.autograd.grad(out, leaves, dout)
    dqkv, dbias = ops.window_attention_bwd_plain(qkv, scale, bias, dout, ws, h)
    assert (dbias is None) == (not with_bias)
    for g, r in zip((dqkv, dbias), ref):
        assert (g - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1.0)

    kv, scale, bias, qg, dout = _torch_inputs(b, hp, wp, ws, h, d, True, 2, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (kv, qg, bias)]
    out = ops.window_attention_global_fwd_plain(leaves[0], leaves[1], scale, leaves[2], ws, h)
    ref = torch.autograd.grad(out, leaves, dout)
    got = ops.window_attention_global_bwd_plain(kv, qg, scale, bias, dout, ws, h)
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1.0)


def test_scale_multiplies_the_logits_and_gets_no_gradient():
    qkv, scale, bias, _, dout = _torch_inputs(1, 8, 8, 4, 2, 8, True, 3, seed=5)
    scale = (scale * torch.tensor([1.0, 3.0])).requires_grad_(True)
    q = qkv.clone().requires_grad_(True)
    out = ops.window_attention_spatial(q, scale, bias, 4, 2)
    out.backward(dout)
    assert scale.grad is None and q.grad is not None
    # per-head scale on the logits: head 1 equals attention on 3x the queries
    scaled = qkv.clone()
    scaled[..., 8:16] *= 3.0
    ref = ops.window_attention_spatial(scaled, torch.full((2,), 8 ** -0.5), bias, 4, 2)
    torch.testing.assert_close(out.detach(), ref, rtol=1e-5, atol=1e-6)


def test_no_graph_without_grad_and_strided_dout():
    """Eval runs under inference_mode: the op must not go through the autograd
    function; a strided f32 gradient is cast once."""
    kv, scale, bias, qg, dout = _torch_inputs(2, 8, 8, 4, 2, 8, True, 2, seed=6)
    bias.requires_grad_(True)
    with torch.inference_mode():
        out = ops.window_attention_spatial(kv, scale, bias, 4, 2, q_global=qg)
    assert out.grad_fn is None and not out.requires_grad
    before = dict(ops.LAUNCHES)
    qg.requires_grad_(True)
    out = ops.window_attention_spatial(kv.bfloat16(), scale, bias, 4, 2, q_global=qg)
    out.backward(dout.transpose(1, 2).contiguous().transpose(1, 2))
    assert ops.LAUNCHES[ops.PLAIN_GLOBAL_BWD] == before.get(ops.PLAIN_GLOBAL_BWD, 0) + 1
    assert qg.grad.dtype == torch.float32 and qg.grad.shape == qg.shape  # cast back from bf16
    assert bias.grad.shape == bias.shape
    with pytest.raises(ValueError, match="needs its bias"):
        ops.window_attention_spatial(kv, scale, None, 4, 2, q_global=qg)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device, to reach the wrappers'
    checks where there is no card."""
    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(t):
    return t.as_subclass(_FakeCuda)


@pytest.mark.parametrize("kind", ["fwd", "bwd", "global_fwd", "global_bwd"])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(kind):
    """On a (mocked) CUDA tensor the wrappers raise before any launch: head
    dim other than 32, a window above 16, other dtypes, strided input."""
    b, hp, wp, ws, h = 1, 8, 8, 4, 2
    parts = 2 if "global" in kind else 3

    def call(d=32, ws_=ws, dtype=torch.float32, strided=False, hp_=hp):
        proj, scale, bias, qg, dout = (None if a is None else _fake(a) for a in
                                       _torch_inputs(b, hp_, hp_, ws_, h, d, True, parts))
        proj = proj.to(dtype)
        if strided:
            proj = _fake(proj.transpose(1, 2))
        fn = {"fwd": lambda: ops.window_attention_fwd_cuda(proj, scale, bias, ws_, h),
              "bwd": lambda: ops.window_attention_bwd_cuda(proj, scale, bias, dout, ws_, h),
              "global_fwd": lambda: ops.window_attention_global_fwd_cuda(
                  proj, qg, scale, bias, ws_, h),
              "global_bwd": lambda: ops.window_attention_global_bwd_cuda(
                  proj, qg, scale, bias, dout, ws_, h)}[kind]
        return fn()

    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="head dim 32"):
        call(d=16)
    with pytest.raises(ValueError, match="ws <= 16"):
        call(ws_=17, hp_=17)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        call(dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        call(strided=True)
    assert dict(ops.LAUNCHES) == before
    # a real CPU tensor never reaches a kernel wrapper's launch
    proj = torch.zeros(b, hp, wp, parts * h * 32)
    with pytest.raises(ValueError, match="CUDA"):
        ops._check_args(ops.KERNEL, proj, parts, torch.ones(h), None, ws, h)
