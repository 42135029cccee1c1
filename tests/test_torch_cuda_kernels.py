"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Imports neither JAX nor ``torchok_tpu``, so it runs where only
torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Without a CUDA device every test here skips.
"""
import numpy as np
import pytest
import torch

from torchok_tpu_torch.models.backbones.swin import shift_window_mask
from torchok_tpu_torch.ops import swin_attention as ops
from torchok_tpu_torch.ops import window_attention_dot as dot

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(device, dtype, masked, b=2, hp=32, wp=32, heads=6, seed=3):
    rng = np.random.default_rng(seed)
    qkv = 0.5 * rng.normal(size=(b, hp, wp, 3 * heads * 32)).astype(np.float32)
    scale = np.exp(np.minimum(np.log(10.0) + rng.normal(size=heads), np.log(100.0)))
    bias = 16.0 / (1.0 + np.exp(-rng.normal(size=(heads, 64, 64))))
    mask = shift_window_mask(hp, wp, 8, 4).to(device) if masked else None
    return (torch.from_numpy(qkv).to(device, dtype),
            torch.from_numpy(scale).float().to(device),
            torch.from_numpy(bias).float().to(device), mask)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_swin_attention_kernel_matches_plain(cuda_device, dtype, atol, masked):
    args = _inputs(cuda_device, dtype, masked)
    before = ops.LAUNCHES[ops.KERNEL]
    got = ops.swin_attention_fwd_cuda(*args, 8, 6)
    ref = ops.swin_attention_fwd_plain(*args, 8, 6)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[ops.KERNEL] == before + 1
    assert got.dtype == dtype and got.shape == (2, 32, 32, 192)
    assert (got.float() - ref.float()).abs().max().item() <= atol


def test_dispatch_sends_cuda_tensors_to_the_kernel(cuda_device):
    qkv, scale, bias, mask = _inputs(cuda_device, torch.bfloat16, True)
    before = dict(ops.LAUNCHES)
    ops.fused_swin_attention(qkv, torch.log(scale), bias, mask, ws=8, nheads=6)
    assert ops.LAUNCHES[ops.KERNEL] == before.get(ops.KERNEL, 0) + 1
    assert ops.LAUNCHES[ops.PLAIN] == before.get(ops.PLAIN, 0)


def test_swin_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    qkv, scale, bias, _ = _inputs(cuda_device, torch.float32, False)
    with pytest.raises(TypeError):
        ops.swin_attention_fwd_cuda(qkv.half(), scale, bias, None, 8, 6)
    with pytest.raises(ValueError, match="contiguous"):
        ops.swin_attention_fwd_cuda(qkv.transpose(1, 2), scale, bias, None, 8, 6)
    with pytest.raises(ValueError, match="head dim"):
        ops.swin_attention_fwd_cuda(qkv, scale[:3], bias[:3], None, 8, 3)


def _dout(device, dtype, b=2, hp=32, wp=32, heads=6, seed=4):
    dout = np.random.default_rng(seed).normal(size=(b, hp, wp, heads * 32)).astype(np.float32)
    return torch.from_numpy(dout).to(device, dtype)


# dqkv is rounded to the input dtype; dbias and dscale are f32 sums in both
# versions, in another order. Each is held to a fraction of the reference's
# largest magnitude.
@pytest.mark.parametrize("dtype,rel", [(torch.float32, (1e-4, 1e-3, 1e-3)),
                                       (torch.bfloat16, (2e-2, 1e-3, 1e-3))], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_swin_attention_bwd_kernel_matches_plain(cuda_device, dtype, rel, masked):
    args = _inputs(cuda_device, dtype, masked)
    dout = _dout(cuda_device, dtype)
    before = ops.LAUNCHES[ops.KERNEL_BWD]
    got = ops.swin_attention_bwd_cuda(*args, dout, 8, 6)
    again = ops.swin_attention_bwd_cuda(*args, dout, 8, 6)
    ref = ops.swin_attention_bwd_plain(*args, dout, 8, 6)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[ops.KERNEL_BWD] == before + 2
    assert got[0].dtype == dtype and got[0].shape == args[0].shape
    assert got[1].shape == (6, 64, 64) and got[2].shape == (6,)
    for g, a, r, tol in zip(got, again, ref, rel):
        assert torch.equal(g, a)  # no atomics: bit-identical from run to run
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


def test_autograd_sends_cuda_tensors_to_both_kernels(cuda_device):
    qkv, scale, bias, mask = _inputs(cuda_device, torch.bfloat16, True)
    qkv.requires_grad_(True)
    logit_scale = torch.log(scale).requires_grad_(True)
    bias.requires_grad_(True)
    before = dict(ops.LAUNCHES)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = ops.fused_swin_attention(qkv, logit_scale, bias, mask, ws=8, nheads=6)
        # a strided f32 gradient, as a following op may hand over
        out.float().transpose(1, 2).square().sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[ops.KERNEL] == before.get(ops.KERNEL, 0) + 1
    assert ops.LAUNCHES[ops.KERNEL_BWD] == before.get(ops.KERNEL_BWD, 0) + 1
    assert ops.LAUNCHES[ops.PLAIN] == before.get(ops.PLAIN, 0)
    assert ops.LAUNCHES[ops.PLAIN_BWD] == before.get(ops.PLAIN_BWD, 0)
    assert qkv.grad.dtype == torch.bfloat16 and logit_scale.grad.shape == (6,)
    assert bias.grad.shape == (6, 64, 64)
    assert all(bool(torch.isfinite(t.grad).all()) for t in (qkv, logit_scale, bias))


def test_swin_attention_bwd_kernel_refuses_what_it_does_not_take(cuda_device):
    qkv, scale, bias, _ = _inputs(cuda_device, torch.float32, False)
    dout = _dout(cuda_device, torch.float32)
    with pytest.raises(TypeError, match="dout"):
        ops.swin_attention_bwd_cuda(qkv, scale, bias, None, dout.bfloat16(), 8, 6)
    with pytest.raises(ValueError, match="contiguous"):
        ops.swin_attention_bwd_cuda(qkv, scale, bias, None,
                                    dout.transpose(1, 2).contiguous().transpose(1, 2), 8, 6)
    with pytest.raises(ValueError, match="dout has shape"):
        ops.swin_attention_bwd_cuda(qkv, scale, bias, None, dout[:1], 8, 6)
    with pytest.raises(ValueError, match="head dim"):
        ops.swin_attention_bwd_cuda(qkv, scale[:3], bias[:3], None, dout, 8, 3)


# ---------------------------------------------------------------------------
# plain (dot-product) window attention: K3 (local) and K4/K5 (global queries)
# ---------------------------------------------------------------------------
# (Hp, Wp, heads, ws): L 49 (padded to 64 keys), 196 (four query tiles), 64, 256
DOT_SHAPES = {"ws7": (14, 21, 3, 7), "ws14": (14, 14, 2, 14), "ws8": (16, 8, 2, 8),
              "ws16": (16, 16, 1, 16)}


def _dot_inputs(device, dtype, shape, parts, with_bias=True, b=3, seed=5):
    hp, wp, heads, ws = DOT_SHAPES[shape]
    rng = np.random.default_rng(seed)
    c, L = heads * 32, ws * ws

    def tensor(*size):
        return torch.from_numpy(rng.normal(size=size).astype(np.float32)).to(device)

    proj = tensor(b, hp, wp, parts * c).to(dtype)
    qg = tensor(b, L, c).to(dtype) if parts == 2 else None
    scale = torch.full((heads,), 32 ** -0.5, device=device)
    bias = tensor(heads, L, L) if with_bias else None
    dout = tensor(b, hp, wp, c).to(dtype)
    return proj, qg, scale, bias, dout, ws, heads


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(DOT_SHAPES))
@pytest.mark.parametrize("mode", ["bias", "nobias", "global"])
def test_window_attention_kernels_match_plain(cuda_device, dtype, atol, shape, mode):
    parts = 2 if mode == "global" else 3
    proj, qg, scale, bias, _, ws, heads = _dot_inputs(cuda_device, dtype, shape, parts,
                                                      mode != "nobias")
    before = dict(dot.LAUNCHES)
    if mode == "global":
        got = dot.window_attention_global_fwd_cuda(proj, qg, scale, bias, ws, heads)
        ref = dot.window_attention_global_fwd_plain(proj, qg, scale, bias, ws, heads)
        kernel = dot.KERNEL_GLOBAL
    else:
        got = dot.window_attention_fwd_cuda(proj, scale, bias, ws, heads)
        ref = dot.window_attention_fwd_plain(proj, scale, bias, ws, heads)
        kernel = dot.KERNEL
    torch.cuda.synchronize()
    assert dot.LAUNCHES[kernel] == before.get(kernel, 0) + 1
    assert got.dtype == dtype and got.shape == ref.shape
    assert (got.float() - ref.float()).abs().max().item() <= atol


# dqkv/dkv are rounded to the input dtype; dqg and dbias are f32 sums in both
# versions, in another order (in bf16 a few dls entries round to neighbouring
# values, hence 2^-8 for dqg). Each is held to a fraction of the reference's
# largest magnitude.
@pytest.mark.parametrize("dtype,rel", [(torch.float32, (1e-4, 1e-4, 1e-3)),
                                       (torch.bfloat16, (2e-2, 2.0 ** -8, 1e-3))],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(DOT_SHAPES))
@pytest.mark.parametrize("mode", ["bias", "nobias", "global"])
def test_window_attention_bwd_kernels_match_plain(cuda_device, dtype, rel, shape, mode):
    parts = 2 if mode == "global" else 3
    proj, qg, scale, bias, dout, ws, heads = _dot_inputs(cuda_device, dtype, shape, parts,
                                                         mode != "nobias", b=5)
    if mode == "global":
        def run(fn):
            return fn(proj, qg, scale, bias, dout, ws, heads)
        got, again = (run(dot.window_attention_global_bwd_cuda) for _ in range(2))
        ref = run(dot.window_attention_global_bwd_plain)
        tols = rel
    else:
        def run(fn):
            return tuple(t for t in fn(proj, scale, bias, dout, ws, heads) if t is not None)
        got, again = (run(dot.window_attention_bwd_cuda) for _ in range(2))
        ref = run(dot.window_attention_bwd_plain)
        tols = (rel[0], rel[2])
        assert len(got) == (2 if mode == "bias" else 1)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[0].shape == proj.shape
    for g, a, r, tol in zip(got, again, ref, tols):
        assert torch.equal(g, a)  # no atomics: bit-identical from run to run
        assert g.shape == r.shape
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


def test_window_attention_autograd_sends_cuda_tensors_to_the_kernels(cuda_device):
    proj, qg, scale, bias, _, ws, heads = _dot_inputs(cuda_device, torch.bfloat16, "ws7", 2)
    qkv = _dot_inputs(cuda_device, torch.bfloat16, "ws7", 3)[0].requires_grad_(True)
    proj.requires_grad_(True)
    qg = qg.float().requires_grad_(True)  # f32 queries, as the model's query generator gives
    bias.requires_grad_(True)
    before = dict(dot.LAUNCHES)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = dot.window_attention_spatial(qkv, scale, bias, ws, heads) \
            + dot.window_attention_spatial(proj, scale, bias, ws, heads, q_global=qg)
        # a strided f32 gradient, as a following op may hand over
        out.float().transpose(1, 2).square().sum().backward()
    torch.cuda.synchronize()
    launched = {k: n - before.get(k, 0) for k, n in dot.LAUNCHES.items() if n > before.get(k, 0)}
    assert launched == dict.fromkeys(dot.KERNELS, 1)
    assert qkv.grad.dtype == proj.grad.dtype == torch.bfloat16
    assert qg.grad.dtype == torch.float32 and qg.grad.shape == qg.shape
    assert bias.grad.shape == bias.shape
    assert all(bool(torch.isfinite(t.grad).all()) for t in (qkv, proj, qg, bias))
    with torch.inference_mode():
        assert dot.window_attention_spatial(qkv, scale, None, ws, heads).grad_fn is None


def test_window_attention_kernels_refuse_what_they_do_not_take(cuda_device):
    proj, qg, scale, bias, dout, ws, heads = _dot_inputs(cuda_device, torch.float32, "ws7", 2)
    with pytest.raises(TypeError):
        dot.window_attention_global_fwd_cuda(proj.half(), qg.half(), scale, bias, ws, heads)
    with pytest.raises(TypeError, match="q_global"):
        dot.window_attention_global_fwd_cuda(proj, qg.bfloat16(), scale, bias, ws, heads)
    with pytest.raises(ValueError, match="head dim"):
        dot.window_attention_global_bwd_cuda(proj, qg, scale[:2], bias[:2], dout, ws, 2)
    with pytest.raises(ValueError, match="multiples of ws"):
        dot.window_attention_fwd_cuda(torch.zeros((1, 15, 14, 96), device=cuda_device),
                                      scale[:1], None, 7, 1)
    with pytest.raises(ValueError, match="dout has shape"):
        dot.window_attention_global_bwd_cuda(proj, qg, scale, bias, dout[:1], ws, heads)
