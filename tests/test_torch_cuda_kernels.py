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
# K1/K2 at every SwinV2 window size: (Hp, Wp, heads, ws), a 2 x 2 window grid;
# L 36, 144 and 256 on the register-tile kernels (64 is above), 576 on the
# key-tiled path (f32; bf16 K2 takes the tensor-core kernel at every L); an odd
# L (ws 7, 49) reads its bias without 16-byte alignment
# ---------------------------------------------------------------------------
SWIN_SHAPES = {"ws6": (12, 12, 2, 6), "ws12": (24, 24, 3, 12), "ws16": (32, 32, 2, 16),
               "ws24": (48, 48, 2, 24), "ws7": (14, 14, 2, 7)}


def _swin_inputs(device, dtype, shape, masked, b=2, seed=11):
    hp, wp, heads, ws = SWIN_SHAPES[shape]
    rng = np.random.default_rng(seed)
    L = ws * ws
    qkv = 0.5 * rng.normal(size=(b, hp, wp, 3 * heads * 32)).astype(np.float32)
    scale = np.exp(np.minimum(np.log(10.0) + rng.normal(size=heads), np.log(100.0)))
    bias = 16.0 / (1.0 + np.exp(-rng.normal(size=(heads, L, L))))
    dout = rng.normal(size=(b, hp, wp, heads * 32)).astype(np.float32)
    mask = shift_window_mask(hp, wp, ws, ws // 2).to(device) if masked else None
    return (torch.from_numpy(qkv).to(device, dtype), torch.from_numpy(scale).float().to(device),
            torch.from_numpy(bias).float().to(device), mask,
            torch.from_numpy(dout).to(device, dtype), ws, heads)


@pytest.mark.parametrize("dtype,atol,rel", [(torch.float32, 1e-4, (1e-4, 1e-3, 1e-3)),
                                            (torch.bfloat16, 2e-2, (2e-2, 1e-3, 1e-3))],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SWIN_SHAPES))
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_swin_attention_kernels_match_plain_at_every_window_size(cuda_device, dtype, atol, rel,
                                                                 shape, masked):
    qkv, scale, bias, mask, dout, ws, heads = _swin_inputs(cuda_device, dtype, shape, masked)
    L = ws * ws
    before = dict(ops.LAUNCHES)
    out = ops.swin_attention_fwd_cuda(qkv, scale, bias, mask, ws, heads)
    out_ref = ops.swin_attention_fwd_plain(qkv, scale, bias, mask, ws, heads)
    got = ops.swin_attention_bwd_cuda(qkv, scale, bias, mask, dout, ws, heads)
    again = ops.swin_attention_bwd_cuda(qkv, scale, bias, mask, dout, ws, heads)
    ref = ops.swin_attention_bwd_plain(qkv, scale, bias, mask, dout, ws, heads)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[ops.KERNEL] == before.get(ops.KERNEL, 0) + 1
    assert ops.LAUNCHES[ops.KERNEL_BWD] == before.get(ops.KERNEL_BWD, 0) + 2
    assert out.dtype == dtype and out.shape == out_ref.shape
    assert (out.float() - out_ref.float()).abs().max().item() <= atol
    assert got[0].shape == qkv.shape and got[1].shape == (heads, L, L) and got[2].shape == (heads,)
    for g, a, r, tol in zip(got, again, ref, rel):
        assert torch.equal(g, a)  # no atomics: bit-identical from run to run
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


@pytest.mark.parametrize("dtype,rel", [(torch.float32, (1e-4, 1e-3, 1e-3)),
                                       (torch.bfloat16, (2e-2, 1e-3, 1e-3))], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ["ws6", "ws8", "ws16", "ws24"])
def test_swin_attention_bwd_kernel_sums_several_images_per_block(cuda_device, shape, dtype, rel,
                                                                 monkeypatch):
    """Five images, three to a block (the last slice ragged). f32: the
    templates' dbias sums in registers (ws 6, 8) and in slabs (ws 16) and the
    key-tiled path's (ws 24); bf16: the tensor-core kernel's dbias columns
    in shared memory across the images of a dk/dv block. The dscale slots
    cross images too; bit-equal twice."""
    if shape == "ws8":
        qkv, scale, bias, mask = _inputs(cuda_device, dtype, True, b=5)
        dout, ws, heads = _dout(cuda_device, dtype, b=5), 8, 6
    else:
        qkv, scale, bias, mask, dout, ws, heads = _swin_inputs(cuda_device, dtype, shape, True,
                                                               b=5)
    monkeypatch.setattr(ops, "_images_per_block", lambda *args: 3)
    assert ops.backward_scratch(5, 4, heads, ws, dtype, cuda_device).images_per_block == 3
    got = ops.swin_attention_bwd_cuda(qkv, scale, bias, mask, dout, ws, heads)
    again = ops.swin_attention_bwd_cuda(qkv, scale, bias, mask, dout, ws, heads)
    ref = ops.swin_attention_bwd_plain(qkv, scale, bias, mask, dout, ws, heads)
    torch.cuda.synchronize()
    for g, a, r, tol in zip(got, again, ref, rel):
        assert torch.equal(g, a)
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


@pytest.mark.parametrize("shape", ["ws6", "ws8", "ws12", "ws16", "ws24"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_swin_attention_bwd_routes_bf16_to_the_tensor_core_kernel(cuda_device, shape, masked):
    """bf16 reaches the tensor-core kernel at every L (36 to 576), f32 the
    FMA kernels, by the launches counted per route."""
    if shape == "ws8":
        args = _inputs(cuda_device, torch.bfloat16, masked) + (_dout(cuda_device, torch.bfloat16),
                                                               8, 6)
    else:
        args = _swin_inputs(cuda_device, torch.bfloat16, shape, masked)
    ws = args[5]
    before = dict(ops.ROUTE_LAUNCHES)
    ops.swin_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert ops.ROUTE_LAUNCHES["mma"] == before.get("mma", 0) + 1
    assert sum(ops.ROUTE_LAUNCHES.values()) == sum(before.values()) + 1
    assert ops.backward_route(torch.bfloat16, ws) == "mma"
    f32_route = "tiled" if ws * ws > 256 else "templates"
    assert ops.backward_route(torch.float32, ws) == f32_route


@pytest.mark.parametrize("shape", ["ws6", "ws8", "ws12", "ws16", "ws24"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_swin_attention_fwd_routes_bf16_to_the_tensor_core_kernel(cuda_device, shape, masked):
    """bf16 K1 reaches the tensor-core kernel at every L (36 to 576), within
    2e-2 of the plain version and bit-equal twice; f32 stays on the FMA
    kernels (the templates, or the key-tiled path above L = 256), by the
    launches counted per route."""
    if shape == "ws8":
        qkv, scale, bias, mask = _inputs(cuda_device, torch.bfloat16, masked)
        ws, heads = 8, 6
    else:
        qkv, scale, bias, mask, _, ws, heads = _swin_inputs(cuda_device, torch.bfloat16, shape,
                                                            masked)
    before = dict(ops.FWD_ROUTE_LAUNCHES)
    got = ops.swin_attention_fwd_cuda(qkv, scale, bias, mask, ws, heads)
    again = ops.swin_attention_fwd_cuda(qkv, scale, bias, mask, ws, heads)
    ref = ops.swin_attention_fwd_plain(qkv, scale, bias, mask, ws, heads)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # no atomics: bit-identical from run to run
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert ops.FWD_ROUTE_LAUNCHES["mma"] == before.get("mma", 0) + 2
    assert sum(ops.FWD_ROUTE_LAUNCHES.values()) == sum(before.values()) + 2
    assert ops.forward_route(torch.bfloat16, ws) == "mma"
    f32_route = "tiled" if ws * ws > 256 else "templates"
    assert ops.forward_route(torch.float32, ws) == f32_route
    ops.swin_attention_fwd_cuda(qkv.float(), scale, bias, mask, ws, heads)
    assert ops.FWD_ROUTE_LAUNCHES[f32_route] == before.get(f32_route, 0) + 1


@pytest.mark.parametrize("images", [1, 2])
@pytest.mark.parametrize("shape", ["ws6", "ws8", "ws12", "ws16", "ws24"])
def test_swin_attention_fwd_kernel_takes_several_images_per_block(cuda_device, shape, images,
                                                                  monkeypatch):
    """bf16 K1 with five images, one or two to a block (with two, the last
    block takes one): a block's warps take their rows of each image in turn
    against the same bias tiles; within 2e-2 of the plain version,
    bit-equal twice."""
    if shape == "ws8":
        qkv, scale, bias, mask = _inputs(cuda_device, torch.bfloat16, True, b=5)
        ws, heads = 8, 6
    else:
        qkv, scale, bias, mask, _, ws, heads = _swin_inputs(cuda_device, torch.bfloat16, shape,
                                                            True, b=5)
    monkeypatch.setattr(ops, "_FWD_IMAGES", images)
    plan = ops.forward_scratch(5, qkv.shape[1], qkv.shape[2], heads, ws)
    assert plan.images_per_block == images and plan.grid[2] == -(-5 // images)
    got = ops.swin_attention_fwd_cuda(qkv, scale, bias, mask, ws, heads)
    again = ops.swin_attention_fwd_cuda(qkv, scale, bias, mask, ws, heads)
    ref = ops.swin_attention_fwd_plain(qkv, scale, bias, mask, ws, heads)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


def _swinv2_names():
    from torchok_tpu_torch.models.backbones.swin import _VARIANTS
    return sorted(_VARIANTS)


@pytest.mark.parametrize("name", _swinv2_names())
def test_every_swinv2_variant_runs_its_forward_through_k1(cuda_device, name):
    """Each registered SwinV2 variant at its own input size, batch 1, bf16:
    one K1 launch per block (window sizes 6 to 24), no plain call."""
    from torchok_tpu_torch.constructor import BACKBONES
    from torchok_tpu_torch.models.backbones.swin import _VARIANTS
    cfg = _VARIANTS[name]
    size = cfg.get("img_size", 256)
    torch.manual_seed(0)
    model = BACKBONES.get(name)().to(cuda_device).eval()
    image = torch.randn((1, 3, size, size), device=cuda_device)
    ops.LAUNCHES.clear()
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
        feat = model(image)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    assert counts == {ops.KERNEL: sum(cfg["depths"])}
    assert feat.shape == (1, model.out_channels, size // 32, size // 32)
    assert bool(torch.isfinite(feat).all())


# ---------------------------------------------------------------------------
# plain (dot-product) window attention: K3 (local) and K4/K5 (global queries)
# ---------------------------------------------------------------------------
# (Hp, Wp, heads, ws): L 49 (padded to 64 keys), 196 (four query tiles), 64, 256
DOT_SHAPES = {"ws7": (14, 21, 3, 7), "ws14": (14, 14, 2, 14), "ws8": (16, 8, 2, 8),
              "ws16": (16, 16, 1, 16)}


# (Hp, Wp, heads, ws) of gcvit_tiny's four stages at 224x224 (local and
# global blocks) and davit_t's (spatial blocks, no bias)
STAGE_SHAPES = {"gcvit1": (56, 56, 2, 7), "gcvit2": (28, 28, 4, 7), "gcvit3": (14, 14, 8, 14),
                "gcvit4": (7, 7, 16, 7), "davit1": (56, 56, 3, 7), "davit2": (28, 28, 6, 7),
                "davit3": (14, 14, 12, 7), "davit4": (7, 7, 24, 7)}


def _dot_inputs(device, dtype, shape, parts, with_bias=True, b=3, seed=5):
    hp, wp, heads, ws = {**DOT_SHAPES, **STAGE_SHAPES}[shape]
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


# bf16 as chip_smoke.DOT_BWD_TOLERANCE: dproj, dqg, dbias, each a fraction
# of the reference's largest magnitude
DOT_BWD_BF16 = (2e-2, 2.0 ** -8, 1e-3)


def _stage_inputs(device, stage, mode, b=4, dtype=torch.bfloat16):
    """Inputs at a gcvit_tiny or davit_t stage shape; ``mode`` bias, nobias
    or global."""
    return _dot_inputs(device, dtype, stage, 2 if mode == "global" else 3, mode != "nobias", b,
                       seed=8)


def _dot_bwd(fn_local, fn_global, proj, qg, scale, bias, dout, ws, heads):
    """(dproj, dqg or None, dbias or None) of a local or global backward."""
    if qg is None:
        dqkv, dbias = fn_local(proj, scale, bias, dout, ws, heads)
        return dqkv, None, dbias
    return fn_global(proj, qg, scale, bias, dout, ws, heads)


def _dot_bwd_ratios(got, ref, tols):
    """Each output's largest error over its tolerance (a fraction of the
    reference's largest magnitude); None where there is no output."""
    return [None if g is None else (g.float() - r.float()).abs().max().item()
            / (tol * r.float().abs().max().item()) for g, r, tol in zip(got, ref, tols)]


def _dot_bwd_within(got, ref, tols):
    """Whether every output of ``got`` lies within its tolerance of ``ref``."""
    return all(x is None or x <= 1.0 for x in _dot_bwd_ratios(got, ref, tols))


STAGE_CASES = [(stage, mode) for stage in STAGE_SHAPES if stage.startswith("gcvit")
               for mode in ("bias", "global")] + \
    [(stage, "nobias") for stage in STAGE_SHAPES if stage.startswith("davit")]


@pytest.mark.parametrize("stage,mode", STAGE_CASES)
def test_window_attention_bwd_bf16_takes_the_tensor_cores_at_every_stage(cuda_device, stage,
                                                                        mode):
    """bf16 K3b (gcvit_tiny's local blocks with a bias, davit_t's without)
    and K5 (gcvit_tiny's global blocks) at every stage shape: the
    tensor-core route by the launches counted per route, bit-equal twice,
    within the card's tolerances of the plain versions."""
    args = _stage_inputs(cuda_device, stage, mode)
    kernel = dot.KERNEL_GLOBAL_BWD if mode == "global" else dot.KERNEL_BWD
    before = dict(dot.ROUTE_LAUNCHES)
    got = _dot_bwd(dot.window_attention_bwd_cuda, dot.window_attention_global_bwd_cuda, *args)
    again = _dot_bwd(dot.window_attention_bwd_cuda, dot.window_attention_global_bwd_cuda, *args)
    ref = _dot_bwd(dot.window_attention_bwd_plain, dot.window_attention_global_bwd_plain, *args)
    torch.cuda.synchronize()
    assert dot.ROUTE_LAUNCHES[(kernel, "mma")] == before.get((kernel, "mma"), 0) + 2
    assert sum(dot.ROUTE_LAUNCHES.values()) == sum(before.values()) + 2
    assert dot.backward_route(kernel, torch.bfloat16) == "mma"
    for g, a in zip(got, again):
        assert (g is None) == (a is None) and (g is None or torch.equal(g, a))
    assert got[0].dtype == torch.bfloat16 and got[0].shape == args[0].shape
    assert (got[2] is None) == (mode == "nobias")
    assert _dot_bwd_within(got, ref, DOT_BWD_BF16)


@pytest.mark.parametrize("mode", ["bias", "nobias", "global"])
def test_window_attention_bwd_f32_stays_on_the_template(cuda_device, mode):
    """f32 K3b and K5 take the FMA template, by the launches counted per
    route and by the route the library reports."""
    args = _stage_inputs(cuda_device, "gcvit2" if mode != "nobias" else "davit2", mode, b=2,
                         dtype=torch.float32)
    kernel = dot.KERNEL_GLOBAL_BWD if mode == "global" else dot.KERNEL_BWD
    before = dict(dot.ROUTE_LAUNCHES)
    got = _dot_bwd(dot.window_attention_bwd_cuda, dot.window_attention_global_bwd_cuda, *args)
    ref = _dot_bwd(dot.window_attention_bwd_plain, dot.window_attention_global_bwd_plain, *args)
    torch.cuda.synchronize()
    assert dot.ROUTE_LAUNCHES[(kernel, "templates")] == before.get((kernel, "templates"), 0) + 1
    assert sum(dot.ROUTE_LAUNCHES.values()) == sum(before.values()) + 1
    assert dot.backward_route(kernel, torch.float32) == "templates"
    assert _dot_bwd_within(got, ref, (1e-4, 1e-4, 1e-3))


# the global dq pass's window start; the planted fault below starts dq anew
# at every window, so that dqg keeps only the last window's dq
_DQ_WINDOW_START = "    if (within == 0) {  // a window's first step: its do rows have landed\n"
_DQ_LAST_WINDOW_ONLY = _DQ_WINDOW_START + (
    "      if (kGlobal)\n"
    "        for (int n = 0; n < 4; ++n)\n"
    "          for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;\n")


def _build_with_dqg_fault(out_dir):
    """window_attention_global_bwd built from a copy of the sources whose
    dqg keeps only the last window's dq; its ``extern "C"`` entry."""
    import ctypes
    import shutil
    import subprocess
    from torchok_tpu_torch.utils.cuda_build import CSRC, NVCC_FLAGS, find_nvcc
    src = out_dir / "csrc"
    shutil.copytree(CSRC, src)
    header = src / "swin_attention_bwd_mma.cuh"
    text = header.read_text()
    assert text.count(_DQ_WINDOW_START) == 1
    header.write_text(text.replace(_DQ_WINDOW_START, _DQ_LAST_WINDOW_ONLY))
    lib = out_dir / "libfault.so"
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib),
                    str(src / f"{dot.KERNEL_GLOBAL_BWD}.cu")], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), dot.KERNEL_GLOBAL_BWD)
    fn.argtypes = dot._ARGTYPES[dot.KERNEL_GLOBAL_BWD]
    fn.restype = ctypes.c_int
    return fn


def test_window_attention_global_bwd_check_sees_a_wrong_window_sum(cuda_device, tmp_path,
                                                                   monkeypatch):
    """A K5 whose dqg keeps only the last window's dq (the fault planted in a
    copy of the header) fails the bf16 check at gcvit_tiny's stages with
    several windows, which the package's K5 passes on the same inputs."""
    fault = _build_with_dqg_fault(tmp_path)
    function = dot._function
    for stage in ("gcvit1", "gcvit2"):
        args = _stage_inputs(cuda_device, stage, "global", b=2)
        ref = _dot_bwd(None, dot.window_attention_global_bwd_plain, *args)
        assert _dot_bwd_within(_dot_bwd(None, dot.window_attention_global_bwd_cuda, *args), ref,
                               DOT_BWD_BF16)
        monkeypatch.setattr(dot, "_function",
                            lambda name: fault if name == dot.KERNEL_GLOBAL_BWD else function(name))
        got = _dot_bwd(None, dot.window_attention_global_bwd_cuda, *args)
        monkeypatch.setattr(dot, "_function", function)
        torch.cuda.synchronize()
        ratios = _dot_bwd_ratios(got, ref, DOT_BWD_BF16)
        print(f"{stage} with the fault planted: error over tolerance of dkv, dqg, dbias "
              f"{ratios}")
        assert not _dot_bwd_within(got, ref, DOT_BWD_BF16)
        # dkv and dbias do not hang on the fault
        assert _dot_bwd_within((got[0], None, got[2]), ref, DOT_BWD_BF16)


# ---------------------------------------------------------------------------
# K6: cosine window attention on pre-partitioned head-major windows
# ---------------------------------------------------------------------------
def _mw_inputs(device, dtype, L, d, n_mask, b=3, nw=4, heads=3, seed=6):
    rng = np.random.default_rng(seed)

    def tensor(*size, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=size)).astype(np.float32)).to(device)

    q, k, v = (tensor(b * nw, heads, L, d).to(dtype) for _ in range(3))
    logit_scale = tensor(heads) + float(np.log(10.0))
    bias = tensor(heads, L, L)
    rows = {"none": 0, "one": 1, "compact": nw, "tiled": b * nw}[n_mask]
    mask = -100.0 * (tensor(rows, L, L) > 1.0).float() if rows else None
    return q, k, v, logit_scale, bias, mask


# the kernel and its plain version are f32 throughout and round once; in bf16
# a different summation order moves an output by at most one bf16 ulp (2^-8
# of |out| <= max|v| ~ 4)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L,d", [(64, 32), (16, 8), (64, 8), (16, 32)])
@pytest.mark.parametrize("n_mask", ["none", "one", "compact", "tiled"])
def test_window_attention_mw_kernel_matches_plain(cuda_device, dtype, atol, L, d, n_mask):
    from torchok_tpu_torch.ops import window_attention as wa
    args = _mw_inputs(cuda_device, dtype, L, d, n_mask)
    before = ops.LAUNCHES[wa.KERNEL]
    got = wa.window_attention_mw_cuda(*args)
    ref = wa.window_attention_mw_plain(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[wa.KERNEL] == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    assert (got.float() - ref.float()).abs().max().item() <= atol
    # against the einsum formulation (unit vectors rounded to the input type,
    # x / (|x| + eps)): 2e-4 in f32, as the JAX package holds its kernel
    if dtype == torch.float32:
        xla = wa.window_attention_einsum(*args)
        assert (got - xla).abs().max().item() <= 2e-4


def test_window_attention_hybrid_on_the_card(cuda_device):
    from torchok_tpu_torch.ops import window_attention as wa
    q, k, v, logit_scale, bias, mask = _mw_inputs(cuda_device, torch.float32, 64, 32, "compact")
    blhd = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    logit_scale.requires_grad_(True)
    bias.requires_grad_(True)
    before = dict(ops.LAUNCHES)
    out = wa.window_attention(*blhd, logit_scale, bias, mask, True, layout="blhd")
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[wa.KERNEL] == before.get(wa.KERNEL, 0) + 1
    assert ops.LAUNCHES[wa.PLAIN] == before.get(wa.PLAIN, 0)
    got = [t.grad.clone() for t in (*blhd, logit_scale, bias)]
    for t in (*blhd, logit_scale, bias):
        t.grad = None
    ref_out = wa.window_attention(*blhd, logit_scale, bias, mask, False, layout="blhd")
    ref_out.square().sum().backward()
    assert out.shape == ref_out.shape == blhd[0].shape
    # the backward is the einsum formulation's in both; the cotangent 2*out
    # differs by the forward's 2e-4
    for g, t in zip(got, (*blhd, logit_scale, bias)):
        assert (g - t.grad).abs().max().item() <= 1e-3 * max(1.0, t.grad.abs().max().item())


def test_window_attention_mw_kernel_refuses_what_it_does_not_take(cuda_device):
    from torchok_tpu_torch.ops import window_attention as wa
    q, k, v, logit_scale, bias, mask = _mw_inputs(cuda_device, torch.float32, 16, 8, "compact")
    with pytest.raises(TypeError):
        wa.window_attention_mw_cuda(q.half(), k.half(), v.half(), logit_scale, bias, mask)
    with pytest.raises(ValueError, match="contiguous"):
        wa.window_attention_mw_cuda(q, k.transpose(0, 1).contiguous().transpose(0, 1), v,
                                    logit_scale, bias, mask)
    with pytest.raises(ValueError, match="head dim"):
        wa.window_attention_mw_cuda(q[..., :4].contiguous(), k[..., :4].contiguous(),
                                    v[..., :4].contiguous(), logit_scale, bias, mask)
    with pytest.raises(ValueError, match="window types"):
        wa.window_attention_mw_cuda(q, k, v, logit_scale, bias, torch.cat([mask, mask[:1]]))


# ---------------------------------------------------------------------------
# K7: 1x1-conv GEMM with fused BatchNorm prologue and statistics
# ---------------------------------------------------------------------------
def _bn_inputs(device, dtype, m, k, n, seed=7):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32)).to(device, dtype)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (k,)).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.normal(0, 0.2, (k,)).astype(np.float32)).to(device)
    return x, w, scale, bias


# y: f32 sums in another order (1e-4 of the largest value), or one bf16 ulp
# (2^-7 of it); s1/s2: rtol 1e-4 / atol 1e-2 as the JAX package's test, the
# atol scaled by the largest |y| for bf16's one-ulp flips
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(256, 128, 128), (200, 64, 256), (130, 128, 128),
                                   (3000, 256, 64), (1, 8, 8), (777, 72, 40)])
@pytest.mark.parametrize("relu_in,with_affine", [(False, False), (True, False), (False, True),
                                                 (True, True)])
def test_matmul_bn_kernel_matches_plain(cuda_device, dtype, rel, m, k, n, relu_in, with_affine):
    from torchok_tpu_torch.ops import conv_bn
    args = _bn_inputs(cuda_device, dtype, m, k, n)
    before = ops.LAUNCHES[conv_bn.KERNEL]
    got = conv_bn.matmul_bn_cuda(*args, relu_in, with_affine)
    again = conv_bn.matmul_bn_cuda(*args, relu_in, with_affine)
    ref = conv_bn.matmul_bn_plain(*args, relu_in, with_affine)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[conv_bn.KERNEL] == before + 2
    assert got[0].dtype == dtype and got[0].shape == (m, n)
    for g, a in zip(got, again):
        assert torch.equal(g, a)  # no atomics: bit-identical from run to run
    top = ref[0].float().abs().max().item()
    assert (got[0].float() - ref[0].float()).abs().max().item() <= rel * top
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == torch.float32 and g.shape == (n,)
        assert bool(((g - r).abs() <= 1e-4 * r.abs() + 1e-2 * max(1.0, top)).all())


def test_matmul_bn_autograd_on_the_card(cuda_device):
    from torchok_tpu_torch.ops import conv_bn
    x, w, scale, bias = _bn_inputs(cuda_device, torch.float32, 192, 64, 128)
    cw = torch.linspace(-1, 1, 128, device=cuda_device)

    def loss(fn, *leaves):
        y, s1, s2 = fn(*leaves, True, True)
        return (y * cw).sum() + 0.1 * s1.sum() + 0.01 * s2.sum()

    leaves = [t.clone().requires_grad_(True) for t in (x, w, scale, bias)]
    before = dict(ops.LAUNCHES)
    loss(conv_bn.matmul_bn, *leaves).backward()
    assert ops.LAUNCHES[conv_bn.KERNEL] == before.get(conv_bn.KERNEL, 0) + 1
    assert ops.LAUNCHES[conv_bn.PLAIN] == before.get(conv_bn.PLAIN, 0)
    ref = [t.clone().requires_grad_(True) for t in (x, w, scale, bias)]
    loss(conv_bn.matmul_bn_plain, *ref).backward()  # autograd through the plain version
    for a, b in zip(leaves, ref):
        assert (a.grad - b.grad).abs().max().item() <= 2e-3 * max(1.0, b.grad.abs().max().item())


def test_matmul_bn_kernel_refuses_what_it_does_not_take(cuda_device):
    from torchok_tpu_torch.ops import conv_bn
    x, w, scale, bias = _bn_inputs(cuda_device, torch.float32, 64, 64, 64)
    with pytest.raises(TypeError):
        conv_bn.matmul_bn_cuda(x.half(), w.half(), scale, bias)
    with pytest.raises(TypeError, match="w must be"):
        conv_bn.matmul_bn_cuda(x, w.bfloat16(), scale, bias)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_bn.matmul_bn_cuda(x[:, :60].contiguous(), w[:60].contiguous(), scale[:60], bias[:60])
    with pytest.raises(ValueError, match="contiguous"):
        conv_bn.matmul_bn_cuda(x.t().contiguous().t(), w, scale, bias)
    with pytest.raises(ValueError, match="scale has shape"):
        conv_bn.matmul_bn_cuda(x, w, scale[:8], bias)


# ---------------------------------------------------------------------------
# K8: 3x3 conv as an implicit GEMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 9, 9, 16, 16), (2, 8, 8, 24, 24), (3, 7, 7, 64, 128),
                                   (2, 14, 14, 256, 256), (1, 1, 1, 8, 8), (5, 3, 11, 40, 72)])
def test_conv3x3_gemm_kernel_matches_plain_and_conv2d(cuda_device, dtype, rel, shape):
    from torchok_tpu_torch.ops import conv_gemm
    n, h, w_, cin, cout = shape
    rng = np.random.default_rng(8)
    x = torch.from_numpy((0.5 * rng.normal(size=(n, h, w_, cin))).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.normal(size=(3, 3, cin, cout))).astype(np.float32))
    x, w = x.to(cuda_device, dtype), w.to(cuda_device, dtype)
    before = ops.LAUNCHES[conv_gemm.KERNEL]
    got = conv_gemm.conv3x3_gemm(x, w)
    ref = conv_gemm.conv3x3_gemm_plain(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[conv_gemm.KERNEL] == before + 1
    assert got.dtype == dtype and got.shape == (n, h, w_, cout)
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= rel * top
    torch.backends.cudnn.allow_tf32 = False
    lib = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                                     padding=1).permute(0, 2, 3, 1)
    assert (got.float() - lib).abs().max().item() <= max(rel, 1e-4) * top


def test_conv3x3_gemm_kernel_refuses_what_it_does_not_take(cuda_device):
    from torchok_tpu_torch.ops import conv_gemm
    x = torch.zeros((2, 8, 8, 16), device=cuda_device)
    w = torch.zeros((3, 3, 16, 16), device=cuda_device)
    with pytest.raises(TypeError):
        conv_gemm.conv3x3_gemm_cuda(x.half(), w.half())
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_gemm.conv3x3_gemm_cuda(x[..., :12].contiguous(), w[:, :, :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        conv_gemm.conv3x3_gemm_cuda(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match=r"\(3, 3, Cin, Cout\)"):
        conv_gemm.conv3x3_gemm_cuda(x, w[:2])


# the bf16 path (wgmma): ResNet-50's four 3x3 shapes at batch 256, a ragged
# M (not a multiple of the 128-row tile), Cout 64 (128 x 64 tiles) and 512,
# Cin narrower than a 64-channel slab
@pytest.mark.parametrize("shape", [(256, 56, 56, 64, 64), (256, 28, 28, 128, 128),
                                   (256, 14, 14, 256, 256), (256, 7, 7, 512, 512),
                                   (3, 13, 11, 64, 128), (2, 10, 10, 128, 64),
                                   (2, 7, 7, 256, 512), (2, 9, 9, 24, 40)],
                         ids=["r50_56", "r50_28", "r50_14", "r50_7", "ragged_m", "cout64",
                              "cout512", "narrow"])
def test_conv3x3_gemm_bf16_path_is_one_ulp_and_bit_equal_twice(cuda_device, shape):
    from torchok_tpu_torch.ops import conv_gemm
    n, h, w_, cin, cout = shape
    g = torch.Generator(device=cuda_device)
    g.manual_seed(12)
    x = (0.5 * torch.randn((n, h, w_, cin), generator=g, device=cuda_device)).bfloat16()
    w = (0.05 * torch.randn((3, 3, cin, cout), generator=g, device=cuda_device)).bfloat16()
    got = conv_gemm.conv3x3_gemm_cuda(x, w)
    again = conv_gemm.conv3x3_gemm_cuda(x, w)
    ref = conv_gemm.conv3x3_gemm_plain(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    top = ref.float().abs().max().item()
    # f32 sums in another order: at most one bf16 ulp of the largest |y|
    assert (got.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * top
    torch.backends.cudnn.allow_tf32 = False
    lib = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2),
                                     w.float().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    assert (got.float() - lib).abs().max().item() <= 2.0 ** -7 * top


def test_conv3x3_gemm_bf16_path_runs_wgmma(cuda_device):
    """The built library's SASS holds HGMMA, Hopper's warpgroup MMA."""
    import shutil
    import subprocess
    from torchok_tpu_torch.ops import conv_gemm
    from torchok_tpu_torch.utils.cuda_build import library_path, load_library
    load_library(conv_gemm.KERNEL)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library_path(conv_gemm.KERNEL))],
                          capture_output=True, text=True, check=True).stdout
    assert "HGMMA" in sass


# ---------------------------------------------------------------------------
# K9: one inference MBConv block, fused
# ---------------------------------------------------------------------------
# (N, H, W, C, mid, rd, k): the probe's two shapes at batch 256 and
# EfficientNet-B0's nine blocks of the kernel's form (ir, stride 1, C in = C
# out, SE; rd from C / 4; five distinct shapes) at batch 8, then ragged and
# small ones: "ragged" has mid 40 (not a multiple of 16), "ragged_strips" four
# strips of 6 rows, the last of 5, at W 23, "k7_strips" eight strips, the last
# of 3 rows, at k 7, W 45 and C 24 (channels padded to 32), "c24_9x9" C 24 in
# one block of 9 rows, "mid384_28" a bf16 image that takes the three launches
# (4 strips of 7 rows do not fit a block, 8 strips of 28 rows would leave one
# empty)
MBCONV_SHAPES = {
    "probe_56": (256, 56, 56, 24, 144, 6, 3), "probe_14": (256, 14, 14, 112, 672, 28, 5),
    "b0_1_1": (8, 56, 56, 24, 144, 8, 3), "b0_2_1": (8, 28, 28, 40, 240, 16, 5),
    "b0_3_x": (8, 14, 14, 80, 480, 24, 3), "b0_4_x": (8, 14, 14, 112, 672, 32, 5),
    "b0_5_x": (8, 7, 7, 192, 1152, 48, 5), "ragged": (3, 9, 13, 24, 40, 6, 5),
    "k7": (2, 10, 6, 16, 32, 8, 7), "k1": (2, 5, 11, 8, 16, 4, 1),
    "ragged_strips": (2, 23, 23, 48, 288, 12, 5), "k7_strips": (2, 45, 45, 24, 144, 6, 7),
    "c24_9x9": (3, 9, 9, 24, 96, 6, 5), "mid384_28": (2, 28, 28, 64, 384, 16, 5),
}
# the route each shape takes in bf16 (f32 always takes the three launches),
# and the cluster route's strips
MBCONV_BF16_ROUTE = {shape: ("three_launch" if shape in ("ragged", "mid384_28") else "cluster")
                     for shape in MBCONV_SHAPES}
MBCONV_STRIPS = {"probe_56": 8, "probe_14": 2, "b0_1_1": 8, "b0_2_1": 4, "b0_3_x": 2,
                 "b0_4_x": 2, "b0_5_x": 1, "k7": 1, "k1": 1, "ragged_strips": 4,
                 "k7_strips": 8, "c24_9x9": 1}


def _mbconv_inputs(device, dtype, n, h, w, c, mid, rd, k, seed=9):
    rng = np.random.default_rng(seed)

    def g(*shape, scale=0.05):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(
            device, dtype)
    x = g(n, h, w, c, scale=0.5)
    p = dict(w_exp=g(c, mid), s1=1.0 + g(1, mid), b1=g(1, mid), w_dw=g(k, k, mid, scale=0.3),
             s2=1.0 + g(1, mid), b2=g(1, mid), w_se1=g(mid, rd), b_se1=g(1, rd),
             w_se2=g(rd, mid), b_se2=g(1, mid), w_proj=g(mid, c), s3=1.0 + g(1, c), b3=g(1, c))
    return x, p


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(MBCONV_SHAPES))
def test_mbconv_fused_kernel_matches_plain_and_is_bit_equal_twice(cuda_device, dtype, rel, shape):
    from torchok_tpu_torch.ops import mbconv_fused as mb
    n, h, w, c, mid, rd, k = MBCONV_SHAPES[shape]
    if dtype == torch.float32 and n > 8:
        n = 8  # f32 at the probe's shapes: batch 8, as chip_smoke.py
    x, p = _mbconv_inputs(cuda_device, dtype, n, h, w, c, mid, rd, k)
    want = MBCONV_BF16_ROUTE[shape] if dtype == torch.bfloat16 else "three_launch"
    assert mb.route(h, w, c, mid, rd, k, dtype) == want
    if want == "cluster":
        assert mb.plan_cluster(h, w, c, mid, rd, k).strips == MBCONV_STRIPS[shape]
    before = ops.LAUNCHES[mb.KERNEL]
    routes = dict(mb.ROUTE_LAUNCHES)
    got = mb.mbconv_fused(x, p)
    again = mb.mbconv_fused_cuda(x, p)
    ref = mb.mbconv_fused_plain(x, p)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[mb.KERNEL] == before + 2
    assert mb.ROUTE_LAUNCHES[want] == routes.get(want, 0) + 2
    assert sum(mb.ROUTE_LAUNCHES.values()) == sum(routes.values()) + 2
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    # f32 sums in other orders (f32); in bf16 one ulp where the two f32
    # results fall on either side of a rounding boundary, and on the cluster
    # route the bf16 operands of its products (w_exp, act, gate * w_proj)
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= rel * top


# the shapes above whose cluster holds an image in 2, 4 or 8 strips (ragged
# strips and k 7 among them), at batch 2
MBCONV_SE_SHAPES = ("b0_3_x", "b0_2_1", "b0_1_1", "ragged_strips", "k7_strips")


@pytest.mark.parametrize("shape", MBCONV_SE_SHAPES)
def test_mbconv_fused_cluster_takes_the_se_mean_across_its_strips(cuda_device, shape):
    """bf16 on the cluster route where y hangs on the SE mean over the whole
    image (``tools/probe_torch_mbconv_fused.py::make_se_case``: a strip's own
    mean, the wrong rank's or the wrong count moves y by more than four
    times the tolerance, as a CPU test of the plain version shows), within
    2^-7 x max|y| of the plain version and bit-equal twice."""
    import importlib.util
    from pathlib import Path
    from torchok_tpu_torch.ops import mbconv_fused as mb
    path = Path(__file__).resolve().parent.parent / "tools" / "probe_torch_mbconv_fused.py"
    spec = importlib.util.spec_from_file_location("probe_torch_mbconv_fused", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    _, h, w, c, mid, rd, k = MBCONV_SHAPES[shape]
    assert mb.route(h, w, c, mid, rd, k, torch.bfloat16) == "cluster"
    assert mb.plan_cluster(h, w, c, mid, rd, k).strips == MBCONV_STRIPS[shape] > 1
    x, p = probe.make_se_case(np.random.default_rng(11), 2, h, w, c, mid, rd, k, cuda_device,
                              torch.bfloat16)
    routes = dict(mb.ROUTE_LAUNCHES)
    got = mb.mbconv_fused_cuda(x, p)
    again = mb.mbconv_fused_cuda(x, p)
    ref = mb.mbconv_fused_plain(x, p)
    torch.cuda.synchronize()
    assert mb.ROUTE_LAUNCHES["cluster"] == routes.get("cluster", 0) + 2
    assert torch.equal(got, again)
    top = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * top


def test_mbconv_fused_kernel_reads_a_channels_last_view(cuda_device):
    from torchok_tpu_torch.ops import mbconv_fused as mb
    x, p = _mbconv_inputs(cuda_device, torch.bfloat16, 2, 14, 14, 80, 480, 24, 3)
    nchw = x.permute(0, 3, 1, 2)  # a channels-last NCHW activation
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    view = nchw.permute(0, 2, 3, 1)
    assert view.data_ptr() == x.data_ptr() and view.is_contiguous()
    assert torch.equal(mb.mbconv_fused_cuda(view, p), mb.mbconv_fused_cuda(x, p))


def test_mbconv_fused_kernel_refuses_what_it_does_not_take(cuda_device):
    from torchok_tpu_torch.ops import mbconv_fused as mb
    x, p = _mbconv_inputs(cuda_device, torch.float32, 2, 8, 8, 16, 48, 8, 3)
    with pytest.raises(TypeError):
        mb.mbconv_fused_cuda(x.half(), p)
    with pytest.raises(ValueError, match="contiguous"):
        mb.mbconv_fused_cuda(x.transpose(1, 2), p)
    with pytest.raises(ValueError, match="inference only"):
        mb.mbconv_fused_cuda(x.clone().requires_grad_(True), p)
    with pytest.raises(ValueError, match="odd"):
        mb.mbconv_fused_cuda(x, {**p, "w_dw": torch.zeros((4, 4, 48), device=cuda_device)})


def test_mbconv_fused_cluster_route_runs_mma_sync(cuda_device):
    """The SASS of the cluster route's four instantiations (k = 1, 3, 5, 7)
    holds HMMA, the tensor cores' mma.sync."""
    import shutil
    import subprocess
    from torchok_tpu_torch.ops import mbconv_fused as mb
    from torchok_tpu_torch.utils.cuda_build import library_path, load_library
    load_library(mb.KERNEL)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library_path(mb.KERNEL))],
                          capture_output=True, text=True, check=True).stdout
    parts = [part for part in sass.split("Function : ")[1:]
             if "mbconv_cluster_kernel" in part.split("\n", 1)[0]]
    assert len(parts) == 4 and all("HMMA" in part for part in parts)


def test_mbconv_fused_cluster_plan_bytes_are_the_kernels_layout(cuda_device):
    """``cluster_shared_bytes`` (what the planner fits into a block) equals
    the shared memory the kernel's own layout carves, at every shape here."""
    import ctypes
    from torchok_tpu_torch.ops import mbconv_fused as mb
    from torchok_tpu_torch.utils.cuda_build import load_function
    layout = load_function(mb.KERNEL, [ctypes.c_int] * 8, "mbconv_fused_cluster_bytes")
    shapes = [(h, w, c, mid, rd, k) for _, h, w, c, mid, rd, k in MBCONV_SHAPES.values()]
    for h, w, c, mid, rd, k in shapes + [(57, 57, 24, 144, 6, 3), (3, 5, 8, 16, 4, 7)]:
        cut = mb.plan_cluster(h, w, c, mid, rd, k)
        if cut is not None:
            assert layout(h, w, c, mid, k, cut.rows, cut.chunk, cut.kc) == cut.bytes
            for chunk, kc in ((16, 16), (16, 64), (32, 48)):
                if mid % chunk == 0:
                    assert layout(h, w, c, mid, k, cut.rows, chunk, kc) == \
                        mb.cluster_shared_bytes(h, w, c, mid, k, cut.rows, chunk, kc)
