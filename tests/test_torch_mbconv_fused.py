"""The port's fused inference MBConv block (``torchok_tpu_torch.ops.
mbconv_fused``, K9) against ``pallas_block`` and ``xla_block`` of
``tools/probe_mbconv_fused.py`` on the same numpy inputs, and against the
port's own eval ``InvertedResidual`` with its BatchNorms folded. The probe is
loaded by file path and its Pallas kernel runs in interpret mode (its
module-level ``INTERPRET`` is set here; nothing in ``tools/`` changes); the
port runs the plain version of its CUDA kernel.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu_torch.constructor import BACKBONES
from torchok_tpu_torch.models.backbones.efficientnet_blocks import InvertedResidual
from torchok_tpu_torch.models.backbones.resnet import init_like_flax
from torchok_tpu_torch.ops import mbconv_fused as mb
from torchok_tpu_torch.ops.common import LAUNCHES

REPO = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def probe():
    mp = pytest.MonkeyPatch()
    # the probe sets these at import when they are unset: keep them out of
    # this process's environment afterwards
    mp.setenv("JAX_COMPILATION_CACHE_DIR", "")
    mp.setenv("TORCHOK_PROBE_INTERPRET", "0")
    mp.syspath_prepend(str(REPO))
    try:
        module = _load("probe_mbconv_fused", REPO / "tools" / "probe_mbconv_fused.py")
    finally:
        mp.undo()
    module.INTERPRET = True
    return module


@pytest.fixture(scope="module")
def port_probe():
    return _load("probe_torch_mbconv_fused", REPO / "tools" / "probe_torch_mbconv_fused.py")


def _params(seed, cin, mid, rd, k):
    """The probe's layouts (vectors as (1, C)) with weights large enough to
    move the output and the affine scales near one, as numpy f32."""
    rng = np.random.default_rng(seed)

    def g(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return dict(w_exp=g(cin, mid, scale=0.3), s1=1.0 + g(1, mid), b1=g(1, mid),
                w_dw=g(k, k, mid, scale=0.3), s2=1.0 + g(1, mid), b2=g(1, mid),
                w_se1=g(mid, rd, scale=0.3), b_se1=g(1, rd), w_se2=g(rd, mid, scale=0.3),
                b_se2=g(1, mid), w_proj=g(mid, cin, scale=0.3), s3=1.0 + g(1, cin),
                b3=g(1, cin))


def _x(seed, n, h, w, cin):
    return (np.random.default_rng(100 + seed).normal(size=(n, h, w, cin)) * 0.5).astype(np.float32)


# the probe's two interpret shapes, a non-square image with rd 6, and k 7:
# (n, h, w, cin, mid, rd, k)
CASES = {
    "tiny_8x8_mid48_k3": (2, 8, 8, 16, 48, 8, 3),
    "tiny_9x9_mid40_k5": (2, 9, 9, 24, 40, 8, 5),
    "nonsquare_7x10_rd6": (2, 7, 10, 16, 32, 6, 3),
    "k7_6x9": (1, 6, 9, 8, 24, 6, 7),
}


def _jax(p, dtype):
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


def _torch(p, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_pallas_block_in_f32(probe, case):
    n, h, w, cin, mid, rd, k = CASES[case]
    p = _params(1, cin, mid, rd, k)
    x = _x(1, n, h, w, cin)
    before = LAUNCHES[mb.PLAIN]
    got = mb.mbconv_fused(torch.from_numpy(x), _torch(p)).numpy()
    assert LAUNCHES[mb.PLAIN] == before + 1
    ref = np.asarray(probe.pallas_block(jnp.asarray(x), _jax(p, jnp.float32)))
    assert got.shape == ref.shape == (n, h, w, cin)
    # f32 on both sides, sums in other orders
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_pallas_block_in_bf16(probe, case):
    n, h, w, cin, mid, rd, k = CASES[case]
    p = _params(2, cin, mid, rd, k)
    x = _x(2, n, h, w, cin)
    xb = torch.from_numpy(x).bfloat16()
    got = mb.mbconv_fused(xb, _torch(p, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(probe.pallas_block(jnp.asarray(x, jnp.bfloat16), _jax(p, jnp.bfloat16)),
                     np.float32)
    # bf16 in, f32 inside, one rounding on both sides: one bf16 ulp of the
    # largest output where the two f32 results straddle a rounding boundary
    assert np.abs(got.float().numpy() - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["tiny_8x8_mid48_k3", "tiny_9x9_mid40_k5"])
def test_plain_version_matches_xla_block_at_the_probes_limit(probe, case):
    n, h, w, cin, mid, rd, k = CASES[case]
    p = _params(3, cin, mid, rd, k)
    x = _x(3, n, h, w, cin)
    got = mb.mbconv_fused(torch.from_numpy(x).bfloat16(), _torch(p, torch.bfloat16)).float()
    ref = np.asarray(probe.xla_block(jnp.asarray(x, jnp.bfloat16), _jax(p, jnp.bfloat16)),
                     np.float32)
    # xla_block rounds to bf16 after every op: the probe's own 0.05 relative
    assert np.abs(got.numpy() - ref).max() <= 0.05 * np.abs(ref).max()


def test_the_padding_comes_after_the_activation():
    """A zero input with a bias b1 whose swish is far from 0: the border taps
    of the depthwise conv see 0, not swish(b1)."""
    n, h, w, cin, mid, rd, k = 1, 4, 5, 8, 8, 2, 3
    p = {name: torch.zeros(shape) for name, shape in dict(
        w_exp=(cin, mid), s1=(mid,), b1=(mid,), w_dw=(k, k, mid), s2=(mid,), b2=(mid,),
        w_se1=(mid, rd), b_se1=(rd,), w_se2=(rd, mid), b_se2=(mid,), w_proj=(mid, cin),
        s3=(cin,), b3=(cin,)).items()}
    p["b1"] += 2.0
    p["w_dw"] += 1.0
    p["s2"] += 1.0
    p["w_proj"] = torch.eye(mid, cin)
    p["s3"] += 1.0
    y = mb.mbconv_fused_plain(torch.zeros((n, h, w, cin)), p)
    e = 2.0 * torch.sigmoid(torch.tensor(2.0))          # swish(b1) inside the image
    taps = torch.tensor([[4, 6, 6, 6, 4], [6, 9, 9, 9, 6], [6, 9, 9, 9, 6], [4, 6, 6, 6, 4]])
    d = taps * e
    want = d * torch.sigmoid(d) * 0.5                    # swish, the gate sigmoid(0)
    torch.testing.assert_close(y[0, :, :, 0], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel,cin,size", [(3, 24, 8), (5, 40, 7)])
def test_plain_version_matches_a_folded_inverted_residual(port_probe, kernel, cin, size):
    """The CPU version of the chip's op path: an eval ``InvertedResidual`` of
    B0's form with non-trivial BatchNorm statistics, folded into the op's
    parameters (eps 1e-3), against its own forward."""
    block = InvertedResidual(cin, cin, kernel=kernel, exp_ratio=6.0, se_ratio=0.25)
    init_like_flax(block, torch.Generator().manual_seed(kernel))
    port_probe.randomize_statistics(block, 4)
    block.eval()
    assert block.bn1.eps == block.bn2.eps == block.bn3.eps == 1e-3
    p = port_probe.fold_block(block)
    assert tuple(p["w_se1"].shape) == (6 * cin, block.se.fc1.out_channels)
    x = torch.from_numpy(_x(4, 2, size, size + 1, cin))
    ref = port_probe.block_reference(block, x)
    got = mb.mbconv_fused(x, p)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_b0_has_nine_blocks_of_the_kernels_form(port_probe):
    with torch.device("meta"):
        model = BACKBONES.get("efficientnet_b0")()
    blocks = port_probe.b0_blocks(model)
    got = [(name, hw[0], b.conv_pw.in_channels, b.conv_pw.out_channels, b.se.fc1.out_channels,
            b.conv_dw.kernel_size[0]) for name, b, hw in blocks]
    assert got == [("blocks_1_1", 56, 24, 144, 8, 3), ("blocks_2_1", 28, 40, 240, 16, 5),
                   ("blocks_3_1", 14, 80, 480, 24, 3), ("blocks_3_2", 14, 80, 480, 24, 3),
                   ("blocks_4_1", 14, 112, 672, 32, 5), ("blocks_4_2", 14, 112, 672, 32, 5),
                   ("blocks_5_1", 7, 192, 1152, 48, 5), ("blocks_5_2", 7, 192, 1152, 48, 5),
                   ("blocks_5_3", 7, 192, 1152, 48, 5)]


def test_the_op_raises_on_what_it_does_not_take():
    n, h, w, cin, mid, rd, k = CASES["tiny_8x8_mid48_k3"]
    p = _params(5, cin, mid, rd, k)
    p = _torch(p)
    x = torch.from_numpy(_x(5, n, h, w, cin))
    with pytest.raises(ValueError, match="inference only"):
        mb.mbconv_fused(x.clone().requires_grad_(True), p)
    with pytest.raises(ValueError, match="odd"):
        mb.mbconv_fused(x, {**p, "w_dw": torch.zeros((4, 4, mid))})
    with pytest.raises(ValueError, match="multiples of 8"):
        mb.mbconv_fused(x[..., :12].contiguous(), {**p, "w_exp": p["w_exp"][:12],
                                                   "w_proj": p["w_proj"][:, :12],
                                                   "s3": p["s3"][:, :12], "b3": p["b3"][:, :12]})
    with pytest.raises(ValueError, match="multiples of 8"):
        mb.mbconv_fused(x, {**p, "w_exp": p["w_exp"][:, :44]})
    with pytest.raises(ValueError, match="must be"):
        mb.mbconv_fused(x, {**p, "s2": p["s2"][:, :8]})
    with pytest.raises(ValueError, match="CUDA tensor"):
        mb.mbconv_fused_cuda(x, p)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        mb.mbconv_fused(x.to("meta"), p)


def test_the_plan_takes_the_widest_chunk_that_fits_a_block():
    """The strip and chunk the wrapper picks for B0's block shapes."""
    for (h, w, c, mid, k), item in [((56, 56, 24, 144, 3), 2), ((14, 14, 112, 672, 5), 2),
                                    ((7, 7, 192, 1152, 5), 2), ((7, 7, 192, 1152, 5), 4),
                                    ((28, 28, 40, 240, 5), 4)]:
        rows, chunk, nbytes = mb.plan(h, w, c, mid, k, item)
        assert nbytes == mb.shared_bytes(w, c, k, rows, chunk, item) <= mb.SHARED_LIMIT
        assert mid % chunk == 0 and 1 <= rows <= h
    assert mb.plan(56, 56, 24, 144, 3, 2)[:2] == (12, 16)  # 5 strips, 9 chunks
    assert mb.plan(14, 14, 112, 672, 5, 2)[:2] == (7, 32)
    with pytest.raises(ValueError, match="fits"):
        mb.plan(8, 4096, 2048, 64, 7, 4)
