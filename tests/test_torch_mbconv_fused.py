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


def _registry_k9_shapes(port_probe, size=224):
    """``(H, W, C, mid, rd, k)`` of every block of K9's form in the
    EfficientNet and MobileNetV3 registry names at ``size``, read from the
    blocks built on the meta device. Names of a family whose table differs
    only in depth have the same widths, so the deepest of them stands for
    all (each stage's residual blocks share one shape)."""
    from torchok_tpu_torch.models.backbones import efficientnet, mobilenetv3
    deepest = {}
    for family in (efficientnet, mobilenetv3):
        for name, cfg in family._VARIANTS.items():
            key = (family.__name__, repr(sorted((k, v) for k, v in cfg.items()
                                                if k != "depth_mult")))
            depth = cfg.get("depth_mult", 1.0)
            if key not in deepest or depth > deepest[key][1]:
                deepest[key] = (name, depth)
    shapes = set()
    with torch.device("meta"):
        for name, _ in deepest.values():
            for _, b, (h, w) in port_probe.b0_blocks(BACKBONES.get(name)(), size):
                shapes.add((h, w, b.conv_pw.in_channels, b.conv_pw.out_channels,
                            b.se.fc1.out_channels, b.conv_dw.kernel_size[0]))
    return sorted(shapes)


def test_the_cluster_plan_fits_a_block_at_every_registry_shape(port_probe):
    """At every shape of K9's form that the registry builds (224x224): a
    plan's strips (at most 8) cover the image with no empty block, its
    bytes are the layout's and fit a block, and bf16 takes the cluster route
    exactly where there is a plan; f32 always takes the three launches."""
    shapes = _registry_k9_shapes(port_probe)
    b0 = {(56, 56, 24, 144, 8, 3), (28, 28, 40, 240, 16, 5), (14, 14, 80, 480, 24, 3),
          (14, 14, 112, 672, 32, 5), (7, 7, 192, 1152, 48, 5)}
    assert b0 <= set(shapes) and len(shapes) > 100
    planned = 0
    for h, w, c, mid, rd, k in shapes:
        cut = mb.plan_cluster(h, w, c, mid, rd, k)
        assert mb.route(h, w, c, mid, rd, k, torch.float32) == "three_launch"
        if cut is None:
            assert mb.route(h, w, c, mid, rd, k, torch.bfloat16) == "three_launch"
            continue
        planned += 1
        assert mb.route(h, w, c, mid, rd, k, torch.bfloat16) == "cluster"
        assert cut.strips in mb.STRIPS and cut.strips <= 8
        assert cut.rows * cut.strips >= h > cut.rows * (cut.strips - 1)
        assert mid % cut.chunk == 0 and c * cut.chunk <= mb.W_EXP_QUADS * 4 * mb.CLUSTER_THREADS
        assert cut.kc % 16 == 0 and rd <= min(mid, mb.CLUSTER_THREADS)
        assert cut.bytes == mb.cluster_shared_bytes(h, w, c, mid, k, cut.rows, cut.chunk,
                                                    cut.kc) <= mb.SHARED_LIMIT
    assert planned >= 50


def test_the_cluster_plan_of_b0s_blocks():
    """B0's five block shapes: strips of 7 rows (8, 4, 2, 2 and 1 a cluster),
    and the widest chunk and w_proj stage that fit."""
    got = {shape: mb.plan_cluster(*shape)[:5] for shape in [
        (56, 56, 24, 144, 8, 3), (28, 28, 40, 240, 16, 5), (14, 14, 80, 480, 24, 3),
        (14, 14, 112, 672, 32, 5), (7, 7, 192, 1152, 48, 5)]}
    assert got == {(56, 56, 24, 144, 8, 3): (8, 7, 16, 64, 8),
                   (28, 28, 40, 240, 16, 5): (4, 7, 16, 64, 4),
                   (14, 14, 80, 480, 24, 3): (2, 7, 32, 64, 2),
                   (14, 14, 112, 672, 32, 5): (2, 7, 32, 32, 2),
                   (7, 7, 192, 1152, 48, 5): (1, 7, 64, 32, 1)}


def test_the_route_sends_f32_and_large_images_to_the_three_launches(port_probe):
    """f32 at every shape, bf16 where the strips of 8 blocks do not fit (the
    first block of EfficientNet-B7's 150x150 stage at 600x600), and mid not a
    multiple of 16 take the three-launch kernel."""
    with torch.device("meta"):
        b7 = port_probe.b0_blocks(BACKBONES.get("efficientnet_b7")(), 600)
    _, block, (h, w) = b7[0]
    shape = (h, w, block.conv_pw.in_channels, block.conv_pw.out_channels,
             block.se.fc1.out_channels, block.conv_dw.kernel_size[0])
    assert shape == (150, 150, 48, 288, 16, 3)
    assert mb.plan_cluster(*shape) is None
    assert mb.route(*shape, torch.bfloat16) == "three_launch"
    assert mb.route(7, 7, 192, 1152, 48, 5, torch.float32) == "three_launch"
    assert mb.route(7, 7, 192, 1152, 48, 5, torch.bfloat16) == "cluster"
    assert mb.route(9, 13, 24, 40, 6, 5, torch.bfloat16) == "three_launch"  # mid 40


# (n, H, W, C, mid, rd, k) at 2, 4 and 8 strips a cluster, ragged strips and
# k 7 among them (the cases of the card test
# test_mbconv_fused_cluster_takes_the_se_mean_across_its_strips)
SE_STRIP_SHAPES = {
    "b0_3_x": (2, 14, 14, 80, 480, 24, 3), "b0_2_1": (2, 28, 28, 40, 240, 16, 5),
    "b0_1_1": (2, 56, 56, 24, 144, 8, 3), "ragged_strips": (2, 23, 23, 48, 288, 12, 5),
    "k7_strips": (2, 45, 45, 24, 144, 6, 7),
}


def _plain_by_strips(x, p, rows, fault):
    """The plain version with the SE mean taken as a cluster of strips of
    ``rows`` rows takes it: each strip's gate from the strips' sums,
    correctly (``fault`` "none") or with a planted fault: a strip's own sum
    only ("own"), rank 0's sum read for every rank ("rank"), the image's sum
    over a strip's pixels ("count")."""
    import torch.nn.functional as F
    n, h, w, c, mid, rd, k = mb.block_shape(x, p)
    q = mb._f32(p, x.device)
    pad = (k - 1) // 2
    xf = x.float()
    a = mb._swish(torch.matmul(xf.reshape(-1, c), q["w_exp"]) * q["s1"] + q["b1"])
    apad = F.pad(a.reshape(n, h, w, mid), (0, 0, pad, pad, pad, pad))
    acc = sum(apad[:, dy:dy + h, dx:dx + w, :] * q["w_dw"][dy, dx]
              for dy in range(k) for dx in range(k))
    a = mb._swish(acc * q["s2"] + q["b2"])
    strips = -(-h // rows)
    sums = torch.stack([a[:, r * rows:(r + 1) * rows].sum((1, 2)) for r in range(strips)], 1)
    whole = sums.sum(1, keepdim=True).expand(-1, strips, -1)
    mean = {"none": whole / (h * w), "own": sums / (h * w),
            "rank": (strips * sums[:, :1]).expand(-1, strips, -1) / (h * w),
            "count": whole / (rows * w)}[fault]
    r1 = mb._swish(torch.matmul(mean, q["w_se1"]) + q["b_se1"])
    gate = torch.sigmoid(torch.matmul(r1, q["w_se2"]) + q["b_se2"])  # (n, strips, mid)
    a = a * gate.repeat_interleave(rows, 1)[:, :h, None, :]
    y = torch.matmul(a.reshape(-1, mid), q["w_proj"]) * q["s3"] + q["b3"]
    return (y.reshape(n, h, w, c) + xf).to(x.dtype)


@pytest.mark.parametrize("shape", list(SE_STRIP_SHAPES))
def test_the_se_case_sees_a_wrong_mean_across_the_strips(port_probe, shape):
    """Under the probe's ``make_se_case`` law, a cluster that took the SE mean
    wrongly (its own strip's sum, the wrong rank's, the wrong count) moves y
    by more than four times the card test's bf16 tolerance (2^-7 x max|y|),
    where ``make_params``' law hides it; the strips taken correctly give the
    plain version."""
    n, h, w, c, mid, rd, k = SE_STRIP_SHAPES[shape]
    cut = mb.plan_cluster(h, w, c, mid, rd, k)
    assert cut.strips > 1
    x, p = port_probe.make_se_case(np.random.default_rng(11), n, h, w, c, mid, rd, k, "cpu",
                                   torch.float32)
    ref = mb.mbconv_fused_plain(x, p)
    tol = 2.0 ** -7 * ref.abs().max().item()
    assert (_plain_by_strips(x, p, cut.rows, "none") - ref).abs().max().item() <= 1e-3 * tol
    for fault in ("own", "rank", "count"):
        assert (_plain_by_strips(x, p, cut.rows, fault) - ref).abs().max().item() > 4 * tol
    rng = np.random.default_rng(11)
    x = port_probe.make_input(rng, n, h, c, "cpu", torch.float32)
    p = port_probe.make_params(rng, c, mid, rd, k, "cpu", torch.float32)
    ref = mb.mbconv_fused_plain(x, p)
    assert (_plain_by_strips(x, p, cut.rows, "own") - ref).abs().max().item() < \
        2.0 ** -7 * ref.abs().max().item()
