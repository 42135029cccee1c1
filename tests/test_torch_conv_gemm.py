"""The port's implicit-GEMM 3x3 conv (``torchok_tpu_torch.ops.conv_gemm``)
against ``pallas_conv`` and ``xla_conv`` of ``tools/probe_r50_conv_gemm.py`` on
the same numpy inputs. The probe is loaded by file path and its Pallas kernel
runs in interpret mode (its module-level ``INTERPRET`` is set here; nothing in
``tools/`` changes); the port runs the plain version of its CUDA kernel.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchok_tpu_torch.ops import conv_gemm
from torchok_tpu_torch.ops.common import LAUNCHES

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def probe():
    mp = pytest.MonkeyPatch()
    # the probe sets these at import when they are unset: keep them out of
    # this process's environment afterwards
    mp.setenv("JAX_COMPILATION_CACHE_DIR", "")
    mp.setenv("TORCHOK_PROBE_INTERPRET", "0")
    mp.syspath_prepend(str(REPO))
    try:
        spec = importlib.util.spec_from_file_location(
            "probe_r50_conv_gemm", REPO / "tools" / "probe_r50_conv_gemm.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        mp.undo()
    module.INTERPRET = True
    return module


def _case(n, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h, w, cin)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    return x, k


# the probe's own interpret-mode shapes with its images per grid cell, and one
# with Cout != Cin
@pytest.mark.parametrize("n,hw,cin,cout,g", [(2, 9, 16, 16, 1), (2, 8, 24, 24, 2),
                                             (4, 7, 8, 40, 4)])
def test_plain_version_matches_pallas_conv_and_xla_conv(probe, n, hw, cin, cout, g):
    x, k = _case(n, hw, hw, cin, cout)
    before = LAUNCHES[conv_gemm.PLAIN]
    got = conv_gemm.conv3x3_gemm(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert LAUNCHES[conv_gemm.PLAIN] == before + 1
    assert got.shape == (n, hw, hw, cout)
    pallas = np.asarray(probe.pallas_conv(jnp.asarray(x), jnp.asarray(k), g=g))
    xla = np.asarray(probe.xla_conv(jnp.asarray(x), jnp.asarray(k)))
    # f32 on all sides, sums over 9 * Cin terms in other orders
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)


def test_borders_are_zero_taps_and_the_layout_is_nhwc_hwio():
    x, k = _case(3, 5, 7, 8, 16, seed=1)  # H != W
    got = conv_gemm.conv3x3_gemm_plain(torch.from_numpy(x), torch.from_numpy(k))
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(k).permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    ones = torch.ones((1, 3, 3, 8))
    corner = conv_gemm.conv3x3_gemm_plain(ones, torch.ones((3, 3, 8, 8)))
    assert corner[0, 0, 0, 0] == 4 * 8 and corner[0, 1, 1, 0] == 9 * 8  # not clamped reads


def test_bf16_rounds_once(probe):
    x, k = _case(2, 8, 8, 24, 24, seed=2)
    xb, kb = torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16()
    got = conv_gemm.conv3x3_gemm(xb, kb)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(probe.xla_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)),
                     np.float32)
    # f32 accumulation and one rounding on both sides: one bf16 ulp of the largest output
    assert np.abs(got.float().numpy() - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


def test_the_kernel_wrapper_refuses_a_cpu_tensor():
    x, k = _case(1, 4, 4, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv_gemm.conv3x3_gemm_cuda(torch.from_numpy(x), torch.from_numpy(k))
