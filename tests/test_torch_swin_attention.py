"""The port's fused SwinV2 window attention against ``torchok_tpu``'s.

On the CPU the port's op runs its plain version, held against the Pallas
kernel in interpret mode on the same numpy inputs. The Hopper kernel itself
is held against the plain version on the card in
``test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.models.backbones.swin import _shift_window_region_ids
from torchok_tpu.ops import swin_attention as jax_ops
from torchok_tpu_torch.models.backbones.swin import shift_window_mask
from torchok_tpu_torch.ops import swin_attention as ops

# (B, Hp, Wp, ws, heads, head_dim); the second has the slice's L = 64
GEOMETRIES = [(2, 8, 12, 4, 2, 8), (2, 16, 16, 8, 2, 8)]


def _inputs(b, hp, wp, ws, h, d, masked, seed=0):
    rng = np.random.default_rng(seed)
    L = ws * ws
    qkv = rng.normal(size=(b, hp, wp, 3 * h * d)).astype(np.float32)
    logit_scale = (np.log(10.0) + rng.normal(size=(h,))).astype(np.float32)
    logit_scale[0] = 5.0  # above ln(100): exercises the clamp
    bias = (16.0 / (1.0 + np.exp(-rng.normal(size=(h, L, L))))).astype(np.float32)
    mask = None
    if masked:
        ids = _shift_window_region_ids(hp, wp, ws, ws // 2)
        mask = np.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0).astype(np.float32)
    return qkv, logit_scale, bias, mask


def _jax(qkv, logit_scale, bias, mask, ws, h, dtype):
    out = jax_ops.fused_swin_attention(
        jnp.asarray(qkv, dtype), jnp.asarray(logit_scale), jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), ws=ws, nheads=h, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(qkv, logit_scale, bias, mask, ws, h, dtype):
    out = ops.fused_swin_attention(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(logit_scale),
        torch.from_numpy(bias), None if mask is None else torch.from_numpy(mask),
        ws=ws, nheads=h)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["ws4", "ws8"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_matches_pallas_kernel_f32(geometry, masked):
    b, hp, wp, ws, h, d = geometry
    args = _inputs(b, hp, wp, ws, h, d, masked)
    ref = _jax(*args, ws, h, jnp.float32)
    got = _port(*args, ws, h, torch.float32)
    assert got.shape == (b, hp, wp, h * d)
    # f32 throughout; only the summation order differs
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_rounding_points_bf16(masked):
    """bf16 qkv: both round qn/kn and the attention weights to bf16 at the
    same points, so they agree to a bf16 ulp of the output."""
    b, hp, wp, ws, h, d = GEOMETRIES[1]
    args = _inputs(b, hp, wp, ws, h, d, masked, seed=1)
    ref = _jax(*args, ws, h, jnp.bfloat16)
    got = _port(*args, ws, h, torch.bfloat16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    # and it is not the f32 result: the rounding is really there
    assert np.abs(got - _port(*args, ws, h, torch.float32)).max() > 1e-3


def test_window_partition_roundtrip_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 8, 12, 5)).astype(np.float32)
    got = ops.window_partition(torch.from_numpy(x), 4)
    ref = np.asarray(jax_ops.window_partition(jnp.asarray(x), 4))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ops.window_reverse(got, 4, 8, 12).numpy(), x)


def test_shift_mask_matches_jax_block():
    ids = _shift_window_region_ids(16, 16, 8, 4)
    ref = np.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0)
    np.testing.assert_array_equal(shift_window_mask(16, 16, 8, 4).numpy(), ref)


def test_cpu_tensor_takes_plain_path():
    args = _inputs(*GEOMETRIES[0], masked=True)
    before = dict(ops.LAUNCHES)
    _port(*args, 4, 2, torch.float32)
    assert ops.LAUNCHES[ops.PLAIN] == before.get(ops.PLAIN, 0) + 1
    assert ops.LAUNCHES[ops.KERNEL] == before.get(ops.KERNEL, 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    qkv, ls, bias, mask = _inputs(*GEOMETRIES[1], masked=False)
    with pytest.raises(ValueError, match="CUDA"):
        ops.swin_attention_fwd_cuda(torch.from_numpy(qkv), torch.from_numpy(ls),
                                    torch.from_numpy(bias), None, 8, 2)

