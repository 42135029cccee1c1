"""The port's cosine window attention on pre-partitioned windows
(``torchok_tpu_torch.ops.window_attention``) against
``torchok_tpu.ops.window_attention`` on the same numpy inputs.

The JAX side runs its Pallas kernel in interpret mode (as its own tests do) or
its XLA formulation; the port runs the plain version of its CUDA kernel and its
einsum formulation on the CPU. f32 unless a case says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.ops import window_attention as jwa
from torchok_tpu_torch.ops import window_attention as wa
from torchok_tpu_torch.ops.common import LAUNCHES

B, NW, H, L, D = 2, 4, 3, 16, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B * NW, H, L, D)).astype(np.float32) for _ in range(3))
    logit_scale = rng.normal(size=(H,)).astype(np.float32)
    logit_scale[0] = 5.0  # above ln 100: the clamp is live
    bias = rng.normal(size=(H, L, L)).astype(np.float32)
    masks = {"none": None}
    for name, rows in (("one", 1), ("compact", NW), ("tiled", B * NW)):
        masks[name] = (-100.0 * (rng.normal(size=(rows, L, L)) > 1.0)).astype(np.float32)
    return q, k, v, logit_scale, bias, masks


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("n_mask", ["one", "compact", "tiled"])
def test_plain_version_matches_the_pallas_kernel(data, n_mask):
    q, k, v, ls, bias, masks = data
    ref = jwa._window_attention_pallas_mw(*_j(q, k, v, ls, bias, masks[n_mask]), interpret=True)
    got = wa.window_attention_mw_plain(*_t(q, k, v, ls, bias, masks[n_mask]))
    # the same f32 arithmetic, other summation orders
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plain_version_without_a_mask_is_the_kernel_with_a_zero_mask(data):
    q, k, v, ls, bias, _ = data
    zeros = np.zeros((1, L, L), np.float32)
    ref = jwa._window_attention_pallas_mw(*_j(q, k, v, ls, bias, zeros), interpret=True)
    got = wa.window_attention_mw_plain(*_t(q, k, v, ls, bias, None))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plain_version_in_bf16_matches_the_pallas_kernel(data):
    q, k, v, ls, bias, masks = data
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jwa._window_attention_pallas_mw(jq, jk, jv, *_j(ls, bias, masks["compact"]),
                                          interpret=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = wa.window_attention_mw_plain(tq, tk, tv, *_t(ls, bias, masks["compact"]))
    assert got.dtype == torch.bfloat16
    # one rounding to bf16 on both sides: at most one ulp (2^-8) of |out| <= 4
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=0,
                               atol=2e-2)


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("n_mask", ["none", "compact", "tiled"])
def test_einsum_formulation_matches_xla(data, layout, n_mask):
    q, k, v, ls, bias, masks = data
    if layout == "blhd":
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    ref = jwa.window_attention(*_j(q, k, v, ls, bias, masks[n_mask]), layout=layout)
    before = LAUNCHES[wa.PLAIN]
    got = wa.window_attention(*_t(q, k, v, ls, bias, masks[n_mask]), layout=layout)
    assert LAUNCHES[wa.PLAIN] == before  # the flag is off by default
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_kernel_path_matches_the_xla_formulation(data, layout):
    """2e-4 as ``tests/test_window_attention.py`` holds the Pallas kernel: it
    normalises with rsqrt(sum + eps), the formulation divides by norm + eps."""
    q, k, v, ls, bias, masks = data
    if layout == "blhd":
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    ref = jwa.window_attention(*_j(q, k, v, ls, bias, masks["compact"]), layout=layout)
    before = LAUNCHES[wa.PLAIN]
    got = wa.window_attention(*_t(q, k, v, ls, bias, masks["compact"]), True, layout=layout)
    assert LAUNCHES[wa.PLAIN] == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("n_mask", ["none", "compact"])
def test_hybrid_gradients_match_the_jax_hybrid(data, layout, n_mask):
    q, k, v, ls, bias, masks = data
    if layout == "blhd":
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    mask = masks[n_mask]
    weight = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)

    def jax_loss(q_, k_, v_, s_, b_):
        out = jwa.window_attention(q_, k_, v_, s_, b_, None if mask is None else jnp.asarray(mask),
                                   use_pallas=True, interpret=True, layout=layout)
        return jnp.sum(out * weight)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*_j(q, k, v, ls, bias))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v, ls, bias)]
    before = LAUNCHES[wa.PLAIN]
    out = wa.window_attention(*leaves, *_t(mask), True, layout=layout)
    (out * torch.from_numpy(weight)).sum().backward()
    assert LAUNCHES[wa.PLAIN] == before + 1  # the backward recomputes through the einsums
    for name, leaf, r in zip(("dq", "dk", "dv", "dlogit_scale", "dbias"), leaves, ref):
        # f32 on both sides, other summation orders (dlogit_scale sums 6,144 terms)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert leaves[3].grad[0] == 0.0  # the clamped head's temperature takes no gradient


def test_no_graph_is_built_without_gradients(data):
    q, k, v, ls, bias, masks = data
    args = _t(q, k, v, ls, bias, masks["compact"])
    assert wa.window_attention(*args, True).grad_fn is None
    args[0].requires_grad_(True)
    assert wa.window_attention(*args, True).grad_fn is not None
    with torch.no_grad():
        assert wa.window_attention(*args, True).grad_fn is None


def test_what_the_op_refuses(data):
    q, k, v, ls, bias, masks = data
    args = _t(q, k, v, ls, bias, masks["compact"])
    with pytest.raises(ValueError, match="layout"):
        wa.window_attention(*args, layout="hbld")
    with pytest.raises(ValueError, match="layout"):
        wa.window_attention(*args, True, layout="hbld")
    with pytest.raises(ValueError, match="CUDA tensor"):
        wa.window_attention_mw_cuda(*args)
    with pytest.raises(ValueError, match="window types"):
        wa.window_attention_einsum(*args[:5], torch.zeros(3, L, L))
    assert wa.KERNEL_L == (16, 64) and wa.KERNEL_D == (8, 32)
    assert wa.LN_100 == jwa.LN_100
