"""The port's fused 1x1-conv + BatchNorm op (``torchok_tpu_torch.ops.conv_bn``)
and its BatchNorm module against ``torchok_tpu`` on the same numpy inputs.

``torchok_tpu.ops.conv_bn.matmul_bn`` interprets its Pallas kernel off the TPU
by itself; the port runs the plain version of its CUDA kernel. Tolerances are
those of ``tests/test_conv_bn_kernel.py``: y 1e-5, statistics rtol 1e-4 / atol
1e-2, gradients 2e-3.
"""
import importlib.util
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchok_tpu.ops import conv_bn as jcb
from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
from torchok_tpu_torch.ops import conv_bn as cb
from torchok_tpu_torch.ops.common import LAUNCHES

REPO = Path(__file__).resolve().parent.parent


def _inputs(m, k, n, seed=0):
    gen = np.random.default_rng(seed)
    x = gen.normal(0, 1, (m, k)).astype(np.float32)
    w = gen.normal(0, 0.05, (k, n)).astype(np.float32)
    scale = gen.uniform(0.5, 1.5, (k,)).astype(np.float32)
    bias = gen.normal(0, 0.2, (k,)).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("m,k,n", [(256, 128, 128), (200, 64, 256), (130, 128, 128)],
                         ids=["even", "ragged200", "ragged130"])
@pytest.mark.parametrize("relu_in,with_affine", [(False, False), (True, False), (False, True),
                                                 (True, True)])
def test_forward_matches_torchok_tpu(m, k, n, relu_in, with_affine):
    arrays = _inputs(m, k, n)
    ref = jcb.matmul_bn(*map(jnp.asarray, arrays), relu_in, with_affine)
    before = LAUNCHES[cb.PLAIN]
    got = cb.matmul_bn(*map(torch.from_numpy, arrays), relu_in, with_affine)
    assert LAUNCHES[cb.PLAIN] == before + 1
    assert got[0].shape == (m, n) and got[1].shape == got[2].shape == (n,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4, atol=1e-2)


def test_rows_past_m_do_not_reach_the_statistics():
    """The affine maps a padded zero row to relu(bias) != 0: the statistics
    must be those of the 130 real rows whatever the kernel's tile is."""
    x, w, scale, bias = _inputs(130, 128, 128, seed=2)
    bias = np.abs(bias) + 1.0
    y, s1, s2 = cb.matmul_bn(*map(torch.from_numpy, (x, w, scale, bias)), True, True)
    a = np.maximum(x * scale + bias, 0.0)
    np.testing.assert_allclose(s1.numpy(), (a @ w).sum(0), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(s2.numpy(), ((a @ w) ** 2).sum(0), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("relu_in,with_affine", [(True, True), (False, False)])
def test_gradients_match_torchok_tpu(relu_in, with_affine):
    arrays = _inputs(192, 64, 128, seed=1)
    cw = np.random.default_rng(3).normal(0, 1, (128,)).astype(np.float32)

    def jax_loss(x, w, scale, bias):
        y, s1, s2 = jcb.matmul_bn(x, w, scale, bias, relu_in, with_affine)
        return jnp.sum(y * cw) + 0.1 * jnp.sum(s1) + 0.01 * jnp.sum(s2)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, s1, s2 = cb.matmul_bn(*leaves, relu_in, with_affine)
    ((y * torch.from_numpy(cw)).sum() + 0.1 * s1.sum() + 0.01 * s2.sum()).backward()
    for name, leaf, r in zip(("dx", "dw", "dscale", "dbias"), leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=2e-3, atol=2e-3,
                                   err_msg=name)
    if not with_affine:
        assert not leaves[2].grad.any() and not leaves[3].grad.any()


def test_bf16_operands_round_where_the_pallas_kernel_rounds():
    x, w, scale, bias = _inputs(200, 64, 256, seed=4)
    ref = jcb.matmul_bn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                        jnp.asarray(scale), jnp.asarray(bias), True, True)
    got = cb.matmul_bn(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                       torch.from_numpy(scale), torch.from_numpy(bias), True, True)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    y_ref = np.asarray(ref[0], np.float32)
    # one ulp of the largest |y| where two f32 sums fall on either side of a
    # rounding boundary; the statistics are of that rounded y
    assert np.abs(got[0].float().numpy() - y_ref).max() <= 2.0 ** -7 * np.abs(y_ref).max()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=5e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4, atol=5e-2)
    yf = got[0].float()
    torch.testing.assert_close(got[1], yf.sum(0), rtol=1e-6, atol=1e-4)  # of the rounded y


def test_bn_from_stats_matches_torchok_tpu_and_flax():
    gen = np.random.default_rng(5)
    m, n = 512, 64
    y = gen.normal(1.5, 2.0, (m, n)).astype(np.float32)
    gamma = gen.uniform(0.5, 1.5, (n,)).astype(np.float32)
    beta = gen.normal(0, 0.3, (n,)).astype(np.float32)
    s1, s2 = y.sum(0), (y * y).sum(0)
    ref = jcb.bn_from_stats(jnp.asarray(s1), jnp.asarray(s2), m, jnp.asarray(gamma),
                            jnp.asarray(beta))
    got = cb.bn_from_stats(torch.from_numpy(s1), torch.from_numpy(s2), m,
                           torch.from_numpy(gamma), torch.from_numpy(beta))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.zeros(n), "var": jnp.ones(n)}}
    want, _ = bn.apply(variables, jnp.asarray(y), mutable=["batch_stats"])
    np.testing.assert_allclose((torch.from_numpy(y) * got[0] + got[1]).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_batchnorm_leaves_flax_running_statistics_after_5_steps():
    """momentum 0.9 is torch's 0.1, and the running variance takes the biased
    batch variance: after 5 train steps on different batches the buffers are
    Flax's ``batch_stats``, which ``torch.nn.BatchNorm2d``'s are not."""
    gen = np.random.default_rng(6)
    c = 6
    gamma = gen.uniform(0.5, 1.5, (c,)).astype(np.float32)
    beta = gen.normal(0, 0.3, (c,)).astype(np.float32)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    port = BatchNorm2d(c).train()
    stock = torch.nn.BatchNorm2d(c).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(gamma))
        port.bias.copy_(torch.from_numpy(beta))
    assert "num_batches_tracked" not in port.state_dict()
    for step in range(5):
        x = gen.normal(step - 2.0, 1.0 + step, (3, 4, 5, c)).astype(np.float32)  # 60 per channel
        want, updates = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, **updates}
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
        got = port(xt)
        got.sum().backward()  # the buffers' update must not disturb the backward
        stock(xt.detach())
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5,
                               atol=1e-6)
    # the unbiased factor 60/59 that torch keeps would show at 1e-5
    assert np.abs(stock.running_var.numpy() - np.asarray(stats["var"])).max() > 1e-3
    flax_eval = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    x = gen.normal(size=(2, 3, 3, c)).astype(np.float32)
    np.testing.assert_allclose(
        port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy(),
        np.asarray(flax_eval.apply(variables, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    before = port.running_var.clone()
    port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(port.running_var, before)  # eval mode leaves the buffers alone


def test_probe_chain_fused_equals_unfused_on_the_cpu():
    spec = importlib.util.spec_from_file_location("probe_torch_conv_bn",
                                                  REPO / "tools" / "probe_torch_conv_bn.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    device = torch.device("cpu")
    params = probe.make_params(0, 64, 16, 4, device)
    x = probe.make_input(1, 96, 64, device, torch.float32)
    before = dict(LAUNCHES)
    result = probe.parity(params, x)
    assert LAUNCHES[cb.PLAIN] == before.get(cb.PLAIN, 0) + 4  # one fused call per layer
    assert LAUNCHES[cb.KERNEL] == before.get(cb.KERNEL, 0)
    # f32 on both sides: the same function in another order of operations
    assert result["loss_fused"] == pytest.approx(result["loss_unfused"], rel=1e-5)
    assert all(v <= 1e-4 for v in result["grad_rel_err"].values()), result
    assert probe.STAGES[4] == (256 * 14 * 14, 1024, 256)


def test_the_kernel_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        cb.matmul_bn_cuda(*map(torch.from_numpy, _inputs(8, 8, 8)))
