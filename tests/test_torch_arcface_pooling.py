"""``PoolingLinear`` and ``ArcFaceHead`` against the Flax modules of
``torchok_tpu``, with the weights (and ArcFace's integer ``step``) carried
by ``torchok_tpu_torch.utils.flax_convert``, on the CPU in f32.

Tolerances: outputs and logits within 1e-5 (absolute, at logits up to a
scale of 30); gradients within 1e-4. The ``step`` counter is an
integer and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import HEADS as JAX_HEADS
from torchok_tpu.constructor import POOLINGS as JAX_POOLINGS
from torchok_tpu_torch.constructor import HEADS, POOLINGS
from torchok_tpu_torch.utils.flax_convert import (flax_to_state_dict, state_dict_to_task_flax,
                                                  task_flax_to_state_dict)

B = 6


def _load(module, variables, name):
    sd = {k: torch.from_numpy(v) for k, v in flax_to_state_dict(name, variables).items()}
    module.load_state_dict(sd, strict=True)
    return module


@pytest.mark.parametrize("pooling_type", ["avg", "max", "avgmax", "catavgmax"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_pooling_linear_equals_flax(pooling_type, use_bias):
    x = np.random.default_rng(0).normal(size=(B, 5, 5, 16)).astype(np.float32)  # NHWC
    ref = JAX_POOLINGS.get("PoolingLinear")(in_channels=16, out_channels=24,
                                            pooling_type=pooling_type, use_bias=use_bias)
    variables = ref.init(jax.random.PRNGKey(1), jnp.asarray(x))
    got = POOLINGS.get("PoolingLinear")(in_channels=16, out_channels=24,
                                        pooling_type=pooling_type, use_bias=use_bias)
    _load(got, variables, "PoolingLinear")
    assert got.out_channels == ref.out_channels == 24
    want = np.asarray(ref.apply(variables, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)  # NCHW
    out = got(xt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    # the bridge back, and gradients through both
    back = state_dict_to_task_flax("PoolingLinear", {f"pooling.{k}": v.detach()
                                                     for k, v in got.state_dict().items()},
                                   {"params": {"pooling": variables["params"]}})
    np.testing.assert_array_equal(back["pooling"]["fc"]["kernel"],
                                  variables["params"]["fc"]["kernel"])
    cot = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    gx = jax.grad(lambda v, a: jnp.sum(ref.apply(v, a) * cot), argnums=(0, 1))(
        variables, jnp.asarray(x))
    np.testing.assert_allclose(got.fc.weight.grad.numpy(),
                               np.asarray(gx[0]["params"]["fc"]["kernel"]).T, rtol=0, atol=1e-4)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx[1]),
                               rtol=0, atol=1e-4)


def test_pooling_linear_draws_nn_dense_law():
    torch.manual_seed(0)
    m = POOLINGS.get("PoolingLinear")(in_channels=512, out_channels=128)
    m.init_weights(torch.Generator().manual_seed(3))
    w = m.fc.weight.detach().numpy()
    # lecun_normal: variance 1 / fan_in, truncated at two of its deviations
    assert w.std() == pytest.approx(np.sqrt(1 / 512), rel=0.02)
    assert np.abs(w).max() <= 2 * np.sqrt(1 / 512) / 0.87962566103423978
    assert not m.fc.bias.detach().any()


HEAD_CASES = {
    "default scale and margin": dict(in_channels=16, num_classes=5),
    "easy margin": dict(in_channels=16, num_classes=5, easy_margin=True),
    "given scale and margin": dict(in_channels=16, num_classes=5, scale=30.0, margin=0.3),
    "two-channel default margin": dict(in_channels=2, num_classes=4),
    "hard margin where cosine < th": dict(in_channels=16, num_classes=5, margin=1.2),
}


def _head_inputs(in_channels, num_classes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, in_channels)).astype(np.float32)
    target = rng.integers(0, num_classes, B).astype(np.int32)
    return x, target


def _pair(params):
    ref = JAX_HEADS.get("ArcFaceHead")(**params)
    x, target = _head_inputs(params["in_channels"], params["num_classes"])
    variables = ref.init(jax.random.PRNGKey(4), jnp.asarray(x), target=jnp.asarray(target),
                         train=True)
    got = HEADS.get("ArcFaceHead")(**params)
    _load(got, variables, "ArcFaceHead")
    return ref, variables, got, x, target


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_arcface_eval_and_train_logits_and_gradients_equal_flax(case):
    ref, variables, got, x, target = _pair(HEAD_CASES[case])
    assert got.weight.shape == variables["params"]["weight"].shape  # not transposed
    got.eval()
    eval_want = np.asarray(ref.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got(torch.from_numpy(x)).detach().numpy(), eval_want,
                               rtol=0, atol=1e-5)
    got.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = got(xt, target=torch.from_numpy(target).long())
    mutable = ["buffers"] if "buffers" in variables else []

    def train_logits(v, a):
        res = ref.apply(v, a, target=jnp.asarray(target), train=True, mutable=mutable)
        return res[0] if mutable else res

    want = np.asarray(train_logits(variables, jnp.asarray(x)))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    # the margin moved the target logits and nothing else
    assert not np.allclose(want, eval_want)
    cot = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    gv, gx = jax.grad(lambda p, a: jnp.sum(train_logits({**variables, "params": p}, a) * cot),
                      argnums=(0, 1))(variables["params"], jnp.asarray(x))
    np.testing.assert_allclose(got.weight.grad.numpy(), np.asarray(gv["weight"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="Target is None"):
        got(xt)


def test_dynamic_margin_steps_and_the_integer_step_round_trip():
    params = dict(in_channels=16, num_classes=5, dynamic_margin=True, num_warmup_steps=4,
                  min_margin=0.1)
    ref, variables, got, x, target = _pair(params)
    # the train-mode init of the JAX package has already taken one step
    assert variables["buffers"]["step"].dtype == jnp.int32
    sd = flax_to_state_dict("ArcFaceHead", variables)
    assert sd["step"].dtype == np.int32 and sd["step"].shape == () and int(sd["step"]) == 1
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    got.train()
    for i in range(6):  # past the warm-up: the margin stops moving at step 4
        xs = x + 0.1 * i
        want, updates = ref.apply(variables, jnp.asarray(xs), target=jnp.asarray(target),
                                  train=True, mutable=["buffers"])
        variables = {**variables, **updates}
        out = got(torch.from_numpy(xs), target=torch.from_numpy(target).long())
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
        assert int(got.step) == int(variables["buffers"]["step"]) == 2 + i
    got.eval()  # eval forwards leave the counter alone
    got(torch.from_numpy(x))
    assert int(got.step) == 7
    back = state_dict_to_task_flax("ArcFaceHead", {f"head.{k}": v for k, v in
                                                   got.state_dict().items()},
                                   {"params": {"head": variables["params"]},
                                    "buffers": {"head": variables["buffers"]}}, "buffers")
    assert back["head"]["step"].dtype == np.int32 and int(back["head"]["step"]) == 7


def test_a_task_tree_carries_params_and_buffers():
    """The task bridge: pooling.fc, head.weight (untransposed) and the
    integer head.step of a torchok_tpu ClassificationModel's variables."""
    rng = np.random.default_rng(6)
    f32 = np.float32
    variables = {"params": {"pooling": {"fc": {"kernel": rng.normal(size=(8, 4)).astype(f32),
                                               "bias": rng.normal(size=(4,)).astype(f32)}},
                            "head": {"weight": rng.normal(size=(3, 4)).astype(f32)}},
                 "buffers": {"head": {"step": np.asarray(9, np.int32)}}}
    sd = task_flax_to_state_dict("resnet18", variables)
    assert sorted(sd) == ["head.step", "head.weight", "pooling.fc.bias", "pooling.fc.weight"]
    np.testing.assert_array_equal(sd["head.weight"], variables["params"]["head"]["weight"])
    np.testing.assert_array_equal(sd["pooling.fc.weight"],
                                  variables["params"]["pooling"]["fc"]["kernel"].T)
    assert sd["head.step"].dtype == np.int32 and int(sd["head.step"]) == 9
    assert sd["head.weight"].dtype == np.float32


@pytest.mark.parametrize("params,message", [
    (dict(num_warmup_steps=None, min_margin=0.1), "num_warmup_steps"),
    (dict(num_warmup_steps=0, min_margin=0.1), "num_warmup_steps"),
    (dict(num_warmup_steps=3, min_margin=None), "min_margin"),
])
def test_dynamic_margin_checks_raise_as_in_flax(params, message):
    params = dict(in_channels=4, num_classes=3, dynamic_margin=True, **params)
    x = jnp.ones((2, 4))
    with pytest.raises(ValueError, match=message):
        JAX_HEADS.get("ArcFaceHead")(**params).init(jax.random.PRNGKey(0), x,
                                                    target=jnp.zeros(2, jnp.int32), train=True)
    with pytest.raises(ValueError, match=message):
        HEADS.get("ArcFaceHead")(**params)


def test_arcface_weight_draws_xavier_uniform_from_the_generator():
    a = HEADS.get("ArcFaceHead")(in_channels=128, num_classes=10)
    b = HEADS.get("ArcFaceHead")(in_channels=128, num_classes=10)
    a.init_weights(torch.Generator().manual_seed(11))
    b.init_weights(torch.Generator().manual_seed(11))
    assert torch.equal(a.weight, b.weight)
    bound = np.sqrt(6 / (10 + 128))
    w = a.weight.detach().numpy()
    assert np.abs(w).max() <= bound and w.std() == pytest.approx(bound / np.sqrt(3), rel=0.05)
    assert int(a.step) == 0 and "step" in a.state_dict()
