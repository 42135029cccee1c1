"""The representation slice of the port against ``torchok_tpu`` on the CPU.

* The four losses (``ContrastiveLoss``, ``NT_XentLoss``, ``TripletMarginLoss``,
  ``TripletMarginWithDistanceLoss``): values and input gradients against the
  JAX functions and ``jax.grad`` in f32, within 1e-6 of the largest
  magnitude (relative).
* ``calc_relevance_matrix`` of a label vector (a label outside the classes
  included) and of a multihot matrix: equal.
* ``LinearHead`` against the Flax head, and the three wrapper tasks
  (pairwise, triplet, SimCLR) on a resnet18 at 32x32 with the weights
  carried by ``flax_convert`` (the model under ``inner``): every output
  within 1e-5, in train mode too, where both packages run the inner model's
  inference forward (BatchNorm on its running statistics, which stay).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import HEADS as JAX_HEADS
from torchok_tpu.constructor import LOSSES as JAX_LOSSES
from torchok_tpu.constructor import TASKS as JAX_TASKS
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.config_structure import merge_structured as jax_merge
from torchok_tpu.tasks.base import BaseTask as JaxBaseTask
from torchok_tpu.tasks.pairwise_task import calc_relevance_matrix as jax_relevance
from torchok_tpu_torch.constructor import HEADS, LOSSES, TASKS
from torchok_tpu_torch.constructor.config import config_from_dict
from torchok_tpu_torch.constructor.config_structure import merge_structured
from torchok_tpu_torch.tasks.pairwise_task import calc_relevance_matrix
from torchok_tpu_torch.utils.flax_convert import (flax_to_state_dict, state_dict_to_task_flax,
                                                  task_flax_to_state_dict)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=1e-6, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def _both(name, params, inputs):
    """Value and input gradients of loss ``name`` in both packages."""
    ref = JAX_LOSSES.get(name)(**params)
    got = LOSSES.get(name)(**params)
    keys = list(inputs)
    want, grads = jax.jit(jax.value_and_grad(
        lambda *xs: ref(**dict(zip(keys, xs))), argnums=tuple(range(len(keys)))))(
        *[jnp.asarray(inputs[k]) for k in keys])
    tensors = {k: torch.tensor(np.array(inputs[k])).requires_grad_(
        inputs[k].dtype == np.float32) for k in keys}
    value = got(**tensors)
    value.backward()
    _close(value, want, what=f"{name} value")
    for k, g in zip(keys, grads):
        if inputs[k].dtype == np.float32:
            _close(tensors[k].grad, g, what=f"{name} d/d{k}")


def _embeddings(n, d=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("reg", [None, "L1", "L2"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_contrastive_loss_matches_jax(reg, reduction):
    labels = np.random.default_rng(1).integers(0, 4, 12)
    R = np.array(jax_relevance(jnp.asarray(labels), 4))
    _both("ContrastiveLoss", {"margin": 1.5, "reg": reg, "reduction": reduction},
          {"emb1": _embeddings(12) * 0.3, "emb2": _embeddings(12, seed=2) * 0.3, "R": R})


@pytest.mark.parametrize("with_m", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_nt_xent_loss_matches_jax(with_m, reduction):
    inputs = {"emb1": _embeddings(6), "emb2": _embeddings(6, seed=1)}
    if with_m:
        inputs["emb_m"] = _embeddings(4, seed=2)
    _both("NT_XentLoss", {"temperature": 0.5, "reduction": reduction}, inputs)


@pytest.mark.parametrize("params", [{}, {"swap": True}, {"p": 1.0, "margin": 0.5},
                                    {"eps": 1e-3, "reduction": "sum"}])
def test_triplet_margin_loss_matches_jax(params):
    _both("TripletMarginLoss", params, {"anchor": _embeddings(8),
                                        "positive": _embeddings(8, seed=1),
                                        "negative": _embeddings(8, seed=2)})


@pytest.mark.parametrize("params", [{}, {"distance_function": "cosine"},
                                    {"swap": True, "margin": 3.0}])
def test_triplet_margin_with_distance_loss_matches_jax(params):
    _both("TripletMarginWithDistanceLoss", params,
          {"anchor": _embeddings(8), "positive": _embeddings(8, seed=1),
           "negative": _embeddings(8, seed=2)})


def test_relevance_matrix_matches_jax():
    labels = np.array([0, 3, 1, 3, 0, 7, 2])  # 7 lies outside the 5 classes
    want = np.asarray(jax_relevance(jnp.asarray(labels), 5))
    got = calc_relevance_matrix(torch.from_numpy(labels), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and got[5, 5] == 0
    multihot = np.random.default_rng(0).random((9, 6)) < 0.25
    want = np.asarray(jax_relevance(jnp.asarray(multihot), 6))
    np.testing.assert_array_equal(calc_relevance_matrix(torch.from_numpy(multihot), 6).numpy(),
                                  want)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_head_matches_flax(normalize, bias):
    x = np.random.default_rng(0).normal(size=(5, 24)).astype(np.float32)
    ref = JAX_HEADS.get("LinearHead")(in_channels=24, out_channels=12, normalize=normalize,
                                      bias=bias, drop_rate=0.3)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    got = HEADS.get("LinearHead")(in_channels=24, out_channels=12, normalize=normalize,
                                  bias=bias, drop_rate=0.3).eval()
    got.load_state_dict({k: torch.from_numpy(v) for k, v in
                         flax_to_state_dict("LinearHead", variables).items()}, strict=True)
    assert got.out_channels == 12
    xt = torch.from_numpy(x).requires_grad_(True)
    out = got(xt)
    want = ref.apply(variables, jnp.asarray(x))
    _close(out, want, 1e-5)
    cot = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    gx = jax.grad(lambda a: jnp.sum(ref.apply(variables, a) * cot))(jnp.asarray(x))
    _close(xt.grad, gx, 1e-5)
    back = state_dict_to_task_flax("LinearHead", {f"head.{k}": v.detach()
                                                  for k, v in got.state_dict().items()},
                                   {"params": {"head": variables["params"]}})
    np.testing.assert_array_equal(back["head"]["fc"]["kernel"],
                                  variables["params"]["fc"]["kernel"])


# ----------------------------------------------------------------------
# the three wrapper tasks
# ----------------------------------------------------------------------

def _task_cfg(name, **extra):
    params = {"backbone_name": "resnet18",
              "backbone_params": {"in_channels": 3, "layers": [1, 1, 1, 1]},
              "pooling_name": "Pooling", "head_name": "LinearHead",
              "head_params": {"out_channels": 16, "normalize": True},
              "inputs": [{"shape": [3, 32, 32], "dtype": "float32"}], **extra}
    return {"task": {"name": name, "params": params}, "data": {},
            "trainer": {"accelerator": "cpu"}}


@pytest.fixture(scope="module")
def flax_variables():
    """One resnet18 + LinearHead's Flax variables under ``inner`` (the
    pairwise task's; the three tasks share the layout), initialised in one
    compiled function."""
    cfg = _task_cfg("PairwiseLearnTask", num_classes=5)
    config = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
    ref = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    init = jax.jit(lambda r: JaxBaseTask.init_variables(ref, r))
    variables = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(3)))
    assert set(variables["params"]) == {"inner"}
    # running statistics away from the init law, so the train-mode check
    # can tell running from batch statistics
    rng = np.random.default_rng(9)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables


def _pair(name, variables, **extra):
    cfg = _task_cfg(name, **extra)
    config = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
    ref = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    port_cfg = merge_structured(config_from_dict(copy.deepcopy(cfg)))
    task = TASKS.get(port_cfg.task.name)(port_cfg, **port_cfg.task.params.to_dict())
    state = {k: torch.from_numpy(np.asarray(v))
             for k, v in task_flax_to_state_dict("resnet18", variables).items()}
    task.model.load_state_dict(state, strict=True)
    assert all(k.startswith("inner.") for k in state)
    return ref, task


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _run(ref, task, variables, batch, train):
    want, _ = jax.jit(lambda v, b: ref.model.apply(v, b, train=train, mutable=["batch_stats"]))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    task.model.train(train)
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    port = {k: _nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in batch.items()}
    got = task.model(port)
    # the inference forward leaves every running statistic, and every mode, as it was
    for k, v in task.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(m.training == train for m in task.model.modules())
    return got, want


@pytest.mark.parametrize("train", [False, True])
def test_pairwise_task_matches_jax(flax_variables, train):
    ref, task = _pair("PairwiseLearnTask", flax_variables, num_classes=5)
    target = np.array([0, 1, 0, 4, 2, 1])
    got, want = _run(ref, task, flax_variables, {"image": _images(6, 0), "target": target},
                     train)
    assert set(got) == set(want) == {"emb1", "emb2", "R", "target", "embeddings"}
    for key in ("emb1", "emb2", "embeddings"):
        _close(got[key], want[key], 1e-5, key)
    np.testing.assert_array_equal(got["R"].numpy(), np.asarray(want["R"]))
    np.testing.assert_array_equal(got["target"].numpy(), target)
    assert task.as_module() is task.model.inner
    # and the bridge back, ``inner`` included
    back = state_dict_to_task_flax("resnet18", task.model.state_dict(), flax_variables)
    assert set(back) == {"inner"}
    np.testing.assert_array_equal(back["inner"]["head"]["fc"]["kernel"],
                                  flax_variables["params"]["inner"]["head"]["fc"]["kernel"])


@pytest.mark.parametrize("train", [False, True])
def test_triplet_task_matches_jax(flax_variables, train):
    ref, task = _pair("TripletLearnTask", flax_variables)
    batch = {k: _images(4, i) for i, k in enumerate(("anchor", "positive", "negative"))}
    got, want = _run(ref, task, flax_variables, batch, train)
    assert set(got) == set(want) == {"anchor", "positive", "negative"}
    for key in got:
        _close(got[key], want[key], 1e-5, key)


def test_triplet_task_validation_forward_matches_jax(flax_variables):
    ref, task = _pair("TripletLearnTask", flax_variables)
    target = np.array([3, 1, 0, 2])
    got, want = _run(ref, task, flax_variables, {"image": _images(4, 5), "target": target},
                     False)
    assert set(got) == set(want) == {"embeddings", "prediction", "target"}
    for key in ("embeddings", "prediction"):
        _close(got[key], want[key], 1e-5, key)


@pytest.mark.parametrize("train", [False, True])
def test_simclr_task_matches_jax(flax_variables, train):
    ref, task = _pair("SimCLRTask", flax_variables)
    got, want = _run(ref, task, flax_variables,
                     {"image_0": _images(4, 1), "image_1": _images(4, 2)}, train)
    assert set(got) == set(want) == {"emb1", "emb2"}
    for key in got:
        _close(got[key], want[key], 1e-5, key)
