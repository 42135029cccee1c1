"""The port's losses, optimizers, schedulers and parameter grouping against
``torchok_tpu``'s on the same numpy inputs."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401 — registers the port's
from torchok_tpu.constructor import LOSSES as JAX_LOSSES
from torchok_tpu.constructor import OPTIMIZERS as JAX_OPTIMIZERS
from torchok_tpu.constructor import SCHEDULERS as JAX_SCHEDULERS
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.constructor import Constructor as JaxConstructor
from torchok_tpu.losses.base import JointLoss as JaxJointLoss
from torchok_tpu_torch.constructor import BACKBONES, LOSSES, OPTIMIZERS, SCHEDULERS
from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.constructor.constructor import Constructor
from torchok_tpu_torch.losses.base import JointLoss
from torchok_tpu_torch.optim.schedulers import parse_lr_lambda
from torchok_tpu_torch.utils.flax_convert import task_name_map

# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
CE_CASES = {
    "default": {},
    "sum": {"reduction": "sum"},
    "none": {"reduction": "none"},
    "smoothing": {"label_smoothing": 0.1},
    "weight_mean": {"weight": [0.5, 1.0, 2.0, 1.5, 0.1]},
    "weight_sum_smoothing": {"weight": [0.5, 1.0, 2.0, 1.5, 0.1], "reduction": "sum",
                             "label_smoothing": 0.2},
    "ignore_index": {"ignore_index": 2},
    "ignore_index_weight_none": {"ignore_index": 2, "weight": [0.5, 1.0, 2.0, 1.5, 0.1],
                                 "reduction": "none"},
}


def _ce_inputs(seed=0, n=12, c=5):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.normal(size=(n, c))).astype(np.float32)
    target = rng.integers(0, c, size=(n,)).astype(np.int64)
    probs = rng.dirichlet(np.ones(c), size=(n,)).astype(np.float32)
    return logits, target, probs


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_matches_jax_class_targets(case):
    logits, target, _ = _ce_inputs()
    ref = JAX_LOSSES.get("CrossEntropyLoss")(**CE_CASES[case])(jnp.asarray(logits),
                                                               jnp.asarray(target))
    got = LOSSES.get("CrossEntropyLoss")(**CE_CASES[case])(torch.from_numpy(logits),
                                                           torch.from_numpy(target))
    # f32 log-softmax on both sides: 1e-6 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax_probability_targets(reduction):
    logits, _, probs = _ce_inputs(seed=1)
    ref = JAX_LOSSES.get("CrossEntropyLoss")(reduction=reduction)(jnp.asarray(logits),
                                                                  jnp.asarray(probs))
    got = LOSSES.get("CrossEntropyLoss")(reduction=reduction)(torch.from_numpy(logits),
                                                              torch.from_numpy(probs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_cross_entropy_bf16_logits_are_reduced_in_f32_and_differentiable():
    logits, target, _ = _ce_inputs(seed=2)
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    loss = LOSSES.get("CrossEntropyLoss")()(x, torch.from_numpy(target))
    assert loss.dtype == torch.float32
    ref = torch.nn.functional.cross_entropy(x.detach().float(), torch.from_numpy(target))
    assert abs(loss.item() - ref.item()) <= 1e-6
    loss.backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    # pixel logits take their classes at dim 1, as torch's cross_entropy does
    # (tests/test_torch_segmentation.py holds every option against the JAX
    # package); a class dim elsewhere raises by name
    pixels = LOSSES.get("CrossEntropyLoss")()(torch.zeros(2, 5, 3, 3), torch.zeros(2, 3, 3).long())
    assert abs(pixels.item() - np.log(5.0)) <= 1e-6
    with pytest.raises(ValueError, match="CrossEntropyLoss.*dim 1"):
        LOSSES.get("CrossEntropyLoss")()(torch.zeros(2, 3, 3, 5), torch.zeros(2, 3, 3).long())


@pytest.mark.parametrize("weights,normalize", [([None, None], True), ([2.0, 6.0], True),
                                               ([2.0, -1.0], False)])
def test_joint_loss_matches_jax(weights, normalize):
    logits, target, probs = _ce_inputs(seed=3)
    mappings = [{"input": "prediction", "target": "target"},
                {"input": "prediction", "target": "soft"}]
    tags = ["hard", None]
    ref_total, ref_tagged = JaxJointLoss(
        [JAX_LOSSES.get("CrossEntropyLoss")(), JAX_LOSSES.get("CrossEntropyLoss")(reduction="sum")],
        mappings, tags, weights, normalize)(
            prediction=jnp.asarray(logits), target=jnp.asarray(target), soft=jnp.asarray(probs))
    joint = JointLoss(
        [LOSSES.get("CrossEntropyLoss")(), LOSSES.get("CrossEntropyLoss")(reduction="sum")],
        mappings, tags, weights, normalize)
    total, tagged = joint(prediction=torch.from_numpy(logits), target=torch.from_numpy(target),
                          soft=torch.from_numpy(probs))
    np.testing.assert_allclose(total.numpy(), np.asarray(ref_total), rtol=1e-6)
    assert set(tagged) == set(ref_tagged) == {"hard"}
    np.testing.assert_allclose(tagged["hard"].numpy(), np.asarray(ref_tagged["hard"]), rtol=1e-6)
    assert joint["hard"] is joint.losses[0]


def test_joint_loss_errors_are_the_jax_ones():
    ce, jce = LOSSES.get("CrossEntropyLoss")(), JAX_LOSSES.get("CrossEntropyLoss")()
    m = [{"input": "prediction", "target": "target"}]
    for make, loss in ((JointLoss, ce), (JaxJointLoss, jce)):
        with pytest.raises(ValueError, match="either specified for each loss"):
            make([loss, loss], m * 2, [None, None], [1.0, None])
        with pytest.raises(ValueError, match="weights sum to 0"):
            make([loss, loss], m * 2, [None, None], [1.0, -1.0])
        joint = make([loss], m, [None], [None])
        with pytest.raises(ValueError, match="Cannot find target for your mapping"):
            joint(prediction=None)
        with pytest.raises(KeyError, match="Cannot access loss x"):
            joint["x"]


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
OPT_CASES = {
    "adam": ("Adam", {}),
    "adam_l2": ("Adam", {"weight_decay": 0.1, "betas": [0.8, 0.95], "eps": 1e-6}),
    "adam_amsgrad_l2": ("Adam", {"amsgrad": True, "weight_decay": 0.1}),
    "adamw_default_decay": ("AdamW", {}),
    "adamw": ("AdamW", {"weight_decay": 0.2}),
    "adamw_amsgrad": ("AdamW", {"amsgrad": True, "weight_decay": 0.2}),
    "sgd": ("SGD", {}),
    "sgd_momentum": ("SGD", {"momentum": 0.9}),
    "sgd_nesterov_l2": ("SGD", {"momentum": 0.9, "nesterov": True, "weight_decay": 0.05}),
    "sgd_dampening_is_ignored": ("SGD", {"momentum": 0.8, "dampening": 0.5}),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_trajectory_matches_optax_chain(case):
    """10 steps on a small parameter tree with the same gradients: the
    port's torch.optim objects against the optax chains of torchok_tpu."""
    name, cfg = OPT_CASES[case]
    rng = np.random.default_rng(5)
    init = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * (1 + step % 3)
              for k, v in init.items()} for step in range(10)]
    lr = 0.05

    tx = JAX_OPTIMIZERS.get(name)(learning_rate=lr, **copy.deepcopy(cfg))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)

    tensors = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in init.items()}
    optimizer = OPTIMIZERS.get(name)([{"params": list(tensors.values())}], lr=lr,
                                     **copy.deepcopy(cfg))
    assert isinstance(optimizer, torch.optim.Optimizer)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k].copy())
        optimizer.step()
        for k in init:
            # same arithmetic in f32, other operation order: 1e-5 relative,
            # or 1e-4 of one step's size (lr = 0.05) near zero
            np.testing.assert_allclose(tensors[k].detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-5, atol=5e-6, err_msg=f"{case} {k}")
    assert np.abs(tensors["w"].detach().numpy() - init["w"]).max() > 1e-2


@pytest.mark.parametrize("name", ["Adamax", "RMSprop", "Adagrad", "Adadelta", "Rprop", "LBFGS",
                                  "ASGD", "SparseAdam", "Lion", "Lamb"])
def test_unported_optimizers_raise(name):
    assert name in JAX_OPTIMIZERS
    with pytest.raises(NotImplementedError, match="not ported yet"):
        OPTIMIZERS.get(name)([{"params": [torch.zeros(1, requires_grad=True)]}], lr=0.1)


def test_optimizer_registries_have_the_same_names():
    assert sorted(OPTIMIZERS.entries) == sorted(JAX_OPTIMIZERS.entries)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------
SCHEDULER_CASES = {
    "LambdaLR": {"lr_lambda": "lambda epoch: 0.95 ** epoch"},
    "MultiplicativeLR": {"lr_lambda": "lambda epoch: 0.9 if epoch % 2 else 1.0"},
    "StepLR": {"step_size": 4, "gamma": 0.5},
    "MultiStepLR": {"milestones": [3, 8, 20], "gamma": 0.3},
    "ConstantLR": {"factor": 0.25, "total_iters": 6},
    "LinearLR": {"start_factor": 0.2, "end_factor": 1.0, "total_iters": 9},
    "ExponentialLR": {"gamma": 0.93},
    "CosineAnnealingLR": {"T_max": 12, "eta_min": 0.001},
    "CosineAnnealingWarmRestarts": {"T_0": 5, "T_mult": 2, "eta_min": 0.002},
    "CyclicLR": {"base_lr": 0.01, "max_lr": 0.2, "step_size_up": 4, "step_size_down": 6,
                 "mode": "triangular2"},
    "OneCycleLR": {"max_lr": 0.3, "total_steps": 25, "pct_start": 0.25},
    "ReduceLROnPlateau": {"mode": "min", "factor": 0.5, "patience": 2, "cooldown": 1,
                          "min_lr": 0.001},
    "CosineLRScheduler": {"t_initial": 10, "lr_min": 0.001, "cycle_mul": 1.5, "cycle_decay": 0.8,
                          "cycle_limit": 3, "warmup_t": 3, "warmup_lr_init": 0.0001},
    "StepLRScheduler": {"decay_t": 5, "decay_rate": 0.6, "warmup_t": 2, "warmup_lr_init": 0.001},
    "MultiStepLRScheduler": {"decay_t": [4, 9, 15], "decay_rate": 0.5, "warmup_t": 2,
                             "warmup_lr_init": 0.001},
    "PolyLRScheduler": {"t_initial": 28, "power": 0.9, "lr_min": 0.0005, "warmup_t": 3,
                        "warmup_lr_init": 0.001},
    "TanhLRScheduler": {"t_initial": 28, "lr_min": 0.0005, "warmup_t": 3,
                        "warmup_lr_init": 0.001},
    "PlateauLRScheduler": {"decay_rate": 0.5, "patience_t": 2, "mode": "max", "cooldown_t": 1,
                           "lr_min": 0.001},
}


def test_scheduler_registries_have_the_same_names():
    assert sorted(SCHEDULERS.entries) == sorted(JAX_SCHEDULERS.entries) == sorted(SCHEDULER_CASES)


@pytest.mark.parametrize("name", list(SCHEDULER_CASES))
def test_scheduler_lr_over_30_steps_equals_jax(name):
    ref = JAX_SCHEDULERS.get(name)(**copy.deepcopy(SCHEDULER_CASES[name]))
    got = SCHEDULERS.get(name)(**copy.deepcopy(SCHEDULER_CASES[name]))
    ref.attach(0.1)
    got.attach(0.1)
    assert got.current_lr == ref.current_lr
    metrics = np.random.default_rng(6).normal(size=30).cumsum()  # for the plateau policies
    for step in range(30):
        metric = float(metrics[step]) if ref.needs_metric else None
        assert got.needs_metric == ref.needs_metric
        assert got.step(metric) == ref.step(metric), f"{name} step {step}"
        assert got.get_last_lr() == ref.get_last_lr()
    # the port's state_dict is the whole policy (every attribute but the
    # callables), which a checkpoint keeps; the reference's is two of them
    assert got.state_dict() == {k: v for k, v in vars(ref).items() if not callable(v)}
    assert ref.state_dict().items() <= got.state_dict().items()


@pytest.mark.parametrize("name", list(SCHEDULER_CASES))
def test_scheduler_state_dict_resumes_the_policy(name):
    """A policy rebuilt from the config and loaded from ``state_dict`` after
    15 steps gives the lrs of the one that ran on (the plateau policies'
    best value, bad epochs and lr included)."""
    metrics = np.random.default_rng(6).normal(size=30).cumsum()
    ran = SCHEDULERS.get(name)(**copy.deepcopy(SCHEDULER_CASES[name]))
    ran.attach(0.1)
    for step in range(15):
        ran.step(float(metrics[step]) if ran.needs_metric else None)
    resumed = SCHEDULERS.get(name)(**copy.deepcopy(SCHEDULER_CASES[name]))
    resumed.attach(0.1)
    resumed.load_state_dict(copy.deepcopy(ran.state_dict()))
    for step in range(15, 30):
        metric = float(metrics[step]) if ran.needs_metric else None
        assert resumed.step(metric) == ran.step(metric), f"{name} step {step}"


def test_parse_lr_lambda_refuses_code():
    assert parse_lr_lambda("lambda e: max(0.1, math.cos(e))")(0) == 1.0
    for bad in ("lambda e: __import__('os')", "lambda e: e.real", "1 + 1"):
        with pytest.raises(ValueError):
            parse_lr_lambda(bad)


# ---------------------------------------------------------------------------
# parameter groups
# ---------------------------------------------------------------------------
BACKBONE = dict(img_size=32, patch_size=4, window_size=4, embed_dim=16, depths=[2, 2],
                num_heads=[2, 4], ape=True)
PARAMWISE_CASES = {
    "no_paramwise_no_decay": ({"lr": 0.01}, None),
    "no_paramwise_decay": ({"lr": 0.01, "weight_decay": 0.05}, None),
    "mults": ({"lr": 0.01, "weight_decay": 0.05},
              {"bias_lr_mult": 2.0, "bias_decay_mult": 0.5, "norm_decay_mult": 0.25}),
    "custom_keys": ({"lr": 0.01, "weight_decay": 0.05},
                    {"custom_keys": {"attn": {"lr_mult": 0.1, "decay_mult": 0.3},
                                     "attn.proj": {"lr_mult": 3.0},
                                     "head": {"lr_mult": 10.0, "decay_mult": 0.0}},
                     "bias_lr_mult": 2.0}),
}


def _jax_labels(params, optimizer_params, no_decay):
    """The label torchok_tpu gives every leaf, read back from the masks of
    its optax.multi_transform (flax path -> label)."""
    tx, group_lrs = JaxConstructor.create_optimizer(params, optimizer_params, no_decay)
    leaves = [tuple(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    if len(group_lrs) == 1:
        return {path: next(iter(group_lrs)) for path in leaves}, group_lrs
    out = {}
    for label, inner in tx.init(params).inner_states.items():
        for path, _ in jax.tree_util.tree_flatten_with_path(inner)[0]:
            keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
            if "mu" in keys:
                out[tuple(str(k) for k in keys[keys.index("mu") + 1:])] = label
    assert sorted(out) == sorted(leaves)
    return out, group_lrs


@pytest.mark.parametrize("case", list(PARAMWISE_CASES))
def test_param_group_labels_equal_jax_leaf_labels(case):
    opt_cfg, paramwise = PARAMWISE_CASES[case]
    spec = {"name": "Adam", "params": opt_cfg}
    if paramwise:
        spec["paramwise_cfg"] = paramwise

    jax_backbone = JAX_BACKBONES.get("swinv2_custom")(**BACKBONE)
    variables = jax_backbone.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params = {"backbone": variables["params"],
              "head": {"fc": {"kernel": jnp.zeros((32, 10)), "bias": jnp.zeros((10,))}}}
    ref, ref_lrs = _jax_labels(params, JaxConfigNode(copy.deepcopy(spec)),
                               jax_backbone.no_weight_decay())

    backbone = BACKBONES.get("swinv2_custom")(**BACKBONE)
    model = torch.nn.ModuleDict({"backbone": backbone,
                                 "head": torch.nn.ModuleDict({"fc": torch.nn.Linear(32, 10)})})
    named = list(model.named_parameters())
    assert backbone.no_weight_decay() == jax_backbone.no_weight_decay()
    got = Constructor.param_labels(named, ConfigNode(copy.deepcopy(spec)),
                                   backbone.no_weight_decay())
    name_map = task_name_map("swinv2_custom", {"params": params})
    assert sorted(name_map) == sorted(got)
    for key, path in name_map.items():
        assert got[key] == ref[path], f"{key} <- {'.'.join(path)}"
    assert len(set(got.values())) == len(ref_lrs) and (case == "no_paramwise_no_decay"
                                                       or len(ref_lrs) > 1)

    optimizer, lrs = Constructor.create_optimizer(named, ConfigNode(copy.deepcopy(spec)),
                                                  backbone.no_weight_decay())
    assert lrs == pytest.approx(ref_lrs)
    assert [g["label"] for g in optimizer.param_groups] == sorted(ref_lrs)
    assert sum(len(g["params"]) for g in optimizer.param_groups) == len(named)
    for group in optimizer.param_groups:
        decay_mult = float(group["label"].split("_")[1][2:])
        assert group["lr"] == group["base_lr"] == pytest.approx(lrs[group["label"]])
        want = opt_cfg["weight_decay"] * decay_mult if "weight_decay" in opt_cfg else 0.0
        assert group["weight_decay"] == pytest.approx(want)


def test_configure_optimizers_builds_the_scheduler_bundle():
    cfg = ConfigNode({"optimization": [{
        "optimizer": {"name": "SGD", "params": {"lr": 0.2, "momentum": 0.9}},
        "scheduler": {"name": "StepLR", "params": {"step_size": 2, "gamma": 0.1},
                      "pl_params": {"interval": "step", "frequency": 3, "monitor": "valid/loss"}}}]})
    lin = torch.nn.Linear(3, 2)
    (bundle,) = Constructor(cfg).configure_optimizers(lin.named_parameters())
    assert isinstance(bundle.optimizer, torch.optim.SGD)
    assert (bundle.scheduler_interval, bundle.scheduler_frequency, bundle.scheduler_monitor) \
        == ("step", 3, "valid/loss")
    assert bundle.scheduler.base_lr == 0.2 and bundle.group_base_lrs == {"lr1.0_wd1.0": 0.2,
                                                                       "lr1.0_wd0.0": 0.2}
    with pytest.raises(ValueError, match="index 4"):
        Constructor(cfg).configure_optimizers(lin.named_parameters(), optim_idx=4)
