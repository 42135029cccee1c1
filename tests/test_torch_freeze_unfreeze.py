"""FreezeUnfreeze and BackboneFinetuning in the port against ``torchok_tpu``.

* Three-step SGD fits (momentum, weight decay) under ``stages: 1`` and a
  backbone frozen until epoch 2, on a tiny ViT classifier and a tiny
  ResNet: parameters and BatchNorm running statistics equal the JAX
  package's after every step (one step an epoch), within 2e-5. A frozen
  parameter still moves by its weight decay and momentum, and a frozen
  BatchNorm keeps its running statistics, in both.
* The frozen sets of both packages, carried across by the bridge, over every
  ported backbone family under the policies of the five recipes that ask for
  FreezeUnfreeze: equal, except where the port decides on purpose otherwise
  (a ``module_class`` by type, not by name fragments; whole path segments).
* The recipes: every component name of the three COCO FCOS recipes
  resolves; the freeze policies of ``representation_arcface_sop.yaml`` and
  ``classification_cifar10_multi_validation.yaml`` resolve and act, and the
  names those two recipes still lack are listed in ``ROADMAP.md``.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torchok_tpu  # noqa: F401 — registers the JAX components
from torchok_tpu.callbacks import common as jax_common
from torchok_tpu.callbacks.freeze_unfreeze import FreezeUnfreeze as JaxFreezeUnfreeze
from torchok_tpu.constructor import BACKBONES as JAX_BACKBONES
from torchok_tpu.constructor import TASKS as JAX_TASKS
from torchok_tpu.constructor.config import ConfigNode as JaxConfigNode
from torchok_tpu.constructor.config_structure import merge_structured as jax_merge
from torchok_tpu.constructor.runner import create_trainer as jax_create_trainer
from torchok_tpu.engine.callbacks import Callback as JaxCallback
from torchok_tpu.tasks.base import BaseTask as JaxBaseTask
from torchok_tpu_torch import constructor as port_registries
from torchok_tpu_torch.__main__ import run
from torchok_tpu_torch.constructor import BACKBONES, CALLBACKS
from torchok_tpu_torch.constructor.config import load_config
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.engine.state import TrainState
from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
from torchok_tpu_torch.utils.flax_convert import state_dict_to_task_flax, task_flax_to_state_dict
from torchok_tpu_torch.utils.flax_convert import task_name_map

REPO = Path(__file__).resolve().parent.parent
VIT = dict(embed_dim=32, depth=2, num_heads=2, patch_size=8, img_size=32, pretrained=False)
RESNET = dict(layers=[1, 1, 1, 1], pretrained=False)
POLICIES = [{"module_name": "backbone", "stages": 1},
            {"module_name": "backbone", "epoch": 2}]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _jitted_jax_init(monkeypatch):
    """One jitted init instead of Flax's op-by-op one (see
    ``tests/test_torch_train_slice.py``)."""
    init = JaxBaseTask.init_variables
    monkeypatch.setattr(JaxBaseTask, "init_variables", lambda self, rng, batch=None:
                        jax.jit(lambda key: init(self, key, batch))(rng))


def fit_config(backbone_name, backbone_params, size, pooling, batch):
    data = lambda n, seed: [{  # noqa: E731
        "dataloader": {"batch_size": batch, "num_workers": 0, "shuffle": False,
                       "drop_last": True},
        "dataset": {"name": "SyntheticClassificationDataset",
                    "params": {"num_samples": n, "num_classes": 10, "image_size": [size, size],
                               "seed": seed},
                    "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}}]
    params = {"backbone_name": backbone_name, "backbone_params": copy.deepcopy(backbone_params),
              "head_name": "ClassificationHead", "head_params": {"num_classes": 10},
              "inputs": [{"shape": [3, size, size], "dtype": "float32"}]}
    if pooling:
        params["pooling_name"] = "Pooling"
    return {
        "task": {"name": "ClassificationTask", "params": params},
        "joint_loss": {"losses": [{"name": "CrossEntropyLoss", "tag": "ce",
                                   "mapping": {"input": "prediction", "target": "target"}}]},
        "optimization": [{"optimizer": {"name": "SGD", "params": {
            "lr": 0.01, "momentum": 0.9, "weight_decay": 0.05}}}],
        # one step an epoch, three epochs: the backbone unfreezes at the third
        "data": {"TRAIN": data(batch, 3)},
        "trainer": {"accelerator": "cpu", "precision": 32, "max_epochs": 3,
                    "num_sanity_val_steps": 0, "gradient_clip_val": 2.0},
        "seed_params": {"seed": 7},
        "callbacks": [{"name": "FreezeUnfreeze",
                       "params": {"freeze_modules": copy.deepcopy(POLICIES)}}],
    }


class JaxSnapshots(JaxCallback):
    def __init__(self):
        self.steps = []

    def on_epoch_end(self, trainer, task, logs):
        state = trainer.state
        self.steps.append({c: jax.tree_util.tree_map(np.asarray, getattr(state, c))
                           for c in ("params", "batch_stats")})


class PortSnapshots(Callback):
    def __init__(self):
        self.steps = []

    def on_epoch_end(self, trainer, task, logs):
        self.steps.append({k: v.detach().clone() for k, v in
                           trainer.state.model.state_dict().items()})


def fit_both(cfg, tmp_path):
    config = jax_merge(JaxConfigNode(copy.deepcopy(cfg)))
    task = JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    trainer = jax_create_trainer(config)
    snaps = JaxSnapshots()
    trainer.callbacks.append(snaps)
    initial = {}
    setup = trainer._setup_state

    def setup_and_capture(task_, ckpt_path=None):
        setup(task_, ckpt_path)
        initial.update({c: jax.tree_util.tree_map(np.asarray, getattr(trainer.state, c))
                        for c in ("params", "batch_stats")})

    trainer._setup_state = setup_and_capture
    trainer.fit(task)

    name = cfg["task"]["params"]["backbone_name"]
    sd = task_flax_to_state_dict(name, {c: v for c, v in initial.items() if v})
    ckpt = tmp_path / "initial.pt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    port_cfg = dict(copy.deepcopy(cfg), resume_path=str(ckpt))
    port_snaps = PortSnapshots()
    port_trainer, _ = run(port_cfg, "train", [port_snaps])
    return initial, snaps.steps, port_snaps.steps, port_trainer


def _leaves(tree):
    return {tuple(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("case", ["vit", "resnet"])
def test_three_step_fit_under_freeze_policies_matches_torchok_tpu(case, tmp_path):
    if case == "vit":
        cfg = fit_config("vit_tiny_patch16_224", VIT, 32, pooling=False, batch=4)
        frozen_probe = "blocks_0"
    else:  # BatchNorm over 8 images: 8 values at the 1x1 last stage
        cfg = fit_config("resnet18", RESNET, 32, pooling=True, batch=8)
        frozen_probe = "layer1_0"
    initial, jax_steps, port_steps, trainer = fit_both(cfg, tmp_path)
    assert len(jax_steps) == len(port_steps) == 3
    name = cfg["task"]["params"]["backbone_name"]
    collections = [c for c in ("params", "batch_stats") if initial[c]]
    init_leaves = {c: _leaves(initial[c]) for c in collections}
    for step, (ref, got) in enumerate(zip(jax_steps, port_steps)):
        for c in collections:
            back = _leaves(state_dict_to_task_flax(name, got, initial, c))
            want = _leaves(ref[c])
            assert set(back) == set(want)
            for path, leaf in want.items():
                assert np.abs(back[path] - leaf).max() <= 2e-5, (step, c, path)
                if path[0] != "backbone":
                    continue
                moved = not np.array_equal(leaf, init_leaves[c][path])
                stage1 = frozen_probe in path or path[1] in ("patch_embed", "conv1", "bn1")
                if c == "batch_stats" and (step < 2 or stage1):
                    # a frozen norm keeps its statistics, bit for bit, in both
                    assert not moved and np.array_equal(back[path], leaf), (step, path)
                if c == "params" and path[-1] == "kernel":
                    # frozen weights still move: their decay and momentum
                    assert moved, (step, path)
    assert trainer.state.frozen_params and all(
        n.startswith("backbone.") for n in trainer.state.frozen_params)


# ----------------------------------------------------------------------
# the frozen sets over every ported backbone family
# ----------------------------------------------------------------------

# narrow members of each family, both packages built from the same keywords
FAMILIES = {
    "resnet18": (RESNET, 64),
    "efficientnet_b0": ({}, 64),
    "mobilenetv3_large_100": ({}, 64),
    "hrnet_w18_small": ({}, 64),
    "swinv2_custom": (dict(img_size=32, patch_size=4, window_size=4, embed_dim=16,
                           depths=[2, 2], num_heads=[2, 4]), 32),
    "gcvit_xxtiny": (dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), img_size=32,
                          window_ratio=(8, 8)), 32),
    "davit_t": (dict(embed_dims=(16, 32), depths=(1, 1), num_heads=(2, 4), window_size=4), 32),
    "vit_tiny_patch16_224": (dict(VIT, depth=12), 32),
    "beit_base_patch16_224": (dict(VIT, depth=12, use_shared_rel_pos_bias=True), 32),
}
ARCFACE_SOP = [{"module_name": "backbone", "epoch": 2},
               {"module_name": "backbone", "stage": 1},
               {"module_name": "backbone", "module_class": "_BatchNorm",
                "bn_requires_grad": False, "bn_track_running_stats": False},
               {"module_name": "", "module_class": "Dropout"}]
# the five recipes' policies: the three COCO FCOS recipes share one
RECIPE_POLICIES = {
    "fcos_coco": [{"module_name": "backbone", "stages": 1}],
    "representation_arcface_sop": ARCFACE_SOP,
    "classification_cifar10_multi_validation": ARCFACE_SOP[:1] + [
        {"module_name": "backbone", "stages": 1}] + ARCFACE_SOP[2:3],
}


class _Stub:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.fixture(scope="module")
def families():
    """Each family's JAX variables (shapes only: eval_shape traces the init)
    and port model."""
    out = {}
    for name, (kw, size) in FAMILIES.items():
        flax_model = JAX_BACKBONES.get(name)(**{**kw, "pretrained": False})
        variables = jax.eval_shape(lambda x, m=flax_model: m.init(
            jax.random.PRNGKey(0), x, train=False), jnp.zeros((1, size, size, 3)))
        port = nn.Module()
        port.backbone = BACKBONES.get(name)(**{**kw, "pretrained": False})
        out[name] = (flax_model, variables, port)
    return out


def jax_masks(flax_model, variables, policies, epoch):
    """The JAX package's frozen leaf paths (grad_mask 0) and frozen
    statistics paths (bn_mask 0)."""
    state = _Stub(params={"backbone": variables["params"]},
                  batch_stats={"backbone": variables.get("batch_stats", {})})
    trainer = _Stub(state=state, current_epoch=epoch)
    gm, bm = JaxFreezeUnfreeze(copy.deepcopy(policies))._compute_masks(
        trainer, _Stub(_backbone=flax_model))
    return ({k for k, v in _leaves(gm).items() if float(v) == 0.0},
            {k for k, v in _leaves(bm).items() if float(v) == 0.0})


def port_masks(name, variables, port, policies, epoch):
    """The port's, carried to Flax paths by the bridge."""
    params, stats = CALLBACKS.get("FreezeUnfreeze")(copy.deepcopy(policies)).masks(
        _Stub(model=port), epoch)
    task_vars = {c: {"backbone": v} for c, v in variables.items()}
    names = task_name_map(name, task_vars, "params")
    stat_names = task_name_map(name, task_vars, "batch_stats") if "batch_stats" in task_vars \
        else {}
    assert params <= set(names)
    stat_paths = {path for key, path in stat_names.items()
                  if key.rsplit(".", 1)[0] in stats}
    return {names[n] for n in params}, stat_paths


def named_exceptions(name, port, policies):
    """Where the port decides otherwise on purpose: under a ``_BatchNorm``
    policy the JAX package also freezes every leaf whose Flax path holds a
    ``norm`` or ``bn`` fragment though it is no BatchNorm (LayerNorms,
    GroupNorms): the port goes by type. Returned as port parameter names."""
    if not any(p.get("module_class") == "_BatchNorm" for p in policies):
        return set()
    out = set()
    for mname, m in port.named_modules():
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)) and mname.startswith("backbone."):
            out |= {f"{mname}.{p}" for p, _ in m.named_parameters(recurse=False)}
    return out


@pytest.mark.parametrize("recipe", list(RECIPE_POLICIES))
@pytest.mark.parametrize("epoch", [0, 2])
def test_frozen_sets_equal_the_jax_packages_over_every_backbone(families, recipe, epoch):
    policies = RECIPE_POLICIES[recipe]
    for name, (flax_model, variables, port) in families.items():
        want_params, want_stats = jax_masks(flax_model, variables, policies, epoch)
        got_params, got_stats = port_masks(name, variables, port, policies, epoch)
        names = task_name_map(name, {c: {"backbone": v} for c, v in variables.items()})
        exceptions = {names[n] for n in named_exceptions(name, port, policies)}
        # the port freezes nothing the JAX package does not; the JAX package
        # freezes more only at the named leaves
        assert got_params <= want_params and want_params - got_params <= exceptions, name
        assert got_stats == want_stats, name
        if recipe == "fcos_coco":
            assert got_params, name  # the stem and the first stage, in every family


def test_whole_segments_not_string_prefixes(families):
    """``stages: 2`` on a 12-block ViT: the JAX package's ``blocks_1`` is a
    string prefix of ``blocks_10`` and ``blocks_11`` too; the port freezes
    blocks 0 and 1 only."""
    flax_model, variables, port = families["vit_tiny_patch16_224"]
    policies = [{"module_name": "backbone", "stages": 2}]
    want, _ = jax_masks(flax_model, variables, policies, 0)
    got, _ = port_masks("vit_tiny_patch16_224", variables, port, policies, 0)
    blocks = lambda paths: sorted({p[1] for p in paths if p[1].startswith("blocks")})  # noqa
    assert blocks(want) == ["blocks_0", "blocks_1", "blocks_10", "blocks_11"]
    assert blocks(got) == ["blocks_0", "blocks_1"]
    assert want - got == {p for p in want if p[1] in ("blocks_10", "blocks_11")}


def test_module_class_by_type_not_by_name(families):
    """``_BatchNorm`` on a ViT: the JAX package freezes its LayerNorms
    (``norm1``, ``norm2``, ``norm`` hold the fragment ``norm``); the port
    finds no BatchNorm there and freezes nothing. On a ResNet both freeze
    the same BatchNorms and their statistics."""
    policies = [ARCFACE_SOP[2]]
    flax_model, variables, port = families["vit_tiny_patch16_224"]
    want, _ = jax_masks(flax_model, variables, policies, 0)
    got, _ = port_masks("vit_tiny_patch16_224", variables, port, policies, 0)
    assert got == set() and want
    assert {p[-2] for p in want} == {"norm1", "norm2", "norm"}
    flax_model, variables, port = families["resnet18"]
    want, want_stats = jax_masks(flax_model, variables, policies, 0)
    got, got_stats = port_masks("resnet18", variables, port, policies, 0)
    assert got == want and got_stats == want_stats and len(got_stats) == 2 * 12


def test_model_summary_counts_the_mask(capsys, families):
    """Trainable parameters follow the grad mask in both packages."""
    flax_model, variables, port = families["resnet18"]
    policies = [{"module_name": "backbone", "stages": 1}]
    gm = JaxFreezeUnfreeze(copy.deepcopy(policies))._compute_masks(
        _Stub(state=_Stub(params={"backbone": variables["params"]},
                          batch_stats={"backbone": variables["batch_stats"]}),
              current_epoch=0), _Stub(_backbone=flax_model))[0]
    state = _Stub(params={"backbone": variables["params"]},
                  batch_stats={"backbone": variables["batch_stats"]}, buffers={}, grad_mask=gm)
    jax_common.ModelSummary().on_fit_start(_Stub(state=state), None)
    ref = capsys.readouterr().out.splitlines()
    params, stats = CALLBACKS.get("FreezeUnfreeze")(policies).masks(_Stub(model=port), 0)
    train_state = TrainState(model=port)
    train_state.set_masks(params, stats)
    CALLBACKS.get("ModelSummary")().on_fit_start(_Stub(state=train_state), None)
    got = capsys.readouterr().out.splitlines()
    assert got[-4:] == ref[-4:]
    assert not got[-3].startswith("Non-trainable params: 0.00M")
    frozen_bn = port.backbone.layer1[0].bn1
    assert not frozen_bn.update_running_stats and port.backbone.layer2[0].bn1.update_running_stats
    assert not port.backbone.conv1.weight.requires_grad


def test_both_callbacks_resolve_and_backbone_finetuning_unfreezes():
    import torchok_tpu_torch  # noqa: F401
    port = nn.Module()
    port.backbone = BACKBONES.get("resnet18")(**RESNET)
    port.head = nn.Linear(4, 2)
    state = TrainState(model=port)
    cb = CALLBACKS.get("BackboneFinetuning")(unfreeze_backbone_at_epoch=1)
    for epoch, frozen in ((0, True), (1, False)):
        cb.on_train_epoch_start(_Stub(state=state, current_epoch=epoch), _Stub(model=port))
        assert all((n in state.frozen_params) == (frozen and n.startswith("backbone."))
                   for n, _ in port.named_parameters())
        assert all(m.update_running_stats != frozen for m in port.modules()
                   if isinstance(m, BatchNorm2d))


def test_frozen_weights_follow_decay_with_accumulation_and_steps_per_execution(tmp_path):
    """The mask acts on the accumulated gradient, before the clip, and in
    the ``steps_per_execution`` path: a frozen 4-D weight's SGD trajectory
    is the decay-only one, recomputed here; a frozen bias with no decay
    stays."""
    cfg = fit_config("resnet18", RESNET, 32, pooling=True, batch=4)
    cfg["data"]["TRAIN"][0]["dataset"]["params"]["num_samples"] = 16
    cfg["trainer"].update(max_epochs=1, accumulate_grad_batches=2, steps_per_execution=2)
    cfg["optimization"][0]["optimizer"]["paramwise_cfg"] = {"bias_decay_mult": 0.0}
    cfg["callbacks"][0]["params"]["freeze_modules"] = [{"module_name": "backbone", "stages": 1}]
    snaps = PortSnapshots()

    class First(Callback):
        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.state_dict().items()}

    first = First()
    trainer, _ = run(cfg, "train", [first, snaps])
    assert trainer.global_step == 4  # two optimizer steps of two micro-batches
    final = snaps.steps[-1]
    w0 = first.initial["backbone.conv1.weight"].double()
    p, buf = w0.clone(), None
    for _ in range(2):  # SGD: d = wd p; buf = 0.9 buf + d; p -= lr buf
        d = 0.05 * p
        buf = d if buf is None else 0.9 * buf + d
        p = p - 0.01 * buf
    got = final["backbone.conv1.weight"].double()
    assert (got - p).abs().max() <= 1e-6 * w0.abs().max()
    assert not torch.equal(got, w0.float().double())
    assert torch.equal(final["backbone.bn1.bias"], first.initial["backbone.bn1.bias"])
    assert not torch.equal(final["backbone.layer2.0.conv1.weight"],
                           first.initial["backbone.layer2.0.conv1.weight"])


# ----------------------------------------------------------------------
# the recipes
# ----------------------------------------------------------------------

def _names(node, key="name"):
    """Every ``name`` value in a config subtree."""
    if isinstance(node, dict):
        out = [node[key]] if isinstance(node.get(key), str) else []
        for v in node.values():
            out += _names(v, key)
        return out
    if isinstance(node, list):
        return [n for v in node for n in _names(v, key)]
    return []


def recipe_names(recipe):
    """(registry, name) of every component a recipe asks for."""
    cfg = load_config(REPO / "configs" / Path(recipe).parent, Path(recipe).name).to_dict()
    task = cfg["task"]["params"]
    out = [("TASKS", cfg["task"]["name"]), ("BACKBONES", task["backbone_name"])]
    for key, reg in (("neck_name", "DETECTION_NECKS"), ("pooling_name", "POOLINGS"),
                     ("head_name", "HEADS")):
        if task.get(key):
            out.append((reg, task[key]))
    out += [("LOSSES", n) for n in _names(cfg.get("joint_loss"))]
    for op in cfg.get("optimization") or []:
        out.append(("OPTIMIZERS", op["optimizer"]["name"]))
        if op.get("scheduler"):
            out.append(("SCHEDULERS", op["scheduler"]["name"]))
    for loaders in (cfg.get("data") or {}).values():
        for loader in loaders:
            out.append(("DATASETS", loader["dataset"]["name"]))
            for key in ("augment", "transform"):
                out += [("TRANSFORMS", n) for n in _names(loader["dataset"].get(key))]
    out += [("CALLBACKS", c["name"]) for c in cfg.get("callbacks") or []]
    out += [("METRICS", m["name"]) for m in cfg.get("metrics") or []]
    out.append(("LOGGERS", cfg["logger"]["name"]))
    return cfg, out


def resolves(registry, name):
    return name in getattr(port_registries, registry)


@pytest.mark.parametrize("recipe", ["detection/fcos_resnet50_coco", "detection/fcos_gcvit-t_coco",
                                    "detection/fcos_vit-s_coco"])
def test_coco_fcos_recipes_resolve_every_name(recipe, monkeypatch):
    monkeypatch.setenv("HOME", "/nonexistent")
    _, names = recipe_names(recipe)
    missing = [(r, n) for r, n in names if not resolves(r, n)]
    assert not missing
    assert ("CALLBACKS", "FreezeUnfreeze") in names


@pytest.mark.parametrize("recipe", ["representation_arcface_sop",
                                    "classification_cifar10_multi_validation"])
def test_freeze_policies_of_the_other_recipes_resolve(recipe, monkeypatch):
    monkeypatch.setenv("HOME", "/nonexistent")
    cfg, names = recipe_names(recipe)
    policies = next(c["params"]["freeze_modules"] for c in cfg["callbacks"]
                    if c["name"] == "FreezeUnfreeze")
    callback = CALLBACKS.get("FreezeUnfreeze")(freeze_modules=policies)
    model = nn.Module()
    model.backbone = BACKBONES.get(cfg["task"]["params"]["backbone_name"])()
    model.head = nn.Linear(4, 2)
    norms = {n for n, m in model.named_modules() if isinstance(m, BatchNorm2d)}
    for epoch in (0, 2):
        params, stats = callback.masks(_Stub(model=model), epoch)
        assert stats == norms  # _BatchNorm with bn_track_running_stats false
        assert not any(n.startswith("head.") for n in params)
        bn_params = {f"{n}.{p}" for n in norms for p in ("weight", "bias")}
        assert bn_params <= params
    assert len(callback.masks(_Stub(model=model), 0)[0]) > len(params)  # the epoch policy
    # every name of both recipes resolves now (SOP, ModelCheckpointWithOnnx)
    missing = sorted({n for r, n in names if not resolves(r, n)})
    assert not missing
