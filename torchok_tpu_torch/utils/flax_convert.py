"""Flax variables -> PyTorch state_dict for the port's modules (numpy only).

The inverse of ``torchok_tpu.utils.torch_convert`` (``map_swin``,
``map_gcvit``, ``map_davit``, ``map_resnet`` and the layout adaptation in
``fit_tensor``): it
carries a ``torchok_tpu`` model's parameters into ``torchok_tpu_torch``, whose
modules use the timm or reference key names.

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
* 1-D conv ``kernel`` (k, in, out) -> Conv1d ``weight`` (out, in, k) (the
  EcaModule's);
* LayerNorm, BatchNorm and GroupNorm ``scale`` -> ``weight``; ``bias`` stays
  ``bias``;
* the ``batch_stats`` collection: BatchNorm ``mean``/``var`` ->
  ``running_mean``/``running_var`` of the module of the same path;
* family-specific path renames (SwinV2: ``layers_0_blocks_1`` ->
  ``layers.0.blocks.1``, ``cpb_mlp_0``/``cpb_mlp_1`` -> ``cpb_mlp.0``/``.2``,
  ``patch_embed``/``patch_norm`` -> ``patch_embed.proj``/``patch_embed.norm``;
  GCViT: ``stages_1`` -> ``stages.1``, ``blocks_2`` -> ``blocks.2``,
  ``global_block/conv1`` -> ``global_block.blocks.conv1``; DaViT:
  ``stage_2_spatial_0`` -> ``main_blocks.2.0.0`` (channel: ``.1``),
  ``patch_embed_1``/``patch_norm_1`` -> ``patch_embeds.1.proj``/``.norm``,
  ``cpe1``/``cpe2`` -> ``cpe.0``/``cpe.1``; the ResNet family: ``layer1_0`` ->
  ``layer1.0``, the deep stem's ``conv1_k``/``bn1_k`` -> ``conv1.{3k}``/
  ``conv1.{3k+1}``, ``stem_pool_conv``/``stem_pool_bn`` -> ``maxpool.0``/
  ``maxpool.1``, ``downsample/conv``/``downsample/bn`` -> ``downsample.0``/
  ``.1``, or ``.1``/``.2`` where the registry entry has ``avg_down``).
  Depthwise and 1x1 conv kernels take the same HWIO -> OIHW rule;
  ``relative_position_bias_table`` and ``gamma`` carry over as they are.

The transformer families have ``params`` only; the ResNet family also has
``batch_stats``, and both collections carry over. ``task_name_map`` gives the
same correspondence by name (port key -> Flax path) for one collection and
``state_dict_to_task_flax`` carries a port ``state_dict`` back into the Flax
tree of that collection, so parameters, gradients and running statistics can
be compared leaf by leaf after training in either package.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
COLLECTIONS = ("params", "batch_stats")
_RESNET = r"^(resnet|resnext|seresne|ecaresne|senet|wide_resnet|(tv|ssl|swsl|ig)_resne)"


def _swin_path(parts: List[str]) -> List[str]:
    out: List[str] = []
    for p in parts:
        if (m := re.fullmatch(r"layers_(\d+)_blocks_(\d+)", p)):
            out += ["layers", m[1], "blocks", m[2]]
        elif (m := re.fullmatch(r"layers_(\d+)_downsample", p)):
            out += ["layers", m[1], "downsample"]
        elif (m := re.fullmatch(r"cpb_mlp_(\d+)", p)):
            out += ["cpb_mlp", str(2 * int(m[1]))]
        elif (m := re.fullmatch(r"feature_norms_(\d+)", p)):
            out += ["feature_norms", m[1]]
        elif p == "patch_embed":
            out += ["patch_embed", "proj"]
        elif p == "patch_norm":
            out += ["patch_embed", "norm"]
        else:
            out.append(p)
    return out


def _gcvit_path(parts: List[str]) -> List[str]:
    out: List[str] = []
    for prev, p in zip([""] + parts, parts):
        if (m := re.fullmatch(r"(stages|blocks)_(\d+)", p)):
            out += [m[1], m[2]]
        elif prev == "global_block" and re.fullmatch(r"conv\d+", p):
            out += ["blocks", p]
        else:
            out.append(p)
    return out


def _davit_path(parts: List[str]) -> List[str]:
    out: List[str] = []
    for p in parts:
        if (m := re.fullmatch(r"stage_(\d+)_(spatial|channel)_(\d+)", p)):
            out += ["main_blocks", m[1], m[3], "0" if m[2] == "spatial" else "1"]
        elif (m := re.fullmatch(r"patch_(embed|norm)_(\d+)", p)):
            out += ["patch_embeds", m[2], "proj" if m[1] == "embed" else "norm"]
        elif (m := re.fullmatch(r"cpe(\d+)", p)):
            out += ["cpe", str(int(m[1]) - 1)]
        else:
            out.append(p)
    return out


def _resnet_path(avg_down: bool) -> Callable[[List[str]], List[str]]:
    conv_at, bn_at = ("1", "2") if avg_down else ("0", "1")

    def mapper(parts: List[str]) -> List[str]:
        out: List[str] = []
        for prev, p in zip([""] + parts, parts):
            if (m := re.fullmatch(r"layer(\d+)_(\d+)", p)):
                out += [f"layer{m[1]}", m[2]]
            elif prev == "downsample" and p in ("conv", "bn"):
                out.append(conv_at if p == "conv" else bn_at)
            elif (m := re.fullmatch(r"(conv|bn)1_(\d+)", p)):
                out += ["conv1", str(3 * int(m[2]) + (m[1] == "bn"))]
            elif p in ("stem_pool_conv", "stem_pool_bn"):
                out += ["maxpool", "0" if p == "stem_pool_conv" else "1"]
            else:
                out.append(p)
        return out

    return mapper


def _plain_path(parts: List[str]) -> List[str]:
    return list(parts)


_FAMILY_PATHS: List[Tuple[str, Callable[[List[str]], List[str]]]] = [
    (r"^swinv2", _swin_path),
    (r"^gcvit", _gcvit_path),
    (r"^davit", _davit_path),
]


def _path_mapper(name: str) -> Callable[[List[str]], List[str]]:
    for pat, fn in _FAMILY_PATHS:
        if re.match(pat, name):
            return fn
    if re.match(_RESNET, name):
        # where the shortcut's conv sits follows the registry entry's avg_down
        from torchok_tpu_torch.models.backbones.resnet import variant_config
        return _resnet_path(bool(variant_config(name).get("avg_down", False)))
    return _plain_path


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _torch_layout(leaf_name: str, value: np.ndarray) -> np.ndarray:
    if leaf_name == "kernel":
        if value.ndim == 2:
            return value.T  # Dense (in, out) -> Linear (out, in)
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)  # Conv HWIO -> OIHW
        if value.ndim == 3:
            return value.transpose(2, 1, 0)  # 1-D conv (k, in, out) -> (out, in, k)
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    return value


def _flax_layout(leaf_name: str, value: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_torch_layout`."""
    if leaf_name == "kernel":
        if value.ndim == 2:
            return value.T
        if value.ndim == 4:
            return value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        if value.ndim == 3:
            return value.transpose(2, 1, 0)
        raise ValueError(f"unexpected weight rank {value.ndim}")
    return value


def _key(mapper: Callable[[List[str]], List[str]], path: Tuple[str, ...], prefix: str) -> str:
    return prefix + ".".join(mapper(list(path[:-1])) + [_LEAF.get(path[-1], path[-1])])


def _collections(variables: Mapping[str, Any]) -> Dict[str, Mapping[str, Any]]:
    """``{"params": tree, "batch_stats": tree}`` (those present and not
    empty) of a variables dict, or of a bare params tree."""
    if "params" not in variables:
        return {"params": variables}
    return {c: variables[c] for c in COLLECTIONS if variables.get(c)}


def flax_to_state_dict(name: str, variables: Mapping[str, Any],
                       prefix: str = "") -> Dict[str, np.ndarray]:
    """Convert the Flax variables of module ``name`` (a registry name such as
    ``swinv2_tiny_window8_256``, or a head/pooling class name) into the
    port's state_dict entries, each key prefixed by ``prefix``.

    ``variables`` is ``{"params": ..., "batch_stats": ...}`` (the second
    optional) or the params tree itself; leaves may be numpy or anything
    ``np.asarray`` accepts."""
    mapper = _path_mapper(name)
    out: Dict[str, np.ndarray] = {}
    for tree in _collections(variables).values():
        for path, leaf in _leaves(tree):
            value = np.ascontiguousarray(_torch_layout(path[-1], np.array(leaf, np.float32)))
            out[_key(mapper, path, prefix)] = value
    return out


def task_flax_to_state_dict(backbone_name: str,
                            variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Carry a whole classification model (``backbone``, ``pooling``,
    ``head`` sub-trees of a ``torchok_tpu`` task's params and, where it has
    them, batch_stats) into the state_dict of the port's
    ``ClassificationModel``."""
    out: Dict[str, np.ndarray] = {}
    for tree in _collections(variables).values():
        for part, sub in tree.items():
            name = backbone_name if part == "backbone" else part
            out.update(flax_to_state_dict(name, sub, prefix=f"{part}."))
    return out


def task_name_map(backbone_name: str, variables: Mapping[str, Any],
                  collection: str = "params") -> Dict[str, Tuple[str, ...]]:
    """Port ``state_dict`` key -> path of the same leaf in one collection of
    a classification task's Flax variables (``("backbone",
    "layers_0_blocks_0", ...)``)."""
    out: Dict[str, Tuple[str, ...]] = {}
    for part, tree in _collections(variables).get(collection, {}).items():
        mapper = _path_mapper(backbone_name if part == "backbone" else part)
        for path, _ in _leaves(tree):
            out[_key(mapper, path, f"{part}.")] = (part,) + path
    return out


def state_dict_to_task_flax(backbone_name: str, state_dict: Mapping[str, Any],
                            variables: Mapping[str, Any],
                            collection: str = "params") -> Dict[str, Any]:
    """Carry a port ``state_dict`` (values ``np.asarray`` accepts) back into
    a nested dict shaped like one collection of the Flax ``variables``."""
    out: Dict[str, Any] = {}
    for key, path in task_name_map(backbone_name, variables, collection).items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(
            _flax_layout(path[-1], np.asarray(state_dict[key], np.float32)))
    return out
