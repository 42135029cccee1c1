"""Flax variables -> PyTorch state_dict for the port's modules (numpy only).

The inverse of ``torchok_tpu.utils.torch_convert`` (``map_swin``,
``map_gcvit``, ``map_davit``, ``map_resnet``, ``map_vit`` and the layout adaptation in
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
  ``.1``, or ``.1``/``.2`` where the registry entry has ``avg_down``; the
  EfficientNet and MobileNetV3 families: ``blocks_2_1`` -> ``blocks.2.1``;
  HRNet: ``layer1_0`` -> ``layer1.0``, ``transition1/t_0_conv`` ->
  ``transition1.0.0`` (``t_{n}`` of ``transition{n}``, a new branch, ->
  ``transition{n}.{n}.0.0``), ``stage2_0/branch_1_block_0`` ->
  ``stage2.0.branches.1.0``, ``fuse/fuse_1_0_0_conv`` ->
  ``fuse_layers.1.0.0.0`` and ``fuse/fuse_0_1_bn`` -> ``fuse_layers.0.1.1``;
  the necks: ``downsample/conv``/``downsample/bn`` -> ``downsample.0``/``.1``;
  the FPN: ``lateral_{i}`` -> ``lateral_convs.{i}.conv``, ``fpn_conv_{i}`` ->
  ``fpn_convs.{i}.conv``, ``extra_conv_{i}`` -> ``fpn_convs.{n + i}.conv``
  after its n laterals; the FCOS head (``bbox_head``): ``cls_conv_{i}``/
  ``cls_gn_{i}`` -> ``cls_convs.{i}.conv``/``.gn``, the same for ``reg_``,
  ``scale_{i}/scale`` -> ``scales.{i}.scale``: mmdet's names); the DETR
  head (a ``bbox_head`` with ``query_embed``) by :func:`_detr_to_torch`:
  ``encoder_{i}``/``decoder_{i}`` -> ``transformer.{encoder,decoder}.layers.{i}``,
  ``self_attn``/``cross_attn`` -> ``attentions.0``/``.1`` (``.attn``), the
  DenseGeneral ``query``/``key``/``value`` kernels (E, H, D) and biases
  (H, D) packed into ``in_proj_weight`` (3E, E) and ``in_proj_bias`` (3E),
  ``out`` (H, D, E) -> ``out_proj`` (E, E), ``norm{k}`` -> ``norms.{k-1}``,
  ``ffn1``/``ffn2`` -> ``ffns.0.layers.0.0``/``.1``, ``query_embed`` ->
  ``query_embedding.weight``, ``reg_ffn_0``/``_1`` -> ``reg_ffn.layers.0.0``/
  ``.1``; ViT and BEiT: ``blocks_3`` -> ``blocks.3``, BEiT's stem conv
  ``patch_embed`` -> ``patch_embed.proj`` and a block's
  ``attn/rel_pos_bias/relative_position_bias_table`` ->
  ``attn.relative_position_bias_table`` (the shared table keeps
  ``rel_pos_bias.``), as timm names them.
  Depthwise and 1x1 conv kernels take the same HWIO -> OIHW rule;
  ``relative_position_bias_table`` and ``gamma`` carry over as they are.

The transformer families have ``params`` only; the ResNet, EfficientNet and
MobileNetV3 families also have ``batch_stats``, and both collections carry
over. The ``buffers`` collection (ArcFaceHead's dynamic-margin ``step``)
carries over as the integers it holds; every other leaf as f32. Heads and
poolings take the plain path (the segmentation head's ``classifier`` is a
1x1 conv with a bias): ``PoolingLinear``'s ``fc`` is a Dense, and
``ArcFaceHead``'s ``weight`` is no ``kernel``, so it keeps its
(num_classes, in_channels) layout.

``task_name_map`` gives the same correspondence by name (port key -> Flax
path) for one collection and ``state_dict_to_task_flax`` carries a port
``state_dict`` back into the Flax tree of that collection, so parameters,
gradients and running statistics can be compared leaf by leaf after training
in either package.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
COLLECTIONS = ("params", "batch_stats", "buffers")
_RESNET = r"^(resnet|resnext|seresne|ecaresne|senet|wide_resnet|(tv|ssl|swsl|ig)_resne)"
# the EfficientNet and MobileNetV3 families (torchok_tpu.utils.torch_convert's
# two family patterns, copied)
_EFFICIENTNET = (r"^(efficientnet|tf_efficientnet|mnasnet|semnasnet|mobilenetv2|mixnet|"
                 r"tinynet|tf_mixnet|spnasnet|fbnetc|eca_efficientnet|gc_efficientnet)")
_MOBILENETV3 = r"^(mobilenetv3|tf_mobilenetv3|fbnetv3|lcnet|tf_lcnet)"


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


def _efficientnet_path(parts: List[str]) -> List[str]:
    out: List[str] = []
    for p in parts:
        if (m := re.fullmatch(r"blocks_(\d+)_(\d+)", p)):
            out += ["blocks", m[1], m[2]]
        else:
            out.append(p)
    return out


def _hrnet_path(parts: List[str]) -> List[str]:
    out: List[str] = []
    for prev, p in zip([""] + parts, parts):
        if (m := re.fullmatch(r"(layer|stage)(\d+)_(\d+)", p)):
            out += [f"{m[1]}{m[2]}", m[3]]
        elif (m := re.fullmatch(r"branch_(\d+)_block_(\d+)", p)):
            out += ["branches", m[1], m[2]]
        elif prev == "downsample" and p in ("conv", "bn"):
            out.append("0" if p == "conv" else "1")
        elif p == "fuse":
            out.append("fuse_layers")
        elif (m := re.fullmatch(r"fuse_(\d+(?:_\d+)+)_(conv|bn)", p)):
            out += m[1].split("_") + ["0" if m[2] == "conv" else "1"]
        elif (m := re.fullmatch(r"t_(\d+)_(conv|bn)", p)):
            # transition{n} feeds stage n + 1, whose branch n is new: timm
            # nests that branch's conv and norm one Sequential deeper
            new = int(m[1]) == int(prev[len("transition"):])
            out += [m[1]] + (["0"] if new else []) + ["0" if m[2] == "conv" else "1"]
        else:
            out.append(p)
    return out


def _neck_path(n_laterals: int) -> Callable[[List[str]], List[str]]:
    """A neck's paths: its Bottlenecks' shortcut projections as the ResNet
    family names them, an FPN's convs as mmdet does (its extra convs after
    its ``n_laterals`` output convs)."""
    resnet = _resnet_path(False)

    def mapper(parts: List[str]) -> List[str]:
        out: List[str] = []
        for p in resnet(parts):
            if (m := re.fullmatch(r"(lateral|fpn_conv|extra_conv)_(\d+)", p)):
                i = int(m[2]) + (n_laterals if m[1] == "extra_conv" else 0)
                out += ["lateral_convs" if m[1] == "lateral" else "fpn_convs", str(i), "conv"]
            else:
                out.append(p)
        return out

    return mapper


def _fcos_path(parts: List[str]) -> List[str]:
    out: List[str] = []
    for p in parts:
        if (m := re.fullmatch(r"(cls|reg)_(conv|gn)_(\d+)", p)):
            out += [f"{m[1]}_convs", m[3], m[2]]
        elif (m := re.fullmatch(r"scale_(\d+)", p)):
            out += ["scales", m[1]]
        else:
            out.append(p)
    return out


def _vit_path(parts: List[str]) -> List[str]:
    out: List[str] = []
    for p in parts:
        if (m := re.fullmatch(r"blocks_(\d+)", p)):
            out += ["blocks", m[1]]
        else:
            out.append(p)
    return out


def _beit_path(parts: List[str]) -> List[str]:
    out = _vit_path(parts)
    if out == ["patch_embed"]:  # the Flax BEiT's stem conv is ``patch_embed`` itself
        return ["patch_embed", "proj"]
    # a block's own table sits on its attention module in timm's names
    return out[:-1] if out[-1:] == ["rel_pos_bias"] and len(out) > 1 else out


def _plain_path(parts: List[str]) -> List[str]:
    return list(parts)


_FAMILY_PATHS: List[Tuple[str, Callable[[List[str]], List[str]]]] = [
    (r"^hrnet", _hrnet_path),
    (r"^bbox_head$", _fcos_path),
    (r"^swinv2", _swin_path),
    (r"^gcvit", _gcvit_path),
    (r"^davit", _davit_path),
    (r"^vit_", _vit_path),
    (r"^beit_", _beit_path),
    (_EFFICIENTNET, _efficientnet_path),
    (_MOBILENETV3, _efficientnet_path),
]


def _path_mapper(name: str, tree: Mapping[str, Any] = None) -> Callable[[List[str]], List[str]]:
    """The path renames of module ``name`` (a registry name, a task part or
    a class name), whose Flax sub-tree ``tree`` a neck's renames need."""
    if re.match(r"^(neck|\w+Neck|FPN)$", name):
        return _neck_path(sum(bool(re.fullmatch(r"lateral_\d+", k)) for k in (tree or {})))
    for pat, fn in _FAMILY_PATHS:
        if re.match(pat, name):
            return fn
    if re.match(_RESNET, name):
        # where the shortcut's conv sits follows the registry entry's avg_down
        from torchok_tpu_torch.models.backbones.resnet import variant_config
        return _resnet_path(bool(variant_config(name).get("avg_down", False)))
    return _plain_path


def _is_detr(tree: Any) -> bool:
    return isinstance(tree, Mapping) and "query_embed" in tree


_QKV = ("query", "key", "value")


def _detr_module(parts: List[str]) -> List[str]:
    """A DETR head's Flax module path -> the port's (mmdet's) module path."""
    if (m := re.fullmatch(r"(encoder|decoder)_(\d+)", parts[0])):
        out = ["transformer", m[1], "layers", m[2]]
        for p in parts[1:]:
            if p in ("self_attn", "cross_attn"):
                cross = p == "cross_attn" and m[1] == "decoder"
                out += ["attentions", "1" if cross else "0", "attn"]
            elif p == "out":
                out.append("out_proj")
            elif (n := re.fullmatch(r"norm(\d)", p)):
                out += ["norms", str(int(n[1]) - 1)]
            else:
                out += {"ffn1": ["ffns", "0", "layers", "0", "0"],
                        "ffn2": ["ffns", "0", "layers", "1"]}.get(p, [p])
        return out
    if (m := re.fullmatch(r"reg_ffn_(\d)", parts[0])):
        return ["reg_ffn", "layers"] + (["0", "0"] if m[1] == "0" else ["1"]) + parts[1:]
    return list(parts)


def _detr_key(path: Tuple[str, ...], prefix: str) -> str:
    """The port key of a DETR leaf; q, k and v leaves name their packed
    ``in_proj_weight``/``in_proj_bias``."""
    if path == ("query_embed",):
        return prefix + "query_embedding.weight"
    if path[-2] in _QKV:
        leaf = f"in_proj_{_LEAF.get(path[-1], path[-1])}"
        return prefix + ".".join(_detr_module(list(path[:-2])) + [leaf])
    return prefix + ".".join(_detr_module(list(path[:-1])) + [_LEAF.get(path[-1], path[-1])])


def _detr_to_torch(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """A Flax DETR head's params -> the port's state_dict entries."""
    out: Dict[str, np.ndarray] = {}
    packed: Dict[str, List[np.ndarray]] = {}
    for path, leaf in _leaves(tree):
        value = _value(leaf)
        key = _detr_key(path, prefix)
        if len(path) > 1 and path[-2] in _QKV:
            # (E, H, D) kernel -> (H D, E) rows; (H, D) bias -> (H D,)
            part = value.reshape(value.shape[0], -1).T if path[-1] == "kernel" \
                else value.reshape(-1)
            packed.setdefault(key, [None] * 3)[_QKV.index(path[-2])] = part
        elif len(path) > 1 and path[-2] == "out" and path[-1] == "kernel":
            out[key] = value.reshape(-1, value.shape[-1]).T  # (H, D, E) -> (E, H D)
        else:
            out[key] = _torch_layout(path[-1], value)
    out.update({k: np.concatenate(parts) for k, parts in packed.items()})
    return {k: np.array(v, order="C") for k, v in out.items()}


def _detr_to_flax(state_dict: Mapping[str, Any], prefix: str,
                  template: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`_detr_to_torch`, shaped like ``template``."""
    out: Dict[str, Any] = {}
    for path, leaf in _leaves(template):
        shape = np.shape(leaf)
        value = _value(state_dict[_detr_key(path, prefix)])
        if len(path) > 1 and path[-2] in _QKV:
            e = value.shape[-1] if path[-1] == "kernel" else value.shape[0] // 3
            rows = value[_QKV.index(path[-2]) * e:(_QKV.index(path[-2]) + 1) * e]
            value = (rows.T if path[-1] == "kernel" else rows).reshape(shape)
        elif len(path) > 1 and path[-2] == "out" and path[-1] == "kernel":
            value = value.T.reshape(shape)
        else:
            value = _flax_layout(path[-1], value)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(value, order="C")
    return out


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


def _value(leaf: Any) -> np.ndarray:
    """A leaf as numpy: integers (the ``buffers`` collection's counters)
    keep their type, everything else becomes f32."""
    value = np.asarray(leaf)
    return value if np.issubdtype(value.dtype, np.integer) else value.astype(np.float32)


def _key(mapper: Callable[[List[str]], List[str]], path: Tuple[str, ...], prefix: str) -> str:
    module = mapper(list(path[:-1]))
    # mmcv's Scale keeps its parameter's own name
    leaf = path[-1] if module[-2:-1] == ["scales"] else _LEAF.get(path[-1], path[-1])
    return prefix + ".".join(module + [leaf])


def _collections(variables: Mapping[str, Any]) -> Dict[str, Mapping[str, Any]]:
    """``{"params": tree, "batch_stats": tree, "buffers": tree}`` (those
    present and not empty) of a variables dict, or of a bare params tree."""
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
    out: Dict[str, np.ndarray] = {}
    for tree in _collections(variables).values():
        if _is_detr(tree):
            out.update(_detr_to_torch(tree, prefix))
            continue
        mapper = _path_mapper(name, tree)
        for path, leaf in _leaves(tree):
            value = np.array(_torch_layout(path[-1], _value(leaf)), order="C")
            out[_key(mapper, path, prefix)] = value
    return out


def task_flax_to_state_dict(backbone_name: str,
                            variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Carry a whole classification, segmentation or detection model (the
    ``backbone``, ``neck``, ``pooling``, ``head`` and ``bbox_head`` sub-trees
    it has of a ``torchok_tpu`` task's params and, where it has them,
    batch_stats) into the state_dict of the port's ``ClassificationModel``,
    ``SegmentationModel`` or ``DetectionModel``."""
    out: Dict[str, np.ndarray] = {}
    for tree in _collections(variables).values():
        for part, sub in tree.items():
            name = backbone_name if part == "backbone" else part
            out.update(flax_to_state_dict(name, sub, prefix=f"{part}."))
    return out


def task_name_map(backbone_name: str, variables: Mapping[str, Any],
                  collection: str = "params") -> Dict[str, Tuple[str, ...]]:
    """Port ``state_dict`` key -> path of the same leaf in one collection of
    a task's Flax variables (``("backbone", "layers_0_blocks_0", ...)``). A
    DETR attention's packed ``in_proj_*`` names its q leaf (q, k and v share
    their groups' labels)."""
    out: Dict[str, Tuple[str, ...]] = {}
    for part, tree in _collections(variables).get(collection, {}).items():
        if _is_detr(tree):
            for path, _ in _leaves(tree):
                if path[-2:-1] not in (("key",), ("value",)):
                    out[_detr_key(path, f"{part}.")] = (part,) + path
            continue
        mapper = _path_mapper(backbone_name if part == "backbone" else part, tree)
        for path, _ in _leaves(tree):
            out[_key(mapper, path, f"{part}.")] = (part,) + path
    return out


def state_dict_to_task_flax(backbone_name: str, state_dict: Mapping[str, Any],
                            variables: Mapping[str, Any],
                            collection: str = "params") -> Dict[str, Any]:
    """Carry a port ``state_dict`` (values ``np.asarray`` accepts) back into
    a nested dict shaped like one collection of the Flax ``variables``."""
    out: Dict[str, Any] = {}
    trees = _collections(variables).get(collection, {})
    detr = {part for part, tree in trees.items() if _is_detr(tree)}
    for part in detr:
        out[part] = _detr_to_flax(state_dict, f"{part}.", trees[part])
    for key, path in task_name_map(backbone_name, variables, collection).items():
        if path[0] in detr:
            continue
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(_flax_layout(path[-1], _value(state_dict[key])), order="C")
    return out
