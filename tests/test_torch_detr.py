"""The DETR head of the port (``torchok_tpu_torch.models.heads.detection.detr``)
against ``torchok_tpu``'s on the CPU, f32, from the same seeded inputs and
weights carried over by ``utils.flax_convert``.

The sine encoding to 1e-6; the encoder and decoder layers and the head's
forward (2 + 2 layers, 32 wide, 4 heads, 8 queries, 3 classes, a 4x5 map) to
1e-5; the host Hungarian assignment equal to the JAX package's in-graph one
(``_match``) with -1 padded gt rows, an image without boxes and as many boxes
as queries; the loss with its ``d{i}.`` tags to 1e-5; ``get_bboxes`` with a
planted tie; the weight bridge both ways; the initial law's moments; and the
scipy/torch oracle of ``tests/test_detr_matcher_oracle.py`` run on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import HEADS as JAX_HEADS
from torchok_tpu.constructor import LOSSES as JAX_LOSSES
from torchok_tpu.losses.base import JointLoss as JaxJointLoss
from torchok_tpu.models.heads.detection import detr as jax_detr
from torchok_tpu_torch.constructor import HEADS, LOSSES
from torchok_tpu_torch.losses.base import JointLoss
from torchok_tpu_torch.models.heads.detection import detr
from torchok_tpu_torch.utils.flax_convert import (flax_to_state_dict, state_dict_to_task_flax,
                                                  task_name_map)
from tests import test_detr_matcher_oracle as oracle


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HEAD = dict(num_classes=3, in_channels=16, embed_dim=32, num_heads=4, num_queries=8,
            num_encoder_layers=2, num_decoder_layers=2, ffn_dim=64, dropout=0.0)
LOSS_SPECS = [
    ("MMCrossEntropyLoss", "loss_cls", 1.0, {"use_sigmoid": False, "class_weight": 1.0},
     {"cls_score": "cls_scores", "label": "labels", "weight": "label_weights",
      "avg_factor": "cls_avg_factor"}),
    ("MMGIoULoss", "loss_iou", 2.0, {},
     {"pred": "bboxes", "target": "bboxes_gt", "weight": "bbox_weights",
      "avg_factor": "num_total_pos"}),
    ("MML1Loss", "loss_bbox", 5.0, {},
     {"pred": "bbox_preds", "target": "bbox_targets", "weight": "bbox_weights",
      "avg_factor": "num_total_pos"}),
]


def _joint_losses(avg_factors=True):
    """The DETR recipes' joint loss in both packages (with its avg factors
    unmapped: each loss then takes the mean)."""
    mappings = [m if avg_factors else {k: v for k, v in m.items() if k != "avg_factor"}
                for *_, m in LOSS_SPECS]

    def build(registry, cls):
        return cls([registry.get(name)(**params) for name, _, _, params, _ in LOSS_SPECS],
                   mappings, [t for _, t, *_ in LOSS_SPECS],
                   [w for _, _, w, *_ in LOSS_SPECS], normalize_weights=False)
    return build(JAX_LOSSES, JaxJointLoss), build(LOSSES, JointLoss)


def _random_tree(shapes, rng, scale=0.2):
    return jax.tree_util.tree_map(lambda s: (scale * rng.normal(size=s.shape)).astype(np.float32),
                                  shapes)


def _heads(seed=0, **overrides):
    """Both heads from the same random weights (LayerNorm scales at 1 plus
    noise, so the norms do work)."""
    kw = {**HEAD, **overrides}
    ref = JAX_HEADS.get("DETRHead")(**kw)
    x = jnp.zeros((1, 4, 5, kw["in_channels"]), jnp.float32)
    shapes = jax.eval_shape(lambda k: ref.init(k, [x]), jax.random.PRNGKey(0))["params"]
    params = _random_tree(shapes, np.random.default_rng(seed))
    port = HEADS.get("DETRHead")(**kw).eval()
    sd = flax_to_state_dict("bbox_head", {"params": params})
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return ref, {"params": params}, port


def _wrapped(layer_params, name):
    """A lone layer's params as a DETR head tree, so the head's renames apply."""
    return {"params": {name: layer_params, "query_embed": np.zeros((1, 1), np.float32)}}


@pytest.mark.parametrize("h,w,dim", [(4, 5, 32), (13, 21, 256), (3, 3, 128), (1, 7, 64)])
def test_sine_encoding_matches_jax(h, w, dim):
    want = np.asarray(jax.jit(jax_detr.sine_positional_encoding, static_argnums=(0, 1, 2))(
        h, w, dim))
    got = detr.sine_positional_encoding(h, w, dim).numpy()
    assert got.shape == want.shape == (h, w, dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_box_conversions_match_jax():
    b = np.random.default_rng(0).uniform(0, 1, (5, 7, 4)).astype(np.float32)
    for name in ("cxcywh_to_xyxy", "xyxy_to_cxcywh"):
        want = np.asarray(getattr(jax_detr, name)(jnp.asarray(b)))
        np.testing.assert_array_equal(getattr(detr, name)(torch.from_numpy(b)).numpy(), want)


@pytest.mark.parametrize("cross", [False, True])
def test_transformer_layer_matches_jax(cross):
    rng = np.random.default_rng(1)
    q, qpos = (rng.normal(size=(2, 6, 32)).astype(np.float32) for _ in range(2))
    kv, kpos = (rng.normal(size=(2, 9, 32)).astype(np.float32) for _ in range(2))
    ref = jax_detr.TransformerLayer(num_heads=4, ffn_dim=64, dropout=0.0)
    args = (jnp.asarray(q),) + ((jnp.asarray(kv),) if cross else (None,))
    kwargs = {"q_pos": jnp.asarray(qpos)}
    if cross:
        kwargs["k_pos"] = jnp.asarray(kpos)
    shapes = jax.eval_shape(lambda k: ref.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], rng)
    want = np.asarray(jax.jit(lambda p: ref.apply({"params": p}, *args, **kwargs))(params))
    port = detr.TransformerLayer(32, 4, 64, 0.0).eval()
    prefix = "transformer.encoder.layers.0."
    sd = flax_to_state_dict("bbox_head", _wrapped(params, "encoder_0"))
    port.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in sd.items()
                          if k.startswith(prefix)}, strict=True)
    t = {k: torch.from_numpy(v) for k, v in dict(q=q, qpos=qpos, kv=kv, kpos=kpos).items()}
    with torch.no_grad():
        got = port(t["q"], t["kv"] if cross else None, t["qpos"], t["kpos"] if cross else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_decoder_layer_matches_jax():
    rng = np.random.default_rng(2)
    q, qpos = (rng.normal(size=(2, 8, 32)).astype(np.float32) for _ in range(2))
    mem, mpos = (rng.normal(size=(2, 20, 32)).astype(np.float32) for _ in range(2))
    ref = jax_detr.DecoderLayer(num_heads=4, ffn_dim=64, dropout=0.0)
    args = tuple(jnp.asarray(a) for a in (q, mem, qpos, mpos))
    shapes = jax.eval_shape(lambda k: ref.init(k, *args), jax.random.PRNGKey(0))
    params = _random_tree(shapes["params"], rng)
    want = np.asarray(jax.jit(lambda p: ref.apply({"params": p}, *args))(params))
    port = detr.DecoderLayer(32, 4, 64, 0.0).eval()
    prefix = "transformer.decoder.layers.0."
    sd = flax_to_state_dict("bbox_head", _wrapped(params, "decoder_0"))
    port.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in sd.items()
                          if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (q, mem, qpos, mpos)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("return_intermediate", [True, False])
def test_head_forward_matches_jax(return_intermediate):
    ref, variables, port = _heads(3, return_intermediate=return_intermediate)
    port.return_intermediate = return_intermediate
    x = np.random.default_rng(4).normal(size=(2, 4, 5, 16)).astype(np.float32)
    want = jax.jit(lambda v: ref.apply(v, [jnp.asarray(x)]))(variables)
    with torch.no_grad():
        got = port([torch.from_numpy(x).permute(0, 3, 1, 2)])
    layers = 2 if return_intermediate else 1
    assert got[0].shape == (layers, 2, 8, 4) and got[1].shape == (layers, 2, 8, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert detr.DETRHead.format_dict(got).keys() == {"cls_scores_raw", "bbox_preds_raw"}


def _predictions(seed, lyr, b, q, c):
    rng = np.random.default_rng(seed)
    cls = rng.normal(0, 2, (lyr, b, q, c + 1)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (lyr, b, q, 2)),
                            rng.uniform(0.05, 0.4, (lyr, b, q, 2))], -1).astype(np.float32)
    return cls, boxes


def _targets(seed, counts, m, c, img=(64, 96)):
    """(B, M, 4) pixel xyxy gt and (B, M) labels, -1 padded after
    ``counts[i]`` real boxes."""
    rng = np.random.default_rng(seed)
    h, w = img
    gt = np.zeros((len(counts), m, 4), np.float32)
    labels = np.full((len(counts), m), -1, np.int64)
    for i, n in enumerate(counts):
        xy = rng.uniform(0, 0.6, (n, 2))
        wh = rng.uniform(0.05, 0.4, (n, 2))
        gt[i, :n] = np.concatenate([xy, xy + wh], -1) * np.array([w, h, w, h])
        labels[i, :n] = rng.integers(0, c, n)
    return gt, labels


def _gt_norm(gt, img=(64, 96)):
    h, w = img
    scale = np.array([w, h, w, h], np.float32)
    return np.asarray(jax_detr.xyxy_to_cxcywh(jnp.asarray(gt / scale)))


@pytest.mark.parametrize("seed,counts,m", [(0, (3, 0, 5), 6), (1, (8, 2), 8), (2, (1, 4, 7), 8),
                                           (3, (6, 6), 6), (4, (0, 0), 3)])
def test_host_assignment_equals_jax_match(seed, counts, m):
    """-1 padded rows, an image with no box, and as many boxes as queries
    (M = Q = 8): the pairs of every (layer, image) equal the in-graph ones."""
    lyr, q, c = 3, 8, 4
    cls, boxes = _predictions(seed, lyr, len(counts), q, c)
    gt, labels = _targets(seed + 10, counts, m, c)
    gt_norm = _gt_norm(gt)
    ref = JAX_HEADS.get("DETRHead")(num_classes=c, num_queries=q)
    match = jax.jit(jax.vmap(jax.vmap(ref._match), in_axes=(0, 0, None, None)))
    want = np.asarray(match(cls, boxes, gt_norm, labels.astype(np.int32)))
    port = HEADS.get("DETRHead")(num_classes=c, num_queries=q)
    got = port.assign(torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(gt_norm),
                      torch.from_numpy(labels))
    assert got.dtype == torch.int64 and got.shape == (lyr, len(counts), q)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, n in enumerate(counts):
        assert (got[:, i] >= 0).sum(-1).tolist() == [min(n, q)] * lyr


def test_assignment_copies_the_cost_once(monkeypatch):
    """One host copy for every layer and image of a step."""
    copies = []
    cpu = torch.Tensor.cpu

    def counted(self, *args, **kwargs):
        copies.append(tuple(self.shape))
        return cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    cls, boxes = _predictions(5, 6, 4, 8, 3)
    gt, labels = _targets(6, (2, 0, 5, 8), 8, 3)
    port = HEADS.get("DETRHead")(num_classes=3, num_queries=8)
    port.assign(torch.from_numpy(cls), torch.from_numpy(boxes),
                torch.from_numpy(_gt_norm(gt)), torch.from_numpy(labels))
    assert copies == [(6 * 4 * 8 * 8 + 4 * 8,)]


@pytest.mark.parametrize("layers,avg_factors", [(3, True), (1, True), (3, False)])
def test_loss_matches_jax(layers, avg_factors):
    """All layers in one joint-loss call; without avg factors (a loss then
    averages over its inputs) a call a layer, as in the JAX package."""
    c, q = 4, 8
    cls, boxes = _predictions(7, layers, 3, q, c)
    gt, labels = _targets(8, (3, 0, 5), 6, c)
    jax_joint, joint = _joint_losses(avg_factors)
    ref = JAX_HEADS.get("DETRHead")(num_classes=c, num_queries=q)
    port = HEADS.get("DETRHead")(num_classes=c, num_queries=q)
    args = (cls, boxes) if layers > 1 else (cls[0], boxes[0])
    want_total, want = jax.jit(lambda a, b, g, lab: ref.loss(jax_joint, a, b, g, lab,
                                                             img_shape=(64, 96)))(
        *args, gt, labels.astype(np.int32))
    t_args = [torch.from_numpy(a).requires_grad_(True) for a in args]
    total, got = port.loss(joint, *t_args, torch.from_numpy(gt), torch.from_numpy(labels),
                           img_shape=(64, 96))
    assert got.keys() == want.keys()
    tags = {f"{p}loss_{k}" for p in [f"d{i}." for i in range(layers - 1)] + [""]
            for k in ("cls", "iou", "bbox")}
    assert set(got) == tags
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-5)
    total.backward()
    assert all(bool(torch.isfinite(a.grad).all()) and a.grad.abs().sum() > 0 for a in t_args)


def test_get_bboxes_matches_jax_with_a_planted_tie():
    c, q = 3, 8
    cls, boxes = _predictions(9, 2, 2, q, c)
    cls[-1, 0, 5] = cls[-1, 0, 2]  # queries 2 and 5 of image 0 tie
    cls[-1, 1, :, :-1] = cls[-1, 1, :1, :-1]  # every query of image 1 ties
    for test_cfg in ({"score_thr": 0.0, "max_per_img": 5}, {"score_thr": 0.3, "max_per_img": 20},
                     None):
        ref = JAX_HEADS.get("DETRHead")(num_classes=c, num_queries=q, test_cfg=test_cfg,
                                        max_per_img=6)
        port = HEADS.get("DETRHead")(num_classes=c, num_queries=q, test_cfg=test_cfg,
                                     max_per_img=6)
        want = jax.jit(lambda a, b: ref.get_bboxes(a, b, img_shape=(64, 96)))(cls, boxes)
        got = port.get_bboxes(torch.from_numpy(cls), torch.from_numpy(boxes), img_shape=(64, 96))
        np.testing.assert_allclose(got["bboxes"].numpy(), np.asarray(want["bboxes"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))


def test_bridge_both_ways():
    _, variables, port = _heads(11)
    params = variables["params"]
    sd = flax_to_state_dict("bbox_head", variables)
    assert sorted(sd) == sorted(port.state_dict())
    e = HEAD["embed_dim"]
    att = "transformer.decoder.layers.1.attentions.1.attn."
    assert sd[att + "in_proj_weight"].shape == (3 * e, e)
    np.testing.assert_array_equal(sd[att + "in_proj_weight"][e:2 * e],
                                  params["decoder_1"]["cross_attn"]["key"]["kernel"]
                                  .reshape(e, e).T)
    np.testing.assert_array_equal(sd[att + "out_proj.weight"],
                                  params["decoder_1"]["cross_attn"]["out"]["kernel"]
                                  .reshape(e, e).T)
    np.testing.assert_array_equal(sd["query_embedding.weight"], params["query_embed"])
    np.testing.assert_array_equal(sd["reg_ffn.layers.1.weight"],
                                  params["reg_ffn_1"]["kernel"].T)
    np.testing.assert_array_equal(sd["transformer.encoder.layers.0.norms.1.weight"],
                                  params["encoder_0"]["norm2"]["scale"])
    task = {"params": {"bbox_head": params}}
    state = {f"bbox_head.{k}": v for k, v in sd.items()}
    back = state_dict_to_task_flax("resnet18", state, task)["bbox_head"]
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert sorted(task_name_map("resnet18", task)) == sorted(state)


def test_initial_law_moments():
    """LeCun normal kernels (truncated, variance 1 / fan_in), q, k, v and out
    over a fan-in of embed_dim, ``query_embed`` N(0, 1), zero biases, unit
    LayerNorms, as the JAX head initialises."""
    kw = dict(HEAD, embed_dim=256, num_heads=8, ffn_dim=1024, num_queries=100, in_channels=512)
    port = HEADS.get("DETRHead")(**kw)
    g = torch.Generator()
    g.manual_seed(0)
    port.init_weights(g)
    ref = JAX_HEADS.get("DETRHead")(**kw)
    x = jnp.zeros((1, 4, 5, 512), jnp.float32)
    params = jax.jit(lambda k: ref.init(k, [x]))(jax.random.PRNGKey(0))["params"]
    want = flax_to_state_dict("bbox_head", {"params": params})
    state = port.state_dict()
    for key, value in state.items():
        got, ref_v = value.numpy(), want[key]
        if key.endswith("bias") or ".norms." in key:
            np.testing.assert_array_equal(got, ref_v, err_msg=key)
            continue
        # moments within four standard errors of the law's (std and mean),
        # in both draws, and the truncation at two standard deviations of
        # the untruncated normal (whose std is 1 / 0.8796 of the truncated
        # one's)
        std = 1.0 if key == "query_embedding.weight" else (1.0 / value[0].numel()) ** 0.5
        n = got.size
        for v in (got, ref_v):
            assert abs(v.std() / std - 1) < 4 / (2 * n) ** 0.5, key
            assert abs(v.mean()) < 4 * std / n ** 0.5, key
            if key != "query_embedding.weight":
                assert np.abs(v).max() <= 2.0 * std / 0.8796 * (1 + 1e-5), key


@pytest.mark.parametrize("seed,num_valid", [(0, 5), (1, 8), (2, 1), (3, 3)])
def test_port_matches_the_scipy_oracle(seed, num_valid):
    """The mmdet-semantics oracle of ``test_detr_matcher_oracle.py``: its
    scipy match and its torch layer loss against the port's."""
    cls_scores, bbox_preds, gt_xyxy_px, labels = oracle._inputs(seed, num_valid)
    port = HEADS.get("DETRHead")(num_classes=oracle.C, num_queries=oracle.Q,
                                 bg_cls_weight=oracle.BG_W)
    _, joint = _joint_losses()
    h, w = oracle.IMG
    gt_norm = _gt_norm(gt_xyxy_px, oracle.IMG)
    got = port.assign(torch.from_numpy(cls_scores)[None, None],
                      torch.from_numpy(bbox_preds)[None, None], torch.from_numpy(gt_norm)[None],
                      torch.from_numpy(labels.astype(np.int64))[None])[0, 0].numpy()
    want = oracle._oracle_match(cls_scores, bbox_preds, gt_xyxy_px, labels)
    np.testing.assert_array_equal(got, want)
    total, tagged = port.loss(joint, torch.from_numpy(cls_scores)[None],
                              torch.from_numpy(bbox_preds)[None],
                              torch.from_numpy(gt_xyxy_px)[None],
                              torch.from_numpy(labels.astype(np.int64))[None], img_shape=(h, w))
    o_total, o_tagged = oracle._oracle_loss(cls_scores, bbox_preds, gt_xyxy_px, labels, want)
    np.testing.assert_allclose(total.item(), float(o_total), rtol=1e-4)
    for k in ("loss_cls", "loss_bbox", "loss_iou"):
        np.testing.assert_allclose(tagged[k].item(), float(o_tagged[k]), rtol=1e-4, err_msg=k)


def test_img_shape_in_the_outputs_leaves_fcos_bit_equal():
    """``DetectionModel`` puts the input's (H, W) in its outputs (DETR's loss
    reads it): FCOS's loss takes it unchanged and gives the same bits as
    without it, its predictions equal ``get_bboxes`` called on the head alone,
    and the trainer's nested detach keeps the tuple."""
    from torchok_tpu_torch.constructor import BACKBONES, DETECTION_NECKS
    from torchok_tpu_torch.engine.trainer import _map_tensors
    from torchok_tpu_torch.tasks.detection import DetectionModel
    from tests.test_torch_detection_data import chip_smoke

    torch.manual_seed(0)
    backbone = BACKBONES.get("resnet18")(layers=[1, 1, 1, 1])
    neck = DETECTION_NECKS.get("FPN")(in_channels=backbone.out_encoder_channels[-3:],
                                      out_channels=32, num_outs=3)
    head = HEADS.get("FCOSHead")(num_classes=2, in_channels=32, feat_channels=32,
                                 stacked_convs=1, strides=[8, 16, 32])
    model = DetectionModel(backbone, neck, head, num_scales=3)
    rng = np.random.default_rng(0)
    gt, labels = _targets(1, (2, 3), 4, 2, img=(96, 128))
    batch = {"image": torch.from_numpy(rng.normal(size=(2, 3, 96, 128)).astype(np.float32)),
             "bboxes": torch.from_numpy(gt), "label": torch.from_numpy(labels)}
    joint = JointLoss([LOSSES.get(spec["name"])(**spec.get("params", {}))
                       for spec in chip_smoke.FCOS_LOSSES],
                      [spec["mapping"] for spec in chip_smoke.FCOS_LOSSES],
                      [spec["tag"] for spec in chip_smoke.FCOS_LOSSES], [1.0] * 3,
                      normalize_weights=False)
    model.train()
    out = model(batch)
    assert out["img_shape"] == (96, 128)
    with_shape = head.loss(joint, **out)
    without = head.loss(joint, **{k: v for k, v in out.items() if k != "img_shape"})
    assert torch.equal(with_shape[0], without[0])
    assert all(torch.equal(with_shape[1][k], without[1][k]) for k in without[1])
    assert _map_tensors(torch.Tensor.detach, out["img_shape"]) == (96, 128)
    model.eval()
    with torch.no_grad():
        out = model(batch)
        feats = neck(backbone.forward_features(batch["image"])[-3:])
        want = head.get_bboxes(*head(feats), img_shape=(96, 128))
    for key in ("bboxes", "scores", "labels"):
        assert torch.equal(out["prediction"][key], want[key]), key
