"""The port's detection modules against ``torchok_tpu``, f32 on the CPU.

* ``ops/boxes``: IoU, GIoU, distance2bbox and bbox2distance to 1e-6; NMS and
  class-aware NMS equal, with tied scores and a batch of images.
* Every registered detection loss (native and ``MM*`` names), value and
  input gradient within 1e-5 relative.
* ``MMDetectionMAP`` and ``CocoEvalMAP`` on random padded predictions, equal
  to 1e-9.
* FPN in every ``add_extra_convs`` mode and with max-pool levels, at a size
  whose stages are odd (13x21 -> 7x11 -> 4x6), outputs within 1e-5 of their
  largest magnitude; FCOSHead's raw outputs to the same tolerance, its loss
  terms within 1e-5 relative and its decoded boxes, scores and labels, from
  the same weights carried by ``flax_to_state_dict``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchok_tpu  # noqa: F401 — registers the JAX components
import torchok_tpu_torch  # noqa: F401
from torchok_tpu.constructor import LOSSES as JAX_LOSSES
from torchok_tpu.constructor import METRICS as JAX_METRICS
from torchok_tpu.losses.base import JointLoss as JaxJointLoss
from torchok_tpu.models.heads.detection.fcos import FCOSHead as JaxFCOSHead
from torchok_tpu.models.necks.detection.fpn import FPN as JaxFPN
from torchok_tpu.ops import boxes as jax_boxes
from torchok_tpu_torch.constructor import DETECTION_NECKS, HEADS, LOSSES, METRICS, NECKS
from torchok_tpu_torch.losses.base import JointLoss
from torchok_tpu_torch.losses.detection.losses import REGISTERED
from torchok_tpu_torch.models.heads.detection.fcos import FCOSHead
from torchok_tpu_torch.models.necks.detection.fpn import FPN
from torchok_tpu_torch.ops import boxes
from torchok_tpu_torch.tasks.detection import DetectionModel
from torchok_tpu_torch.utils.flax_convert import (flax_to_state_dict, state_dict_to_task_flax,
                                                  task_flax_to_state_dict)
from tests.test_torch_hrnet import assert_maps_close, nchw, random_variables


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port: at these sizes more threads only
    contend for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_boxes(rng, shape, size=64.0):
    xy = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(1, size / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------ boxes
def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, (7,)), random_boxes(rng, (5,))
    np.testing.assert_allclose(boxes.box_iou(t(a), t(b)).numpy(),
                               np.asarray(jax_boxes.box_iou(a, b)), rtol=0, atol=1e-6)
    c = random_boxes(rng, (5,))
    np.testing.assert_allclose(boxes.giou(t(b), t(c)).numpy(),
                               np.asarray(jax_boxes.giou(b, c)), rtol=0, atol=1e-6)
    points = rng.uniform(0, 64, (6, 2)).astype(np.float32)
    dist = rng.uniform(0, 40, (6, 4)).astype(np.float32)
    for shape in (None, (48, 40)):
        np.testing.assert_allclose(
            boxes.distance2bbox(t(points), t(dist), shape).numpy(),
            np.asarray(jax_boxes.distance2bbox(points, dist, shape)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(boxes.bbox2distance(t(points), t(a[:6])).numpy(),
                               np.asarray(jax_boxes.bbox2distance(points, a[:6])),
                               rtol=0, atol=1e-6)


def test_nms_matches_jax_with_ties_over_a_batch():
    rng = np.random.default_rng(1)
    n = 40
    bx = random_boxes(rng, (3, n), size=48.0)
    bx[:, 10:20] = bx[:, :10] + rng.uniform(-2, 2, (3, 10, 4)).astype(np.float32)  # overlaps
    scores = rng.choice([0.0, 0.3, 0.5, 0.7, 0.9], (3, n)).astype(np.float32)  # many ties
    labels = rng.integers(0, 3, (3, n))
    for iou, max_out in ((0.5, 12), (0.3, 50)):
        got_i, got_s = boxes.nms(t(bx), t(scores), iou, max_out)
        got_bi, got_bs = boxes.batched_nms(t(bx), t(scores), t(labels), iou, max_out)
        for i in range(3):
            want_i, want_s = jax_boxes.nms(bx[i], scores[i], iou, max_out)
            np.testing.assert_array_equal(got_i[i].numpy(), np.asarray(want_i))
            np.testing.assert_array_equal(got_s[i].numpy(), np.asarray(want_s))
            want_bi, want_bs = jax_boxes.batched_nms(bx[i], scores[i], labels[i], iou, max_out)
            np.testing.assert_array_equal(got_bi[i].numpy(), np.asarray(want_bi))
            np.testing.assert_array_equal(got_bs[i].numpy(), np.asarray(want_bs))
    assert (got_i[:, -1] == -1).all()  # padded once the candidates run out


# ----------------------------------------------------------------- losses
def _loss_inputs(name, rng):
    """(kwargs, names of the differentiated inputs) for one loss."""
    n = 12
    weight = rng.uniform(0, 1, (n,)).astype(np.float32)
    avg = np.float32(3.5)
    if name in ("FocalLoss", "MMFocalLoss", "SeesawLoss", "MMSeesawLoss"):
        return {"pred": rng.normal(0, 2, (n, 5)).astype(np.float32),
                "target": rng.integers(0, 6 if "Focal" in name else 5, (n,)),
                "weight": weight, "avg_factor": avg}, ("pred",)
    if name == "MMCrossEntropyLoss":
        return {"cls_score": rng.normal(0, 2, (n,)).astype(np.float32),
                "label": rng.uniform(0, 1, (n,)).astype(np.float32),
                "weight": weight, "avg_factor": avg}, ("cls_score",)
    if "IoU" in name:
        return {"pred": random_boxes(rng, (n,)), "target": random_boxes(rng, (n,)),
                "weight": weight, "avg_factor": avg}, ("pred",)
    if name in ("DistributionFocalLoss", "MMDistributionFocalLoss"):
        return {"pred": rng.normal(0, 1, (n, 8)).astype(np.float32),
                "target": rng.uniform(0, 6.99, (n,)).astype(np.float32),
                "weight": weight}, ("pred",)
    if name in ("GaussianFocalLoss", "MMGaussianFocalLoss"):
        heat = rng.uniform(0, 1, (n, 6)).astype(np.float32)
        heat[:, 0] = 1.0
        return {"pred": rng.uniform(0.05, 0.95, (n, 6)).astype(np.float32),
                "target": heat}, ("pred",)
    if name in ("KnowledgeDistillationKLDivLoss", "MMKnowledgeDistillationKLDivLoss"):
        return {"pred": rng.normal(0, 3, (n, 6)).astype(np.float32),
                "soft_label": rng.normal(0, 3, (n, 6)).astype(np.float32),
                "weight": weight}, ("pred",)
    if name in ("GHMC", "MMGHMC"):
        return {"pred": rng.normal(0, 2, (n, 4)).astype(np.float32),
                "target": rng.integers(0, 2, (n, 4)).astype(np.float32),
                "weight": (rng.uniform(0, 1, (n, 4)) > 0.2).astype(np.float32)}, ("pred",)
    if name in ("QualityFocalLoss", "MMQualityFocalLoss", "VarifocalLoss", "MMVarifocalLoss"):
        soft = rng.uniform(0, 1, (n, 5)).astype(np.float32) * (rng.uniform(0, 1, (n, 5)) > 0.6)
        return {"pred": rng.normal(0, 2, (n, 5)).astype(np.float32), "target": soft,
                "weight": weight, "avg_factor": avg}, ("pred",)
    # regression losses: (n, 4) deltas
    return {"pred": rng.normal(0, 1.5, (n, 4)).astype(np.float32),
            "target": rng.normal(0, 1.5, (n, 4)).astype(np.float32),
            "weight": weight[:, None] if name in ("MMMSELoss", "GHMR", "MMGHMR") else weight,
            "avg_factor": avg}, ("pred",)


_LOSS_PARAMS = {"SeesawLoss": {"class_counts": [5, 50, 500, 20, 7], "num_classes": 5},
                "MMSeesawLoss": {"class_counts": [5, 50, 500, 20, 7], "num_classes": 5},
                "MMCrossEntropyLoss": {"use_sigmoid": True}}


@pytest.fixture(scope="module")
def loss_results():
    """Both packages' value and input gradients per (JAX class, port class,
    parameters): a native name and its ``MM*`` alias resolve to the same
    pair in both registries, so the pair is computed once for both."""
    return {}


@pytest.mark.parametrize("name", sorted(REGISTERED))
def test_detection_loss_value_and_gradient_match_jax(name, loss_results):
    params = _LOSS_PARAMS.get(name, {})
    ref_cls, port_cls = JAX_LOSSES.get(name), LOSSES.get(name)
    key = (ref_cls, port_cls, repr(sorted(params.items())))
    if key not in loss_results:
        rng = np.random.default_rng(sum(map(ord, port_cls.__name__)))
        kwargs, wrt = _loss_inputs(name, rng)
        ref_fn, port_fn = ref_cls(**params), port_cls(**params)

        def ref_loss(*diff):
            return ref_fn(**{**kwargs, **dict(zip(wrt, diff))})

        grad_fn = jax.value_and_grad(ref_loss, argnums=tuple(range(len(wrt))))
        want, want_grads = jax.jit(grad_fn)(*[jnp.asarray(kwargs[k]) for k in wrt])
        inputs = {k: t(v) for k, v in kwargs.items()}
        for k in wrt:
            inputs[k].requires_grad_(True)
        got = port_fn(**inputs)
        got.backward()
        loss_results[key] = (got.item(), float(want),
                             [(inputs[k].grad.numpy(), np.asarray(g))
                              for k, g in zip(wrt, want_grads)])
    got, want, grads = loss_results[key]
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)
    for g, w in grads:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max() + 1e-12)


def test_the_mmdet_names_are_registered_beside_the_native_ones():
    jax_names = {n for n in JAX_LOSSES.entries if n in REGISTERED}
    assert set(REGISTERED) == jax_names and len(REGISTERED) == 34
    assert "FPN" in DETECTION_NECKS and NECKS.get("FPNNeck") is FPN
    assert HEADS.get("FCOSHead") is FCOSHead
    assert METRICS.get("MeanAveragePrecision") is METRICS.get("CocoEvalMAP")
    recursive = torch.nn.Identity()
    recursive.requires_image = True  # an RFP-style neck re-runs the backbone
    with pytest.raises(NotImplementedError, match="RFP"):
        DetectionModel(torch.nn.Identity(), recursive, FCOSHead(num_classes=2, in_channels=32,
                                                                feat_channels=32))


# ---------------------------------------------------------------- metrics
def _random_batches(rng, n_batches=3, b=4, d=12, m=5, classes=3):
    out = []
    for _ in range(n_batches):
        gt = random_boxes(rng, (b, m), size=96)
        gl = rng.integers(0, classes, (b, m))
        gl[rng.uniform(0, 1, (b, m)) < 0.3] = -1
        gt[gl < 0] = 0
        # detections: jittered GT, random boxes, tied scores and padding
        pb = np.concatenate([gt + rng.normal(0, 4, gt.shape), random_boxes(rng, (b, d - m), 96)],
                            1).astype(np.float32)
        ps = rng.choice([0.2, 0.4, 0.6, 0.8, 0.95], (b, d)).astype(np.float32)
        pl = np.concatenate([np.where(rng.uniform(0, 1, (b, m)) < 0.8, np.maximum(gl, 0),
                                      rng.integers(0, classes, (b, m))),
                             rng.integers(0, classes, (b, d - m))], 1)
        pad = rng.uniform(0, 1, (b, d)) < 0.2
        pl[pad], ps[pad], pb[pad] = -1, 0.0, 0.0
        out.append(({"bboxes": pb, "scores": ps, "labels": pl}, {"bboxes": gt, "labels": gl}))
    return out


@pytest.mark.parametrize("name,params", [
    ("MMDetectionMAP", {"iou_thr": 0.5, "num_classes": 3}),
    ("MMDetectionMAP", {"iou_thr": 0.75}),
    ("MMDetectionMAP", {"iou_thr": 0.5, "num_classes": 3, "mode": "11points"}),
    ("CocoEvalMAP", {"displayed_metrics": ["map", "map_50", "map_75", "map_small",
                                           "map_medium", "map_large"]}),
])
def test_map_metrics_match_jax(name, params):
    batches = _random_batches(np.random.default_rng(3))
    ref, port = JAX_METRICS.get(name)(**params), METRICS.get(name)(**params)
    ref_state, port_state = ref.empty_state(), port.empty_state(torch.device("cpu"))
    for preds, target in batches:
        ref_state = ref.update(ref_state, preds=preds, target=target)
        port_state = port.update(port_state, preds={k: t(v) for k, v in preds.items()},
                                 target={k: t(v) for k, v in target.items()})
    want, got = ref.compute(ref_state), port.compute(port_state)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=0, abs=1e-9), k
        assert 0 < got["map"] < 1
    else:
        assert got == pytest.approx(want, rel=0, abs=1e-9)
        assert 0 < got < 1


# ------------------------------------------------------------- FPN + FCOS
IN_CHANNELS = (8, 16, 24)
# an odd-stage pyramid, as 400x672 gives at strides 8 to 32 (/8 scale)
ODD = ((13, 21), (7, 11), (4, 6))


def _features(rng, sizes=ODD, batch=2):
    return [rng.normal(0, 1, (batch, h, w, c)).astype(np.float32)
            for (h, w), c in zip(sizes, IN_CHANNELS)]


@pytest.mark.parametrize("extra", [False, "on_input", "on_lateral", "on_output", "relu"])
def test_fpn_matches_flax_at_odd_stage_sizes(extra):
    rng = np.random.default_rng(4)
    params = dict(out_channels=16, num_outs=5, add_extra_convs=extra)
    if extra == "relu":
        params.update(add_extra_convs="on_output", relu_before_extra_convs=True)
    if extra is False:
        params.update(start_level=1, num_outs=4)
    feats = _features(rng)
    ref = JaxFPN(in_channels=IN_CHANNELS, **params)
    variables = random_variables(ref, rng, [jnp.asarray(f) for f in feats])
    want = ref.apply(variables, [jnp.asarray(f) for f in feats])
    port = FPN(in_channels=IN_CHANNELS, **params)
    port.load_state_dict({k: t(v) for k, v in flax_to_state_dict("FPN", variables).items()})
    got = port([nchw(f) for f in feats])
    assert len(got) == len(want) == params["num_outs"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_maps_close(g, w, 1e-5, f"level {i}")


HEAD = dict(num_classes=3, in_channels=16, feat_channels=64, stacked_convs=2,
            strides=(8, 16, 32),
            test_cfg={"nms_pre": 40, "score_thr": 0.05, "nms": {"iou_threshold": 0.5},
                      "max_per_img": 10})
LOSS_CFG = [
    ("MMFocalLoss", {"use_sigmoid": True, "gamma": 2.0, "alpha": 0.25},
     {"pred": "flatten_cls_scores", "target": "flatten_labels", "avg_factor": "num_pos"}),
    ("MMIoULoss", {}, {"pred": "pos_decoded_bbox_preds", "target": "pos_decoded_target_preds",
                       "weight": "pos_centerness_targets", "avg_factor": "centerness_denorm"}),
    ("MMCrossEntropyLoss", {"use_sigmoid": True},
     {"cls_score": "pos_centerness", "label": "pos_centerness_targets", "avg_factor": "num_pos"}),
]


def _joint(registry, cls):
    return cls([registry.get(n)(**p) for n, p, _ in LOSS_CFG], [m for _, _, m in LOSS_CFG],
               ["loss_cls", "loss_bbox", "loss_centerness"], [None] * 3, False)


@pytest.fixture(scope="module")
def fcos_pair():
    """The JAX head and the port's from the same random weights, over an
    odd-stage pyramid of 16 channels (a 104x168 image at strides 8 to 32):
    feat_channels 64 puts 2 channels in each of GroupNorm's 32 groups."""
    rng = np.random.default_rng(5)
    feats = [rng.normal(0, 1, (2, h, w, 16)).astype(np.float32) for h, w in ODD]
    ref = JaxFCOSHead(**HEAD)
    variables = random_variables(ref, rng, [jnp.asarray(f) for f in feats])
    port = FCOSHead(**HEAD)
    port.load_state_dict({k: t(v) for k, v in
                          flax_to_state_dict("bbox_head", variables).items()})
    assert "scales.2.scale" in port.state_dict() and "cls_convs.1.gn.weight" in port.state_dict()
    want = jax.jit(ref.apply)(variables, [jnp.asarray(f) for f in feats])
    got = port([nchw(f) for f in feats])
    return ref, variables, port, want, got


def test_fcos_head_outputs_match_flax(fcos_pair):
    _, _, _, want, got = fcos_pair
    for name, gs, ws in zip(("cls", "bbox", "centerness"), got, want):
        for i, (g, w) in enumerate(zip(gs, ws)):
            w = np.asarray(w)
            assert_maps_close(g, w if w.ndim == 4 else w[..., None], 1e-5, f"{name} {i}")


def test_fcos_loss_terms_and_gradients_match_flax(fcos_pair):
    ref, variables, port, want, got = fcos_pair
    rng = np.random.default_rng(6)
    gt = np.zeros((2, 4, 4), np.float32)
    gt[0, :3] = [[8, 10, 60, 50], [50, 20, 160, 100], [0, 0, 30, 30]]
    gt[1, :2] = [[20, 30, 100, 90], [5, 5, 25, 40]]
    labels = np.array([[1, 0, 2, -1], [2, 1, -1, -1]])
    gt += rng.uniform(0, 1, gt.shape).astype(np.float32) * (labels >= 0)[..., None]
    ref_joint = _joint(JAX_LOSSES, JaxJointLoss)

    def ref_loss(outs):
        total, tagged = ref.loss(ref_joint, *outs, gt_bboxes=jnp.asarray(gt),
                                 gt_labels=jnp.asarray(labels))
        return total, tagged

    (want_total, want_tagged), want_grads = jax.jit(
        jax.value_and_grad(ref_loss, has_aux=True))(want)
    outs = [[g.detach().requires_grad_(True) for g in level] for level in got]
    total, tagged = port.loss(_joint(LOSSES, JointLoss), *outs, gt_bboxes=t(gt),
                              gt_labels=t(labels))
    total.backward()
    assert total.item() == pytest.approx(float(want_total), rel=1e-5)
    for k, v in want_tagged.items():
        assert tagged[k].item() == pytest.approx(float(v), rel=1e-5), k
    assert float(want_tagged["loss_bbox"]) > 0  # points were assigned
    for name, gs, ws in zip(("cls", "bbox", "centerness"), outs, want_grads):
        for i, (g, w) in enumerate(zip(gs, ws)):
            w = np.asarray(w)
            assert_maps_close(g.grad, w if w.ndim == 4 else w[..., None], 1e-5,
                              f"d {name} {i}")


def test_the_bridge_carries_fpn_and_fcos_both_ways(fcos_pair):
    """mmdet's names: the FPN's extra convs continue ``fpn_convs`` after its
    laterals; the per-level Scale keeps its ``scale``."""
    rng = np.random.default_rng(7)
    feats = [jnp.asarray(f) for f in _features(rng)]
    neck = random_variables(JaxFPN(in_channels=IN_CHANNELS, out_channels=16, num_outs=5,
                                   add_extra_convs="on_input"), rng, feats)
    task_vars = {"params": {"neck": neck["params"], "bbox_head": fcos_pair[1]["params"]}}
    sd = task_flax_to_state_dict("resnet18", task_vars)
    assert {"neck.lateral_convs.2.conv.weight", "neck.fpn_convs.3.conv.weight",
            "neck.fpn_convs.4.conv.bias", "bbox_head.scales.0.scale",
            "bbox_head.reg_convs.1.gn.bias"} <= set(sd)
    assert sd["neck.fpn_convs.3.conv.weight"].shape == (16, IN_CHANNELS[-1], 3, 3)
    back = state_dict_to_task_flax("resnet18", sd, task_vars)
    flat_a = jax.tree_util.tree_flatten_with_path(task_vars["params"])[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_fcos_get_bboxes_matches_flax(fcos_pair):
    ref, _, port, want, got = fcos_pair
    ref_out = jax.jit(lambda outs: ref.get_bboxes(*outs, img_shape=(104, 168)))(want)
    with torch.no_grad():
        out = port.get_bboxes(*got, img_shape=(104, 168))
    np.testing.assert_array_equal(out["labels"].numpy(), np.asarray(ref_out["labels"]))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref_out["scores"]), rtol=1e-5)
    np.testing.assert_allclose(out["bboxes"].numpy(), np.asarray(ref_out["bboxes"]), rtol=1e-5,
                               atol=1e-4)
    assert (out["labels"] >= 0).sum() > 4  # decoded boxes, not padding alone
