"""DETR detection head (reference: torchok/models/heads/detection/detr.py:22-327,
an mmdet DETRHead subclass; port of ``torchok_tpu.models.heads.detection.detr``;
DETR: arXiv:2005.12872).

A post-norm transformer encoder-decoder over the deepest feature map with
sine positional encodings and learned object queries; every decoder layer's
output goes through the shared class and box heads (``return_intermediate``),
so the outputs are ``(Lyr, B, Q, C + 1)`` logits and ``(Lyr, B, Q, 4)``
sigmoid cxcywh boxes.

The attention keeps Flax ``MultiHeadDotProductAttention``'s math: separate
q, k, v and out projections with biases, q scaled by ``1 / sqrt(head_dim)``,
dropout on the attention weights. The JAX package leaves it to XLA (no
Pallas kernel), so the port runs ``F.scaled_dot_product_attention`` where no
dropout is drawn and the explicit softmax where it is.

The Hungarian assignment (cls + L1 + GIoU costs; the JAX package runs optax's
in-graph ``hungarian_algorithm``) runs on the host: the cost of every decoder
layer and image is built on the device in f32, copied to the host once a
step, and solved by ``scipy.optimize.linear_sum_assignment`` over each
image's real boxes. Where the optimum is unique both give the same pairs
(the JAX package's padded columns cost the same 1e6 under every assignment).

Module names are mmdet's DETRHead names (``input_proj``,
``transformer.{encoder,decoder}.layers.{i}.{attentions,ffns,norms}``, an
attention's packed ``attn.in_proj_weight`` (3E, E) and ``attn.out_proj``,
``query_embedding``, ``fc_cls``, ``reg_ffn.layers.{0.0,1}``, ``fc_reg``). The
sine encoding is the JAX package's (``[sin | cos]`` halves, not mmdet's
interleaved ones), so mmdet weights do not give mmdet's outputs here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchok_tpu_torch.constructor import HEADS
from torchok_tpu_torch.models.base import BaseModel
from torchok_tpu_torch.ops.boxes import giou
from torchok_tpu_torch.ops.common import Dropout, _training_generator, variance_scaling_
from torchok_tpu_torch.ops.knn import topk_lower_index


def sine_positional_encoding(h: int, w: int, dim: int, temperature: float = 10000.0,
                             device: Optional[torch.device] = None) -> torch.Tensor:
    """2D sine positional embedding, (H, W, dim) f32: the y half then the x
    half, each ``[sin | cos]`` over ``dim // 4`` frequencies of pixel-centre
    coordinates scaled to 2 pi."""
    half = dim // 2
    def coords(n: int) -> torch.Tensor:
        return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n * 2 * math.pi

    y, x = coords(h)[:, None, None], coords(w)[None, :, None]
    freq = temperature ** (2 * torch.arange(half // 2, dtype=torch.float32, device=device)
                           / half)
    pos_x, pos_y = x / freq, y / freq
    pe_x = torch.cat([torch.sin(pos_x), torch.cos(pos_x)], -1).expand(h, w, half)
    pe_y = torch.cat([torch.sin(pos_y), torch.cos(pos_y)], -1).expand(h, w, half)
    return torch.cat([pe_y, pe_x], -1)


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


class PackedAttention(nn.Module):
    """Multi-head attention with q, k and v projections packed into one
    ``in_proj_weight`` (torch's ``nn.MultiheadAttention`` layout) and Flax's
    math; dropout on the attention weights with one (Lq, Lk) mask broadcast
    over images and heads (Flax's ``broadcast_dropout``), drawn from
    ``dropout_generator``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.rate = dropout
        self.dropout_generator: Optional[torch.Generator] = None

    def _heads(self, x: torch.Tensor, part: int) -> torch.Tensor:
        e = self.embed_dim
        y = F.linear(x, self.in_proj_weight[part * e:(part + 1) * e],
                     self.in_proj_bias[part * e:(part + 1) * e])
        return y.view(*x.shape[:2], self.num_heads, e // self.num_heads).transpose(1, 2)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor
                ) -> torch.Tensor:
        """(B, Lq, E) queries over (B, Lk, E) keys and values."""
        q, k, v = self._heads(query, 0), self._heads(key, 1), self._heads(value, 2)
        if self.training and self.rate > 0:
            weights = torch.softmax((q * q.shape[-1] ** -0.5) @ k.transpose(-2, -1), -1)
            keep = 1.0 - self.rate
            mask = torch.rand(weights.shape[-2:], device=weights.device,
                              generator=_training_generator(self)) < keep
            out = torch.where(mask, weights / keep, torch.zeros_like(weights)) @ v
        else:
            out = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(query.shape))


class MultiheadAttention(nn.Module):
    """mmcv's ``MultiheadAttention`` wrapper name (``.attn``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.attn = PackedAttention(embed_dim, num_heads, dropout)

    def forward(self, query, key, value):
        return self.attn(query, key, value)


class FFN(nn.Module):
    """mmcv's ``FFN`` names: ``layers.0.0`` the first Linear (then ReLU and
    dropout), ``layers.1`` the second."""

    def __init__(self, embed_dim: int, hidden: int, dropout: float = 0.0,
                 out_act: bool = False):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dim, hidden), nn.ReLU(), Dropout(dropout)),
            nn.Linear(hidden, embed_dim))
        self.out_act = out_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.layers(x)
        return F.relu(y) if self.out_act else y


class TransformerLayer(nn.Module):
    """Post-norm encoder layer: attention (self-attention when ``kv`` is None,
    cross-attention otherwise; the positions added to queries and keys, not
    to values), add & norm, FFN, add & norm."""

    def __init__(self, embed_dim: int, num_heads: int = 8, ffn_dim: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.attentions = nn.ModuleList([MultiheadAttention(embed_dim, num_heads, dropout)])
        self.ffns = nn.ModuleList([FFN(embed_dim, ffn_dim, dropout)])
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dim, eps=1e-5) for _ in range(2)])

    def forward(self, q: torch.Tensor, kv: Optional[torch.Tensor] = None,
                q_pos: Optional[torch.Tensor] = None,
                k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        query = q + q_pos if q_pos is not None else q
        if kv is None:
            attn = self.attentions[0](query, query, q)
        else:
            key = kv + k_pos if k_pos is not None else kv
            attn = self.attentions[0](query, key, kv)
        q = self.norms[0](q + attn)
        return self.norms[1](q + self.ffns[0](q))


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention, cross-attention to the
    memory, FFN, each followed by add & norm."""

    def __init__(self, embed_dim: int, num_heads: int = 8, ffn_dim: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.attentions = nn.ModuleList([MultiheadAttention(embed_dim, num_heads, dropout)
                                         for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(embed_dim, ffn_dim, dropout)])
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dim, eps=1e-5) for _ in range(3)])

    def forward(self, q: torch.Tensor, memory: torch.Tensor, q_pos: torch.Tensor,
                mem_pos: torch.Tensor) -> torch.Tensor:
        query = q + q_pos
        q = self.norms[0](q + self.attentions[0](query, query, q))
        q = self.norms[1](q + self.attentions[1](q + q_pos, memory + mem_pos, memory))
        return self.norms[2](q + self.ffns[0](q))


class _Layers(nn.Module):
    def __init__(self, layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Transformer(nn.Module):
    def __init__(self, encoder: List[nn.Module], decoder: List[nn.Module]):
        super().__init__()
        self.encoder = _Layers(encoder)
        self.decoder = _Layers(decoder)


def hungarian_assign(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-query assigned gt index (-1: none) of a ``(Lyr, B, Q, M)`` cost
    over ``(B, M)`` valid columns: one copy to the host, then
    ``scipy.optimize.linear_sum_assignment`` for each (layer, image) over the
    image's valid columns only. Returns ``(Lyr, B, Q)`` int64 on the cost's
    device."""
    from scipy.optimize import linear_sum_assignment

    lyr, b, q, m = cost.shape
    packed = torch.cat([cost.reshape(-1).float(), valid.reshape(-1).float()]).cpu().numpy()
    cost_np = packed[:lyr * b * q * m].reshape(lyr, b, q, m)
    valid_np = packed[lyr * b * q * m:].reshape(b, m) > 0
    assign = np.full((lyr, b, q), -1, np.int64)
    for img in range(b):
        cols = np.flatnonzero(valid_np[img])
        if not len(cols):
            continue
        for li in range(lyr):
            rows, picked = linear_sum_assignment(cost_np[li, img][:, cols])
            assign[li, img, rows] = cols[picked]
    return torch.from_numpy(assign).to(cost.device)


@HEADS.register_class
class DETRHead(BaseModel):
    def __init__(self, num_classes: int = 80, in_channels: int = 2048, embed_dim: int = 256,
                 num_queries: int = 100, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, num_heads: int = 8, ffn_dim: int = 2048,
                 dropout: float = 0.1, cls_cost_weight: float = 1.0,
                 bbox_cost_weight: float = 5.0, iou_cost_weight: float = 2.0,
                 bg_cls_weight: float = 0.1, sync_cls_avg_factor: bool = False,
                 score_thr: float = 0.0, max_per_img: int = 100,
                 return_intermediate: bool = True, train_cfg: Any = None, test_cfg: Any = None,
                 transformer: Any = None, positional_encoding: Any = None):
        super().__init__()
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.num_queries = num_queries
        self.cls_cost_weight = cls_cost_weight
        self.bbox_cost_weight = bbox_cost_weight
        self.iou_cost_weight = iou_cost_weight
        self.bg_cls_weight = bg_cls_weight
        self.sync_cls_avg_factor = sync_cls_avg_factor  # one device: the factors are global
        self.score_thr = score_thr
        self.max_per_img = max_per_img
        self.return_intermediate = return_intermediate
        # the recipes' nested mmdet train_cfg, transformer and
        # positional_encoding are accepted and ignored, as in the JAX
        # package: the costs and the layout are the flat fields
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.input_proj = nn.Conv2d(in_channels, embed_dim, 1)
        self.transformer = _Transformer(
            [TransformerLayer(embed_dim, num_heads, ffn_dim, dropout)
             for _ in range(num_encoder_layers)],
            [DecoderLayer(embed_dim, num_heads, ffn_dim, dropout)
             for _ in range(num_decoder_layers)])
        self.query_embedding = nn.Embedding(num_queries, embed_dim)
        self.fc_cls = nn.Linear(embed_dim, num_classes + 1)  # + the background class
        self.reg_ffn = FFN(embed_dim, embed_dim, out_act=True)
        self.fc_reg = nn.Linear(embed_dim, 4)

    @property
    def out_channels(self) -> int:
        return self.num_classes

    def forward(self, feats: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The deepest NCHW map -> (Lyr, B, Q, C + 1) class logits and
        (Lyr, B, Q, 4) cxcywh boxes in [0, 1]."""
        x = self.input_proj(feats[-1])
        n, e, h, w = x.shape
        pos = sine_positional_encoding(h, w, e, device=x.device).to(x.dtype)
        memory = x.permute(0, 2, 3, 1).reshape(n, h * w, e)
        mem_pos = pos.reshape(1, h * w, e).expand(n, -1, -1)
        for layer in self.transformer.encoder.layers:
            memory = layer(memory, q_pos=mem_pos)
        q_pos = self.query_embedding.weight[None].expand(n, -1, -1).to(x.dtype)
        q = torch.zeros_like(q_pos)
        inter = []
        for layer in self.transformer.decoder.layers:
            q = layer(q, memory, q_pos, mem_pos)
            inter.append(q)
        qs = torch.stack(inter) if self.return_intermediate else q[None]
        return self.fc_cls(qs), torch.sigmoid(self.fc_reg(self.reg_ffn(qs)))

    @staticmethod
    def format_dict(head_output) -> Dict[str, Any]:
        return dict(zip(["cls_scores_raw", "bbox_preds_raw"], head_output))

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX head's law: ``query_embed`` normal(1.0); Dense,
        DenseGeneral and Conv kernels LeCun normal (an attention's q, k, v
        and out projections each over a fan-in of ``embed_dim``); biases
        zero; LayerNorms one and zero."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                variance_scaling_(m.weight, 1.0, fan_in, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, PackedAttention):
                variance_scaling_(m.in_proj_weight, 1.0, m.embed_dim, generator)
                nn.init.zeros_(m.in_proj_bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.query_embedding.weight, std=1.0, generator=generator)

    # ------------------------------------------------------------------
    def assign(self, cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
               gt_norm: torch.Tensor, gt_labels: torch.Tensor) -> torch.Tensor:
        """Hungarian assignment of every layer and image: (Lyr, B, Q, C + 1)
        logits and (Lyr, B, Q, 4) boxes against (B, M, 4) normalised cxcywh
        gt with (B, M) labels, -1 padded. The cost is the JAX package's,
        in f32: the boxes' corners come in the predictions' dtype, as there."""
        valid = gt_labels >= 0
        with torch.no_grad():
            probs = torch.softmax(cls_scores.float(), -1)
            idx = torch.clamp_min(gt_labels, 0).long()
            lyr, b, q, _ = probs.shape
            cls_cost = -torch.gather(probs, 3, idx[None, :, None, :].expand(lyr, b, q, -1))
            preds = bbox_preds.detach()
            bbox_cost = torch.sum(torch.abs(preds.float()[..., :, None, :]
                                            - gt_norm[None, :, None, :, :]), -1)
            iou_cost = -giou(cxcywh_to_xyxy(preds).float()[..., :, None, :],
                             cxcywh_to_xyxy(gt_norm)[None, :, None, :, :])
            cost = (self.cls_cost_weight * cls_cost + self.bbox_cost_weight * bbox_cost
                    + self.iou_cost_weight * iou_cost)
        return hungarian_assign(cost, valid)

    def loss(self, joint_loss, cls_scores_raw, bbox_preds_raw, gt_bboxes, gt_labels,
             img_shape=None, **kwargs):
        """gt_bboxes (B, M, 4) pixel xyxy; gt_labels (B, M) with -1 padding.
        Every decoder layer gets its own match and loss terms; the earlier
        layers' tags carry mmdet's ``d{i}.`` prefix, the last layer's none.
        The targets and losses of all layers are computed together."""
        if cls_scores_raw.ndim == 3:  # a single layer (return_intermediate off)
            cls_scores_raw, bbox_preds_raw = cls_scores_raw[None], bbox_preds_raw[None]
        hgt, wdt = (int(v) for v in img_shape)
        scale = torch.tensor([wdt, hgt, wdt, hgt], dtype=torch.float32,
                             device=bbox_preds_raw.device)
        gt_norm = xyxy_to_cxcywh(gt_bboxes.float() / scale)
        assign = self.assign(cls_scores_raw, bbox_preds_raw, gt_norm, gt_labels)  # (Lyr, B, Q)
        n_layers = cls_scores_raw.shape[0]
        pos_mask = assign >= 0
        posf = pos_mask.float()
        num_total_pos = torch.clamp_min(torch.sum(posf, (1, 2)), 1.0)
        safe = torch.clamp_min(assign, 0)
        labels = torch.where(pos_mask, torch.gather(gt_labels.long()[None].expand(n_layers, -1, -1),
                                                    2, safe),
                             torch.full_like(safe, self.num_classes))  # background = C
        # background down-weighted (mmdet DETR)
        label_weights = torch.where(pos_mask, torch.ones_like(posf),
                                    torch.full_like(posf, self.bg_cls_weight))
        cls_avg_factor = num_total_pos + self.bg_cls_weight * torch.sum(1.0 - posf, (1, 2))
        matched_gt = torch.gather(gt_norm[None].expand(n_layers, -1, -1, -1), 2,
                                  safe[..., None].expand(*safe.shape, 4))
        preds = bbox_preds_raw.float()
        pred_xyxy = cxcywh_to_xyxy(preds) * scale
        pos4 = pos_mask[..., None]
        bboxes_gt = torch.where(pos4, cxcywh_to_xyxy(matched_gt) * scale, pred_xyxy)
        bbox_targets = torch.where(pos4, matched_gt, preds)
        c = self.num_classes + 1
        targets = dict(
            cls_scores=cls_scores_raw.float().reshape(n_layers, -1, c),
            labels=labels.reshape(n_layers, -1),
            label_weights=label_weights.reshape(n_layers, -1),
            cls_avg_factor=cls_avg_factor,
            bboxes=pred_xyxy.reshape(n_layers, -1, 4),
            bboxes_gt=bboxes_gt.reshape(n_layers, -1, 4),
            bbox_weights=posf.reshape(n_layers, -1),
            num_total_pos=num_total_pos,
            bbox_preds=preds.reshape(n_layers, -1, 4),
            bbox_targets=bbox_targets.reshape(n_layers, -1, 4))
        if all("avg_factor" in m for m in joint_loss.mappings):
            # every layer in one call: a (Lyr,) avg factor reduces each layer
            # alone, so each loss comes back per layer
            total, tagged = joint_loss(**targets)
        else:
            # a loss without an avg factor would average over every layer at
            # once: call the joint loss a layer at a time
            per_layer = [joint_loss(**{k: v[li] for k, v in targets.items()})
                         for li in range(n_layers)]
            total = torch.stack([t for t, _ in per_layer])
            tagged = {k: torch.stack([tg[k] for _, tg in per_layer]) for k in per_layer[0][1]}
        tagged_all = {}
        for li in range(n_layers):
            prefix = "" if li == n_layers - 1 else f"d{li}."
            tagged_all.update({prefix + k: v[li] for k, v in tagged.items()})
        return torch.sum(total), tagged_all

    # ------------------------------------------------------------------
    def _test_cfg(self, key: str, default):
        tc = self.test_cfg or {}
        if hasattr(tc, "to_dict"):
            tc = tc.to_dict()
        return tc.get(key, default)

    def get_bboxes(self, cls_scores_raw, bbox_preds_raw,
                   img_shape: Optional[Tuple[int, int]] = None,
                   **kwargs) -> Dict[str, torch.Tensor]:
        """The last layer's top ``max_per_img`` queries of each image by
        their best foreground probability (ties to the lower query, as
        ``jax.lax.top_k``): ``bboxes`` (B, k, 4) pixel xyxy, ``scores`` and
        ``labels`` (B, k)."""
        if cls_scores_raw.ndim == 4:  # (Lyr, B, Q, .): predict from the last layer
            cls_scores_raw, bbox_preds_raw = cls_scores_raw[-1], bbox_preds_raw[-1]
        hgt, wdt = img_shape
        scale = torch.tensor([wdt, hgt, wdt, hgt], dtype=torch.float32,
                             device=bbox_preds_raw.device)
        probs = torch.softmax(cls_scores_raw.float(), -1)[..., :-1]
        scores, labels = torch.max(probs, -1)  # the first maximum, as jnp.argmax
        score_thr = self._test_cfg("score_thr", self.score_thr)
        if score_thr:
            scores = torch.where(scores > score_thr, scores, torch.zeros_like(scores))
        boxes = cxcywh_to_xyxy(bbox_preds_raw.float()) * scale
        k = min(self._test_cfg("max_per_img", self.max_per_img), scores.shape[1])
        top_scores, idx = topk_lower_index(scores, k)
        top_boxes = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))
        return {"bboxes": top_boxes, "scores": top_scores,
                "labels": torch.gather(labels, 1, idx)}
