"""Detection losses of Stage-3 training.

Counterpart of efficientsam3_tpu/train/losses.py for what
``stage3_train_step`` runs: ``sam3_detection_loss`` with deep supervision
over every decoder layer (IABCEMdetr classification with soft IoU-aware
targets, presence focal loss, box L1 + GIoU, mask focal + dice at the
target resolution), the one-to-many (DAC) matcher and losses on the final
layer, and the o2o Hungarian matcher on the aux o2m layers, weighted as the
stage-3 mixed config (loss_ce 20, presence 20, bbox 5, giou 2, mask 200,
dice 10, o2m_weight 2). Every loss runs over fixed-width padded targets
with validity masks; the Hungarian assignments of all layers come from one
host solve (``train/matcher.py``).

The model's outputs are taken in fp32 (the bf16 model's logits, boxes and
masks are cast once on entry). Not ported yet: the PointRend-sampled mask
loss (``num_sample_points``, unused by stage 3), ``semantic_seg_loss``
(weight 0 by default) and ``det2trk_assoc_loss`` (video training).
"""

from __future__ import annotations

from typing import Optional

import torch

from efficientsam3_tpu_torch.models.decoder import box_cxcywh_to_xyxy
from efficientsam3_tpu_torch.ops.focal_loss import optax_bce, sigmoid_focal_loss
from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear
from efficientsam3_tpu_torch.ops.masks import box_iou_xyxy, generalized_box_iou
from efficientsam3_tpu_torch.train.matcher import hungarian_match


def _diag_iou_union(a_xyxy, b_xyxy, eps):
    """(IoU, union) of aligned boxes (no epsilon but the floor)."""
    lt = torch.maximum(a_xyxy[..., :2], b_xyxy[..., :2])
    rb = torch.minimum(a_xyxy[..., 2:], b_xyxy[..., 2:])
    inter = (rb - lt).clamp_min(0.0).prod(-1)
    area_a = (a_xyxy[..., 2:] - a_xyxy[..., :2]).clamp_min(0.0).prod(-1)
    area_b = (b_xyxy[..., 2:] - b_xyxy[..., :2]).clamp_min(0.0).prod(-1)
    union = area_a + area_b - inter
    return inter / union.clamp_min(eps), union


def diag_box_iou(a_xyxy, b_xyxy, eps: float = 1e-9):
    """Elementwise IoU of aligned boxes."""
    return _diag_iou_union(a_xyxy, b_xyxy, eps)[0]


def diag_generalized_box_iou(a_xyxy, b_xyxy, eps: float = 1e-9):
    """Elementwise GIoU of aligned boxes."""
    iou, union = _diag_iou_union(a_xyxy, b_xyxy, eps)
    lt = torch.minimum(a_xyxy[..., :2], b_xyxy[..., :2])
    rb = torch.maximum(a_xyxy[..., 2:], b_xyxy[..., 2:])
    hull = (rb - lt).clamp_min(0.0).prod(-1)
    return iou - (hull - union) / hull.clamp_min(eps)


def _gather_queries(per_query, assigned):
    """per_query (B, Q, ...) indexed by assigned (B, T) -> (B, T, ...)."""
    rows = torch.arange(per_query.shape[0], device=per_query.device)[:, None]
    return per_query[rows, assigned]


def iabce_classification_loss(pred_logits, pred_boxes, assigned, tgt_boxes, tgt_valid, *,
                              pos_weight: float = 10.0, alpha: float = 0.25,
                              gamma: float = 2.0, use_presence: bool = True,
                              is_exhaustive=None):
    """Soft-target BCE (IABCEMdetr): matched queries get the detached
    target prob^alpha * IoU^(1 - alpha) (at least 0.01) weighted by
    pos_weight, unmatched ones BCE against 0 modulated by prob^gamma; with
    use_presence samples with no visible target contribute 0. Mean over
    (B, Q), or the weak-loss masked mean with is_exhaustive (B,)."""
    s = pred_logits[..., 0]
    prob = torch.sigmoid(s)
    b, q = s.shape
    iou = diag_box_iou(box_cxcywh_to_xyxy(_gather_queries(pred_boxes, assigned)),
                       box_cxcywh_to_xyxy(tgt_boxes))
    t_soft = (_gather_queries(prob, assigned) ** alpha
              * iou.clamp_min(0.0) ** (1 - alpha)).clamp_min(0.01)
    t_soft = torch.where(tgt_valid, t_soft, torch.zeros_like(t_soft)).detach()
    zeros = torch.zeros((b, q), dtype=s.dtype, device=s.device)
    # Hungarian assignments are distinct per sample: scatter-add == set
    target_classes = zeros.scatter_add(1, assigned, tgt_valid.to(s.dtype))
    positive_targets = zeros.scatter_add(1, assigned, t_soft)

    loss = optax_bce(s, positive_targets) * target_classes * pos_weight
    loss = loss + optax_bce(s, target_classes) * (1.0 - target_classes) * prob ** gamma
    if use_presence:
        visible = tgt_valid & (tgt_boxes[..., 2] > 0) & (tgt_boxes[..., 3] > 0)
        loss = loss * visible.any(-1, keepdim=True).to(loss.dtype)
    if is_exhaustive is not None:
        loss_mask = ~((~is_exhaustive)[:, None] & (target_classes < 0.5))
        loss = loss * loss_mask.to(loss.dtype)
        return loss.sum() / (loss_mask.sum() + 1e-6)
    return loss.mean()


def presence_focal_loss(presence_logits, keep, alpha: float = 0.5, gamma: float = 0.0):
    """Focal BCE on the presence token, normalised by the batch size."""
    pl = presence_logits.reshape(keep.shape)
    return sigmoid_focal_loss(pl, keep.to(pl.dtype), alpha, gamma).sum() / pl.shape[0]


def box_losses(pred_boxes, assigned, tgt_boxes, tgt_valid, num_boxes):
    """L1 + GIoU on matched pairs, each summed / num_boxes."""
    matched = _gather_queries(pred_boxes, assigned)
    valid = tgt_valid.to(pred_boxes.dtype)
    l1 = ((matched - tgt_boxes).abs().sum(-1) * valid).sum()
    giou = diag_generalized_box_iou(box_cxcywh_to_xyxy(matched), box_cxcywh_to_xyxy(tgt_boxes))
    return l1 / num_boxes, ((1.0 - giou) * valid).sum() / num_boxes


def mask_focal_dice_loss(pred_masks, tgt_masks, valid, num_boxes, *, alpha: float = 0.25,
                         gamma: float = 2.0):
    """Focal + dice of matched mask logits (B, T, h, w), bilinearly resized
    to the targets' (B, T, H, W) resolution; each summed over valid pairs /
    num_boxes."""
    b, t = valid.shape
    hw = tgt_masks.shape[-2:]
    up = resize_bilinear(pred_masks.reshape(b * t, 1, *pred_masks.shape[-2:]), hw)[:, 0]
    p = up.reshape(b * t, hw[0] * hw[1])
    tg = tgt_masks.reshape(b * t, hw[0] * hw[1])
    vf = valid.to(p.dtype).reshape(b * t)
    loss_mask = (sigmoid_focal_loss(p, tg, alpha, gamma).mean(-1) * vf).sum() / num_boxes
    ps = torch.sigmoid(p)
    num = 2.0 * (ps * tg).sum(-1)
    den = ps.sum(-1) + tg.sum(-1)
    loss_dice = ((1.0 - (num + 1.0) / (den + 1.0)) * vf).sum() / num_boxes
    return loss_mask, loss_dice


def one_to_many_match(pred_logits, pred_boxes, tgt_boxes, tgt_valid, *, alpha: float = 0.3,
                      threshold: float = 0.4, topk: int = 4):
    """BinaryOneToManyMatcher: quality C = alpha prob + (1 - alpha) IoU; a
    (query, target) pair matches iff C beats the per-target top-k quantile
    over the queries and the threshold. Returns (match (B, Q, T) bool, C,
    IoU)."""
    q = pred_logits.shape[1]
    prob = torch.sigmoid(pred_logits[..., 0])
    iou = box_iou_xyxy(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(tgt_boxes))
    c = alpha * prob[:, :, None] + (1.0 - alpha) * iou
    quant = torch.quantile(c, 1.0 - topk / q, dim=1, keepdim=True)
    match = (c > quant) & (c > threshold) & tgt_valid[:, None, :]
    return match, c, iou


def o2m_classification_loss(pred_logits, match, iou, tgt_valid, *, pos_weight: float = 10.0,
                            alpha: float = 0.25, gamma: float = 2.0, use_presence: bool = True):
    """IABCEMdetr on one-to-many matches; a query matched to several targets
    takes the soft target of its last matched target."""
    s = pred_logits[..., 0]
    prob = torch.sigmoid(s)
    t = match.shape[-1]
    target_classes = match.any(-1).to(s.dtype)
    last_idx = t - 1 - match.flip(-1).to(torch.uint8).argmax(-1)
    iou_sel = iou.gather(-1, last_idx[..., None])[..., 0]
    t_soft = (prob ** alpha * iou_sel.clamp_min(0.0) ** (1 - alpha)).clamp_min(0.01)
    t_soft = (t_soft * target_classes).detach()
    loss = optax_bce(s, t_soft) * target_classes * pos_weight
    loss = loss + optax_bce(s, target_classes) * (1.0 - target_classes) * prob ** gamma
    if use_presence:
        loss = loss * tgt_valid.any(-1, keepdim=True).to(loss.dtype)
    return loss.mean()


def o2m_box_losses(pred_boxes, match, tgt_boxes, num_boxes):
    """L1 + GIoU summed over every matched (query, target) pair."""
    l1 = (pred_boxes[:, :, None] - tgt_boxes[:, None, :]).abs().sum(-1)
    giou = generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(tgt_boxes))
    m = match.to(pred_boxes.dtype)
    return (l1 * m).sum() / num_boxes, ((1.0 - giou) * m).sum() / num_boxes


def o2m_mask_loss(pred_masks, match, c, tgt_masks, num_boxes, *, k: int = 6,
                  alpha: float = 0.25, gamma: float = 2.0):
    """Mask losses over o2m pairs with fixed shapes: per target the top-k
    candidate queries by quality, masked by the actual match bit (the
    matcher keeps at most topk + 1 queries a target, so k = topk + 2 loses
    nothing)."""
    b, q, t = match.shape
    scores = torch.where(match, c, torch.full_like(c, -torch.inf))
    top_c, top_q = torch.topk(scores.transpose(1, 2), k, dim=-1)  # (B, T, K)
    sel_masks = _gather_queries(pred_masks, top_q.reshape(b, t * k))
    tgt = tgt_masks[:, :, None].expand(b, t, k, *tgt_masks.shape[-2:])
    return mask_focal_dice_loss(sel_masks, tgt.reshape(b, t * k, *tgt_masks.shape[-2:]),
                                torch.isfinite(top_c).reshape(b, t * k), num_boxes,
                                alpha=alpha, gamma=gamma)


DEFAULT_WEIGHTS = {
    "loss_ce": 20.0,
    "presence_loss": 20.0,
    "loss_bbox": 5.0,
    "loss_giou": 2.0,
    "loss_mask": 200.0,
    "loss_dice": 10.0,
    "loss_semantic_seg": 0.0,
    "loss_semantic_dice": 0.0,
}


def sam3_detection_loss(outputs, targets, weights: Optional[dict] = None, *,
                        o2m_weight: float = 2.0, pos_weight: float = 10.0, alpha: float = 0.25,
                        gamma: float = 2.0, o2m_alpha: float = 0.3, o2m_threshold: float = 0.4,
                        o2m_topk: int = 4, num_boxes=None):
    """Full Sam3 detection loss with deep supervision.

    outputs: ``Sam3ImageModel`` outputs in training mode (pred_logits,
    pred_boxes, pred_masks, presence_logit_dec, aux, *_o2m). targets:
    'boxes' (B, T, 4) cxcywh, 'valid' (B, T) bool, optional 'masks'
    (B, T, H, W), 'mask_valid' (B, T), 'is_exhaustive' (B,).
    Returns (total, parts) with the JAX package's keys (loss_ce, loss_bbox,
    ..., with _aux_{i} / _o2m suffixes).
    """
    w = dict(DEFAULT_WEIGHTS, **(weights or {}))
    if w["loss_semantic_seg"] or w["loss_semantic_dice"]:
        raise NotImplementedError("semantic_seg_loss is not ported yet (ROADMAP Queue 1 item 18)")
    f32 = {k: v.float() for k, v in outputs.items()
           if isinstance(v, torch.Tensor) and v.is_floating_point()}
    aux = {k: v.float() for k, v in (outputs.get("aux") or {}).items() if v is not None}
    tgt_boxes = targets["boxes"].float()
    tgt_valid = targets["valid"].bool()
    is_exh = targets.get("is_exhaustive")
    if num_boxes is None:
        num_boxes = tgt_valid.sum().float().clamp_min(1.0)
    nq = f32["pred_logits"].shape[1]

    o2o_layers = [(f32["pred_logits"], f32["pred_boxes"])]
    o2m_aux_layers = []
    if aux:
        for i in range(aux["pred_logits"].shape[0]):
            o2o_layers.insert(i, (aux["pred_logits"][i][:, :nq], aux["pred_boxes"][i][:, :nq]))
            if aux["pred_logits"].shape[2] > nq:
                o2m_aux_layers.append((aux["pred_logits"][i][:, nq:],
                                       aux["pred_boxes"][i][:, nq:]))

    # one Hungarian solve for every o2o layer and every aux-o2m layer
    all_pairs = o2o_layers + o2m_aux_layers
    logits_all = torch.stack([p[0] for p in all_pairs]).detach()  # (S, B, Q, 1)
    boxes_all = torch.stack([p[1] for p in all_pairs]).detach()
    s, b = logits_all.shape[:2]
    assigned_all, _ = hungarian_match(logits_all.reshape(s * b, nq, 1),
                                      boxes_all.reshape(s * b, nq, 4),
                                      tgt_boxes.repeat(s, 1, 1), tgt_valid.repeat(s, 1))
    assigned_all = assigned_all.reshape(s, b, -1)

    n_layers = len(o2o_layers)
    parts = {}
    total = 0.0

    def add(key, value, weight_key):
        parts[key] = value
        return w.get(weight_key, 0.0) * value

    visible = tgt_valid & (tgt_boxes[..., 2] > 0) & (tgt_boxes[..., 3] > 0)
    keep = visible.any(-1).float()
    masks = targets.get("masks")
    masks = None if masks is None else masks.float()
    mvalid = tgt_valid & targets.get("mask_valid", tgt_valid).bool()

    for i, (logits, boxes) in enumerate(o2o_layers):
        is_final = i == n_layers - 1
        suffix = "" if is_final else f"_aux_{i}"
        assigned = assigned_all[i]
        ce = iabce_classification_loss(logits, boxes, assigned, tgt_boxes, tgt_valid,
                                       pos_weight=pos_weight, alpha=alpha, gamma=gamma,
                                       use_presence=True, is_exhaustive=is_exh)
        total = total + add(f"loss_ce{suffix}", ce, "loss_ce")
        lb, lg = box_losses(boxes, assigned, tgt_boxes, tgt_valid, num_boxes)
        total = total + add(f"loss_bbox{suffix}", lb, "loss_bbox")
        total = total + add(f"loss_giou{suffix}", lg, "loss_giou")
        pres = f32.get("presence_logit_dec") if is_final else aux.get("presence_logits")
        if pres is not None:
            pres = pres if is_final else pres[i]
            total = total + add(f"presence_loss{suffix}", presence_focal_loss(pres, keep),
                                "presence_loss")
        if is_final and "pred_masks" in f32 and masks is not None:
            lm, ld = mask_focal_dice_loss(_gather_queries(f32["pred_masks"], assigned), masks,
                                          mvalid, num_boxes, alpha=alpha, gamma=gamma)
            total = total + add(f"loss_mask{suffix}", lm, "loss_mask")
            total = total + add(f"loss_dice{suffix}", ld, "loss_dice")

    # o2m (DAC) losses on the final layer
    if "pred_logits_o2m" in f32:
        match, c, iou = one_to_many_match(
            f32["pred_logits_o2m"].detach(), f32["pred_boxes_o2m"].detach(), tgt_boxes,
            tgt_valid, alpha=o2m_alpha, threshold=o2m_threshold, topk=o2m_topk)
        ce = o2m_classification_loss(f32["pred_logits_o2m"], match, iou, tgt_valid,
                                     pos_weight=pos_weight, alpha=alpha, gamma=gamma)
        total = total + o2m_weight * add("loss_ce_o2m", ce, "loss_ce")
        lb, lg = o2m_box_losses(f32["pred_boxes_o2m"], match, tgt_boxes, num_boxes)
        total = total + o2m_weight * add("loss_bbox_o2m", lb, "loss_bbox")
        total = total + o2m_weight * add("loss_giou_o2m", lg, "loss_giou")
        if "pred_masks_o2m" in f32 and masks is not None:
            lm, ld = o2m_mask_loss(f32["pred_masks_o2m"], match & mvalid[:, None, :], c, masks,
                                   num_boxes, k=o2m_topk + 2, alpha=alpha, gamma=gamma)
            total = total + o2m_weight * add("loss_mask_o2m", lm, "loss_mask")
            total = total + o2m_weight * add("loss_dice_o2m", ld, "loss_dice")

    # aux o2m layers with the o2o Hungarian matcher
    for j, (logits, boxes) in enumerate(o2m_aux_layers):
        assigned = assigned_all[n_layers + j]
        suffix = f"_aux_{j}_o2m"
        ce = iabce_classification_loss(logits, boxes, assigned, tgt_boxes, tgt_valid,
                                       pos_weight=pos_weight, alpha=alpha, gamma=gamma,
                                       use_presence=True, is_exhaustive=is_exh)
        total = total + o2m_weight * add(f"loss_ce{suffix}", ce, "loss_ce")
        lb, lg = box_losses(boxes, assigned, tgt_boxes, tgt_valid, num_boxes)
        total = total + o2m_weight * add(f"loss_bbox{suffix}", lb, "loss_bbox")
        total = total + o2m_weight * add(f"loss_giou{suffix}", lg, "loss_giou")
    return total, parts
