"""Detection losses for SAM3 training.

Counterpart of efficientsam3_tpu/train/losses.py: ``sam3_detection_loss``
with deep supervision over every decoder layer (IABCEMdetr classification
with soft IoU-aware targets, presence focal loss, box L1 + GIoU, mask focal
+ dice at the target resolution or at PointRend-sampled points), the
one-to-many (DAC) matcher and losses on the final layer, the o2o Hungarian
matcher on the aux o2m layers, and the optional semantic-segmentation
criterion, weighted as the stage-3 mixed config (loss_ce 20, presence 20,
bbox 5, giou 2, mask 200, dice 10, o2m_weight 2, semantic 0). Every loss
runs over fixed-width padded targets with validity masks; the Hungarian
assignments of all layers come from one host solve
(``train/matcher.py``). ``det2trk_assoc_loss`` is the video association
loss of ``train/video_assoc.py``.

The model's outputs are taken in fp32 (the bf16 model's logits, boxes and
masks are cast once on entry). JAX's ``rng`` keys become an explicit
``torch.Generator`` (``rng``); the uniform draws of the two packages
differ, so the PointRend sampling is split into the draw
(``draw_point_coords``) and the selection (``select_uncertain_points``),
which the tests feed with JAX's coordinates.

``semantic_seg_loss`` takes (B, 1, h, w) or (B, h, w) maps, as JAX's does.
The seg head returns its map NHWC, (B, Hm, Wm, 1); JAX's
``sam3_detection_loss`` hands it over as it is, so its criterion reads the
map's first row as a (Wm, 1) image. The port hands it the map as
(B, Hm, Wm), the layout the function documents (ROADMAP, "Numerics
choices").
"""

from __future__ import annotations

from typing import Optional

import torch

from efficientsam3_tpu_torch.models.decoder import box_cxcywh_to_xyxy
from efficientsam3_tpu_torch.ops.focal_loss import optax_bce, sigmoid_focal_loss
from efficientsam3_tpu_torch.ops.grid_sample import grid_sample
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


def _point_sample(maps, coords):
    """Bilinear samples of (N, H, W) maps at (N, P, 2) xy coords in
    [0, 1]^2 (F.grid_sample, align_corners=False, zeros outside)."""
    grid = (coords * 2.0 - 1.0)[:, :, None, :]  # (N, P, 1, 2)
    return grid_sample(maps[:, None], grid)[:, 0, :, 0]


def draw_point_coords(rng: torch.Generator, n: int, num_points: int, oversample_ratio: float,
                      importance_sample_ratio: float, device):
    """PointRend's uniform draws: (oversampled candidates (N, S, 2), fresh
    points (N, R, 2)), S = num_points * oversample_ratio, R = num_points -
    importance_sample_ratio * num_points, on the generator's device and
    moved to ``device``."""
    num_sampled = int(num_points * oversample_ratio)
    num_random = num_points - int(importance_sample_ratio * num_points)
    coords = torch.rand((n, num_sampled, 2), generator=rng, device=rng.device)
    fresh = torch.rand((n, num_random, 2), generator=rng, device=rng.device)
    return coords.to(device), fresh.to(device)


def select_uncertain_points(logits, coords, fresh, num_uncertain: int):
    """The num_uncertain candidates whose sampled logit is nearest 0 (top-k
    of -|logit|), then the fresh points: (N, num_uncertain + R, 2)."""
    unc = -_point_sample(logits, coords).abs()
    idx = torch.topk(unc, num_uncertain, dim=-1).indices
    picked = coords.gather(1, idx[..., None].expand(*idx.shape, 2))
    return torch.cat([picked, fresh], dim=1)


def sample_uncertain_points(rng: torch.Generator, logits, num_points: int,
                            oversample_ratio: float, importance_sample_ratio: float):
    """PointRend uncertainty sampling: oversample uniformly, keep the most
    uncertain (|logit| smallest) fraction, fill the rest with fresh
    uniform points. logits (N, h, w) -> (N, num_points, 2)."""
    coords, fresh = draw_point_coords(rng, logits.shape[0], num_points, oversample_ratio,
                                      importance_sample_ratio, logits.device)
    return select_uncertain_points(logits, coords, fresh,
                                   int(importance_sample_ratio * num_points))


def mask_focal_dice_loss(pred_masks, tgt_masks, valid, num_boxes, *, alpha: float = 0.25,
                         gamma: float = 2.0, num_sample_points: Optional[int] = None,
                         oversample_ratio: float = 3.0, importance_sample_ratio: float = 0.75,
                         rng: Optional[torch.Generator] = None):
    """Focal + dice of matched mask logits (B, T, h, w) against the targets
    (B, T, H, W), each summed over valid pairs / num_boxes: the logits
    bilinearly resized to the targets' resolution, or, with
    num_sample_points, both sampled at that many PointRend points a mask
    (drawn from ``rng``, chosen on the detached logits; the targets'
    samples carry no gradient)."""
    b, t = valid.shape
    if num_sample_points is not None:
        if rng is None:
            raise ValueError("the sampled mask loss needs an rng")
        flat_pred = pred_masks.reshape(b * t, *pred_masks.shape[-2:])
        flat_tgt = tgt_masks.reshape(b * t, *tgt_masks.shape[-2:])
        coords = sample_uncertain_points(rng, flat_pred.detach(), num_sample_points,
                                         oversample_ratio, importance_sample_ratio)
        p = _point_sample(flat_pred, coords)
        tg = _point_sample(flat_tgt, coords).detach()
    else:
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


def semantic_seg_loss(semantic_logits, tgt_masks, tgt_valid, *, presence_logit=None,
                      focal: bool = False, focal_alpha: float = 0.6, focal_gamma: float = 1.6,
                      presence_head: bool = False):
    """SemanticSegCriterion: BCE (or focal) + dice between the semantic map
    (B, 1, h, w) or (B, h, w) and the union of the valid instance masks
    (B, T, H, W), bilinearly resized to (h, w) and thresholded at 0.5.
    With presence_head, a BCE on presence_logit (B,) against "any target
    pixel", and the map losses only over samples that have one."""
    if semantic_logits.ndim == 4:
        semantic_logits = semantic_logits[:, 0]
    b, h, w = semantic_logits.shape
    tgt = resize_bilinear(tgt_masks.float(), (h, w)) * tgt_valid[:, :, None, None]
    tf = (tgt > 0.5).any(dim=1).float().reshape(b, -1)  # union, (B, h w)
    x = semantic_logits.reshape(b, -1)
    if focal:
        per = sigmoid_focal_loss(x, tf, focal_alpha, focal_gamma).mean(-1)
    else:
        per = optax_bce(x, tf).mean(-1)
    ps = torch.sigmoid(x)
    dice = 1.0 - (2.0 * (ps * tf).sum(-1) + 1.0) / (ps.sum(-1) + tf.sum(-1) + 1.0)
    if not presence_head:
        return {"loss_semantic_seg": per.mean(), "loss_semantic_dice": dice.sum() / b}
    if presence_logit is None:
        raise ValueError("presence_head needs presence_logit")
    p_tgt = tf.bool().any(-1)
    nb = p_tgt.sum() + 1e-6
    return {
        "loss_semantic_presence": optax_bce(presence_logit.reshape(b), p_tgt.float()).mean(),
        "loss_semantic_seg": (per * p_tgt).sum() / nb,
        "loss_semantic_dice": (dice * p_tgt).sum() / nb,
    }


def det2trk_assoc_loss(assoc_logits, matched_object_ids, num_boxes, *, pred_logits=None,
                       is_exhaustive=None, use_fp_loss: bool = False,
                       fp_loss_on_exhaustive_only: bool = True,
                       treat_fp_as_new_obj: bool = False):
    """Detection -> tracking association loss (Det2TrkAssoc).

    assoc_logits (B, Q_det, Q_trk + 2) [..., new object, false positive];
    matched_object_ids (B, Q_det + Q_trk), -1 unmatched. A detection's label
    is the first tracking query with its object id; Q_trk ("new object")
    when it is matched but no track has its id; with use_fp_loss Q_trk + 1
    ("false positive", or Q_trk with treat_fp_as_new_obj) for unmatched
    detections whose pred_logits (B, Q_det, 1) is above 0 (on exhaustive
    samples only, when fp_loss_on_exhaustive_only and is_exhaustive (B,) are
    given); -1 (ignored) otherwise. Softmax CE over frames with at least
    one track, summed / (B * num_boxes)."""
    b, q_det, q_tot = assoc_logits.shape
    q_trk = q_tot - 2
    ids_det = matched_object_ids[:, :q_det]
    ids_trk = matched_object_ids[:, q_det:]
    det_m = ids_det >= 0
    trk_m = ids_trk >= 0
    same = det_m[:, :, None] & trk_m[:, None, :] & (ids_det[:, :, None] == ids_trk[:, None, :])
    has_same = same.any(-1)
    labels = torch.where(has_same, same.to(torch.uint8).argmax(-1), -1)
    labels = torch.where(det_m & ~has_same, q_trk, labels)
    if use_fp_loss:
        if pred_logits is None:
            raise ValueError("use_fp_loss needs pred_logits")
        fp = ~det_m & (pred_logits[..., 0] > 0)
        if treat_fp_as_new_obj:
            fp_label = q_trk
        else:
            if fp_loss_on_exhaustive_only and is_exhaustive is not None:
                fp = fp & is_exhaustive[:, None]
            fp_label = q_trk + 1
        labels = torch.where(fp, fp_label, labels)
    logp = torch.log_softmax(assoc_logits, dim=-1)
    ce = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(ce.dtype)
    frame_has_trk = trk_m.any(-1, keepdim=True).to(ce.dtype)
    return (ce * mask * frame_has_trk).sum() / (b * num_boxes)


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
                  alpha: float = 0.25, gamma: float = 2.0, **sampling):
    """Mask losses over o2m pairs with fixed shapes: per target the top-k
    candidate queries by quality, masked by the actual match bit (the
    matcher keeps at most topk + 1 queries a target, so k = topk + 2 loses
    nothing). ``sampling``: mask_focal_dice_loss's PointRend arguments."""
    b, q, t = match.shape
    scores = torch.where(match, c, torch.full_like(c, -torch.inf))
    top_c, top_q = torch.topk(scores.transpose(1, 2), k, dim=-1)  # (B, T, K)
    sel_masks = _gather_queries(pred_masks, top_q.reshape(b, t * k))
    tgt = tgt_masks[:, :, None].expand(b, t, k, *tgt_masks.shape[-2:])
    return mask_focal_dice_loss(sel_masks, tgt.reshape(b, t * k, *tgt_masks.shape[-2:]),
                                torch.isfinite(top_c).reshape(b, t * k), num_boxes,
                                alpha=alpha, gamma=gamma, **sampling)


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
                        o2m_topk: int = 4, num_boxes=None,
                        num_sample_points: Optional[int] = None,
                        rng: Optional[torch.Generator] = None, mask_aux: bool = False):
    """Full Sam3 detection loss with deep supervision.

    outputs: ``Sam3ImageModel`` outputs in training mode (pred_logits,
    pred_boxes, pred_masks, presence_logit_dec, aux, *_o2m). targets:
    'boxes' (B, T, 4) cxcywh, 'valid' (B, T) bool, optional 'masks'
    (B, T, H, W), 'mask_valid' (B, T), 'is_exhaustive' (B,).
    num_sample_points: the PointRend-sampled mask losses, drawn from
    ``rng`` (the final o2o layer's points first, then the o2m layer's).
    mask_aux: as in JAX, where it changes nothing: the mask losses run on
    the final layer alone (the aux layers carry no masks). Nonzero
    loss_semantic_seg / loss_semantic_dice weights add
    ``semantic_seg_loss`` of the (B, Hm, Wm) map.
    Returns (total, parts) with the JAX package's keys (loss_ce, loss_bbox,
    ..., with _aux_{i} / _o2m suffixes).
    """
    w = dict(DEFAULT_WEIGHTS, **(weights or {}))
    sampling = dict(num_sample_points=num_sample_points, rng=rng)
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
                                          mvalid, num_boxes, alpha=alpha, gamma=gamma,
                                          **sampling)
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
                                   num_boxes, k=o2m_topk + 2, alpha=alpha, gamma=gamma,
                                   **sampling)
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

    if (f32.get("semantic_seg") is not None and masks is not None
            and (w["loss_semantic_seg"] or w["loss_semantic_dice"])):
        for k_, v_ in semantic_seg_loss(f32["semantic_seg"][..., 0], masks, tgt_valid).items():
            total = total + add(k_, v_, k_)
    return total, parts
