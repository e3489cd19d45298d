"""Automatic mask generation: segment everything by grid-point prompting
over an image-crop pyramid.

Counterpart of efficientsam3_tpu/automatic_mask_generator.py: a regular
point grid per crop layer (``crop_n_layers``, 2^i x 2^i overlapping crops
at layer i, per-layer grid downscaling), predicted-IoU and stability
filtering, crop-edge box suppression, per-crop NMS, cross-crop NMS
preferring smaller crops, and small-region postprocessing, into COCO-style
records (RLE segmentation, area, xywh box, scores, the prompting point,
the crop box), largest first.

Points go through ``sam1_task.InteractiveImagePredictor.predict_batch`` in
batches of ``points_per_batch`` against the cached image embedding; IoU,
stability and low-res boxes come back for every mask, and only the low-res
logits of the masks that survive filtering are upsampled (on the
predictor's device) and fetched. Small-region cleanup labels components
with ``ops/cc.connected_components``; NMS is ``ops/masks.nms_boxes``
(descending score, ties by index).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from efficientsam3_tpu_torch.eval.coco_format import mask_to_rle
from efficientsam3_tpu_torch.ops.cc import connected_components
from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear
from efficientsam3_tpu_torch.ops.masks import nms_boxes


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) normalized xy grid at cell centers."""
    offset = 1.0 / (2 * n_per_side)
    coords = np.linspace(offset, 1.0 - offset, n_per_side)
    xs, ys = np.meshgrid(coords, coords)
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    """Per-crop-layer grids; layer i uses n / scale^i points per side."""
    return [build_point_grid(max(int(n_per_side / (scale_per_layer ** i)), 1))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float) -> Tuple[List[List[int]], List[int]]:
    """Crop boxes of every pyramid layer: layer 0 is the full image, layer i
    has (2^i)^2 crops overlapping by overlap_ratio scaled down with the crop
    count."""
    h, w = im_size
    boxes: List[List[int]] = [[0, 0, w, h]]
    layer_idxs: List[int] = [0]
    short_side = min(h, w)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(w, n_crops_per_side, overlap)
        crop_h = crop_len(h, n_crops_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for y0 in y0s:
            for x0 in x0s:
                boxes.append([x0, y0, min(x0 + crop_w, w), min(y0 + crop_h, h)])
                layer_idxs.append(i_layer + 1)
    return boxes, layer_idxs


def is_box_near_crop_edge(boxes_xyxy: np.ndarray, crop_box: List[int], orig_box: List[int],
                          atol: float = 20.0) -> np.ndarray:
    """True for boxes that touch the crop boundary without touching the
    image boundary: those masks are likely cut by the crop, and a
    neighbouring crop sees them whole."""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    b = np.asarray(boxes_xyxy, np.float32) + np.array([crop[0], crop[1], crop[0], crop[1]])
    near_crop = np.isclose(b, crop[None], atol=atol)
    near_orig = np.isclose(b, orig[None], atol=atol)
    return (near_crop & ~near_orig).any(axis=1)


def _remove_small_regions(mask: np.ndarray, area_thresh: int, mode: str):
    """Drop connected regions of ``mode`` ('holes' | 'islands') smaller than
    area_thresh (8-connected components); (mask, changed)."""
    work = ~mask if mode == "holes" else mask
    labels = connected_components(torch.from_numpy(np.ascontiguousarray(work))).numpy()
    ids, areas = np.unique(labels[labels >= 0], return_counts=True)
    small = set(ids[areas < area_thresh].tolist())
    if not small:
        return mask, False
    drop = np.isin(labels, list(small)) & work
    out = mask | drop if mode == "holes" else mask & ~drop
    return out, True


def _nms(boxes, scores, thresh):
    keep = nms_boxes(torch.as_tensor(np.asarray(boxes, np.float32)),
                     torch.as_tensor(np.asarray(scores, np.float32)), thresh)
    return np.flatnonzero(keep.numpy())


class AutomaticMaskGenerator:
    """predictor: a ``sam1_task.InteractiveImagePredictor`` (``set_image``,
    ``input_size``, ``predict_batch``)."""

    def __init__(self, predictor, points_per_side: Optional[int] = 32,
                 points_per_batch: int = 64, pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95, stability_score_offset: float = 1.0,
                 nms_iou_thresh: float = 0.7, crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7, crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 point_grids: Optional[List[np.ndarray]] = None, min_mask_area: int = 0):
        if (points_per_side is None) == (point_grids is None):
            raise ValueError("exactly one of points_per_side/point_grids")
        if point_grids is not None:
            self.point_grids = point_grids
        else:
            self.point_grids = build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        self.predictor = predictor
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.nms_iou_thresh = nms_iou_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_area = min_mask_area

    def _process_crop(self, image, crop_box, layer_idx, orig_size) -> dict:
        x0, y0, x1, y1 = crop_box
        crop = image[y0:y1, x0:x1]
        ch, cw = crop.shape[:2]
        oh, ow = orig_size
        self.predictor.set_image(crop)
        r = self.predictor.input_size
        pts = self.point_grids[layer_idx] * np.array([cw, ch])

        masks, boxes, ious, stabs, points = [], [], [], [], []
        for s in range(0, len(pts), self.points_per_batch):
            chunk = pts[s:s + self.points_per_batch]
            low, iou, stab, lboxes, empty = self.predictor.predict_batch(
                chunk * np.array([r / cw, r / ch]), self.stability_score_offset)
            iou, stab, lboxes, empty = (t.cpu().numpy() for t in (iou, stab, lboxes, empty))
            keep = (iou > self.pred_iou_thresh) & (stab >= self.stability_score_thresh) & ~empty
            if not keep.any():
                continue
            hl = low.shape[-1]
            cboxes = lboxes * np.array([cw / hl, ch / hl, cw / hl, ch / hl])
            keep &= ~is_box_near_crop_edge(cboxes, crop_box, [0, 0, ow, oh])
            idx = np.flatnonzero(keep)
            if idx.size == 0:
                continue
            kept_low = low[torch.as_tensor(idx, device=low.device)]  # fetch only the kept
            up = (resize_bilinear(kept_low[:, None], (ch, cw))[:, 0] > 0).cpu().numpy()
            for j, i in enumerate(idx):
                masks.append(up[j])
                boxes.append(cboxes[i] + [x0, y0, x0, y0])
                ious.append(float(iou[i]))
                stabs.append(float(stab[i]))
                points.append((pts[s + i // 3] + [x0, y0]).tolist())
        if not masks:
            return {"masks": [], "boxes": [], "ious": [], "stabs": [], "points": [],
                    "crop_boxes": []}
        sel = _nms(boxes, ious, self.nms_iou_thresh)
        return {"masks": [masks[i] for i in sel], "boxes": [boxes[i] for i in sel],
                "ious": [ious[i] for i in sel], "stabs": [stabs[i] for i in sel],
                "points": [points[i] for i in sel], "crop_boxes": [list(crop_box)] * len(sel)}

    def generate(self, image: np.ndarray, max_points: Optional[int] = None) -> list:
        """COCO-style records for everything in ``image`` (H, W, 3)."""
        h, w = image.shape[:2]
        grids = self.point_grids
        if max_points is not None:
            self.point_grids = [g[:max_points] for g in grids]
        try:
            crop_boxes, layer_idxs = generate_crop_boxes((h, w), self.crop_n_layers,
                                                         self.crop_overlap_ratio)
            data = {"masks": [], "boxes": [], "ious": [], "stabs": [], "points": [],
                    "crop_boxes": []}
            for cb, li in zip(crop_boxes, layer_idxs):
                out = self._process_crop(image, cb, li, (h, w))
                for k in data:
                    data[k].extend(out[k])
        finally:
            self.point_grids = grids
        if not data["masks"]:
            return []

        if len(crop_boxes) > 1:
            # prefer masks found by smaller crops (they saw more detail)
            areas = np.asarray([(b[2] - b[0]) * (b[3] - b[1]) for b in data["crop_boxes"]],
                               np.float32)
            sel = _nms(data["boxes"], 1.0 / areas, self.crop_nms_thresh)
            for k in data:
                data[k] = [data[k][i] for i in sel]

        if self.min_mask_area > 0:
            data = self._postprocess_small_regions(data)

        records = []
        for i in range(len(data["masks"])):
            m = data["masks"][i]  # uncropped into the full canvas
            full = m
            if m.shape != (h, w):
                cb = data["crop_boxes"][i]
                full = np.zeros((h, w), bool)
                full[cb[1]:cb[1] + m.shape[0], cb[0]:cb[0] + m.shape[1]] = m
            area = int(full.sum())
            if area == 0:
                continue
            x0, y0, x1, y1 = data["boxes"][i]
            records.append({
                "segmentation": mask_to_rle(full),
                "area": area,
                "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                "predicted_iou": data["ious"][i],
                "stability_score": data["stabs"][i],
                "point_coords": [data["points"][i]],
                "crop_box": list(data["crop_boxes"][i]),
            })
        records.sort(key=lambda r: -r["area"])
        return records

    def _postprocess_small_regions(self, data: dict) -> dict:
        """Fill small holes and drop small islands, then NMS again with the
        changed masks scored below the unchanged ones."""
        new_masks, scores = [], []
        for m in data["masks"]:
            m2, ch1 = _remove_small_regions(m, self.min_mask_area, "holes")
            m2, ch2 = _remove_small_regions(m2, self.min_mask_area, "islands")
            new_masks.append(m2)
            scores.append(0.9 if (ch1 or ch2) else 1.0)
        boxes = []
        for m, cb in zip(new_masks, data["crop_boxes"]):
            ys, xs = np.nonzero(m)
            # masks are at crop resolution; boxes live in full-image coords
            boxes.append([cb[0] + xs.min(), cb[1] + ys.min(), cb[0] + xs.max() + 1,
                          cb[1] + ys.max() + 1] if xs.size else [0, 0, 0, 0])
        sel = _nms(boxes, scores, max(self.nms_iou_thresh, self.crop_nms_thresh))
        out = {k: [data[k][i] for i in sel] for k in data}
        out["masks"] = [new_masks[i] for i in sel]
        out["boxes"] = [boxes[i] for i in sel]
        return out
