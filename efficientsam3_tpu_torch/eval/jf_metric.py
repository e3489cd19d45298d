"""Copy of efficientsam3_tpu/eval/jf_metric.py.

DAVIS-style J&F video object segmentation metric.

J (region similarity) = mask IoU per frame; F (contour accuracy) = boundary
F-measure between dilated contours (standard davis2017-evaluation
formulation). Complements the reference's video evaluators for the
semi-supervised VOS path (TrackerPredictor); the SA-Co evaluators live in
eval/cgf1.py / coco_map.py.
"""

from __future__ import annotations

import numpy as np


def _binary_dilate(m: np.ndarray, iterations: int) -> np.ndarray:
    import scipy.ndimage as ndi

    if iterations <= 0:
        return m
    return ndi.binary_dilation(m, np.ones((3, 3), bool), iterations=iterations)


def _boundary(mask: np.ndarray) -> np.ndarray:
    """One-pixel boundary of a binary mask."""
    import scipy.ndimage as ndi

    if not mask.any():
        return np.zeros_like(mask)
    eroded = ndi.binary_erosion(mask, np.ones((3, 3), bool), border_value=0)
    return mask & ~eroded


def j_measure(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 1.0
    return float(inter / union)


def f_measure(pred: np.ndarray, gt: np.ndarray, bound_ratio: float = 0.008) -> float:
    """Boundary F-measure with tolerance radius ~ 0.8% of the diagonal."""
    bound_pix = max(1, int(round(bound_ratio * np.linalg.norm(pred.shape))))
    fg = _boundary(pred)
    gg = _boundary(gt)
    if not fg.any() and not gg.any():
        return 1.0
    if not fg.any() or not gg.any():
        return 0.0
    fg_d = _binary_dilate(fg, bound_pix)
    gg_d = _binary_dilate(gg, bound_pix)
    precision = (fg & gg_d).sum() / fg.sum()
    recall = (gg & fg_d).sum() / gg.sum()
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def evaluate_vos(pred_masks, gt_masks) -> dict:
    """pred/gt: dict obj_id -> (T, H, W) bool. Returns J/F/J&F means.

    Frames where the object is absent in GT and prediction are skipped
    (davis convention evaluates annotated frames).
    """
    js, fs = [], []
    for obj_id, gt in gt_masks.items():
        pred = pred_masks.get(obj_id)
        for t in range(gt.shape[0]):
            g = gt[t]
            p = pred[t] if pred is not None else np.zeros_like(g)
            if not g.any() and not p.any():
                continue
            js.append(j_measure(p, g))
            fs.append(f_measure(p, g))
    j = float(np.mean(js)) if js else float("nan")
    f = float(np.mean(fs)) if fs else float("nan")
    return {"J": j, "F": f, "J&F": (j + f) / 2}
