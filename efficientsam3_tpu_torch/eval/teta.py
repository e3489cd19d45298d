"""Copy of efficientsam3_tpu/eval/teta.py.

TETA: Track-Every-Thing Accuracy (compact implementation).

Replaces the reference's vendored TETA toolkit
(sam3/sam3/eval/teta_eval_toolkit/.../metrics/teta.py) with the metric's
three-component decomposition (Li et al., ECCV 2022):

  LocA   — localization: TP/(TP+FN+FP) under per-frame Hungarian matching
           at IoU >= threshold (class-agnostic),
  AssocA — association quality over localized TPs (HOTA-style TPA/FPA/FNA),
  ClsA   — classification accuracy over localized TPs,
  TETA   = (LocA + AssocA + ClsA) / 3.

Inputs per frame: gt/pred track ids, classes, and the IoU matrix.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


class TETAEvaluator:
    def __init__(self, loc_threshold: float = 0.5):
        self.thr = loc_threshold
        self.frames = []

    def add_frame(self, gt_ids, pred_ids, iou, gt_classes=None, pred_classes=None):
        g = np.asarray(gt_ids)
        p = np.asarray(pred_ids)
        self.frames.append(
            (
                g,
                p,
                np.asarray(iou, np.float64),
                np.asarray(gt_classes if gt_classes is not None else np.zeros(len(g))),
                np.asarray(
                    pred_classes if pred_classes is not None else np.zeros(len(p))
                ),
            )
        )

    def summarize(self) -> dict:
        tp = fp = fn = 0
        cls_correct = 0
        # association bookkeeping over matched (gt_track, pred_track) pairs
        pair_tp = {}
        gt_card = {}
        pr_card = {}
        matches = []  # (gt_track, pred_track) per TP
        for g, p, iou, gc, pc in self.frames:
            for t in g:
                gt_card[int(t)] = gt_card.get(int(t), 0) + 1
            for t in p:
                pr_card[int(t)] = pr_card.get(int(t), 0) + 1
            if len(g) and len(p):
                score = np.where(iou >= self.thr, iou, 0.0)
                rows, cols = linear_sum_assignment(-score)
                matched_g, matched_p = set(), set()
                for a, b in zip(rows, cols):
                    if score[a, b] > 0:
                        tp += 1
                        key = (int(g[a]), int(p[b]))
                        pair_tp[key] = pair_tp.get(key, 0) + 1
                        matches.append(key)
                        if gc[a] == pc[b]:
                            cls_correct += 1
                        matched_g.add(a)
                        matched_p.add(b)
                fn += len(g) - len(matched_g)
                fp += len(p) - len(matched_p)
            else:
                fn += len(g)
                fp += len(p)

        loc_a = tp / max(tp + fn + fp, 1e-9)
        if tp:
            assoc_scores = []
            for key in matches:
                tpa = pair_tp[key]
                fna = gt_card[key[0]] - tpa
                fpa = pr_card[key[1]] - tpa
                assoc_scores.append(tpa / max(tpa + fna + fpa, 1e-9))
            assoc_a = float(np.mean(assoc_scores))
            cls_a = cls_correct / tp
        else:
            assoc_a = 0.0
            cls_a = 0.0
        return {
            "TETA": (loc_a + assoc_a + cls_a) / 3.0,
            "LocA": loc_a,
            "AssocA": assoc_a,
            "ClsA": cls_a,
        }
