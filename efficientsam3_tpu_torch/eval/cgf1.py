"""Copy of efficientsam3_tpu/eval/cgf1.py.

cgF1: the official Promptable Concept Segmentation metric.

Reimplements the reference evaluator's semantics (sam3/sam3/eval/
cgf1_eval.py:330-466) without pycocotools: per (image, prompt) pair,
detections and ground truths are Hungarian-matched on IoU per threshold
(0.5:0.95:0.05); TPs/FPs/FNs accumulate micro-averaged F1; image-level
presence decisions accumulate the Matthews correlation coefficient; the
headline score is

    cgF1 = positive_micro_F1 * IL_MCC.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

IOU_THRS = np.arange(0.5, 1.0, 0.05)


class CGF1Evaluator:
    """Feed (dt, gt) per image-prompt pair via add(); finish with summarize().

    dt/gt are IoU-comparable sets: pass a precomputed IoU matrix, or mask
    arrays (IoU computed here).
    """

    def __init__(self, iou_thrs=IOU_THRS):
        self.iou_thrs = np.asarray(iou_thrs)
        self.per_image = []

    def add(self, iou: np.ndarray, num_dt: int, num_gt: int):
        """iou: (num_dt, num_gt) IoU matrix (may be 0-size)."""
        t = len(self.iou_thrs)
        res = {
            "IL_TP": num_gt > 0 and num_dt > 0,
            "IL_FP": num_gt == 0 and num_dt > 0,
            "IL_TN": num_gt == 0 and num_dt == 0,
            "IL_FN": num_gt > 0 and num_dt == 0,
            "num_dt": num_dt,
        }
        tps = np.zeros(t, np.int64)
        if num_dt and num_gt:
            rows, cols = linear_sum_assignment(-iou)
            matched = iou[rows, cols]
            for i, thr in enumerate(self.iou_thrs):
                tps[i] = int((matched >= thr).sum())
        res["TPs"] = tps
        res["FPs"] = num_dt - tps
        res["FNs"] = num_gt - tps
        res["positive_pair"] = num_gt > 0 and num_dt > 0
        self.per_image.append(res)

    def add_masks(self, dt_masks: np.ndarray, gt_masks: np.ndarray):
        from efficientsam3_tpu_torch.eval.coco_format import mask_iou_np

        iou = (
            mask_iou_np(dt_masks, gt_masks)
            if len(dt_masks) and len(gt_masks)
            else np.zeros((len(dt_masks), len(gt_masks)))
        )
        self.add(iou, len(dt_masks), len(gt_masks))

    def summarize(self) -> dict:
        t = len(self.iou_thrs)
        TPs = np.zeros(t, np.int64)
        FPs = np.zeros(t, np.int64)
        pmFPs = np.zeros(t, np.int64)
        FNs = np.zeros(t, np.int64)
        local_f1 = np.zeros(t, np.float64)
        IL_TP = IL_FP = IL_TN = IL_FN = 0
        valid_f1 = 0
        for r in self.per_image:
            IL_TP += r["IL_TP"]
            IL_FP += r["IL_FP"]
            IL_TN += r["IL_TN"]
            IL_FN += r["IL_FN"]
            TPs += r["TPs"]
            FPs += r["FPs"]
            FNs += r["FNs"]
            if r["positive_pair"]:
                prec = r["TPs"] / (r["TPs"] + r["FPs"] + 1e-4)
                rec = r["TPs"] / (r["TPs"] + r["FNs"] + 1e-4)
                local_f1 += 2 * prec * rec / (prec + rec + 1e-4)
                pmFPs += r["FPs"]
                if r["num_dt"] > 0:
                    valid_f1 += 1

        precision = TPs / (TPs + FPs + 1e-4)
        pm_precision = TPs / (TPs + pmFPs + 1e-4)
        recall = TPs / (TPs + FNs + 1e-4)
        f1 = 2 * precision * recall / (precision + recall + 1e-4)
        pm_f1 = 2 * pm_precision * recall / (pm_precision + recall + 1e-4)

        il_rec = IL_TP / (IL_TP + IL_FN + 1e-6)
        il_prec = IL_TP / (IL_TP + IL_FP + 1e-6)
        il_f1 = 2 * il_prec * il_rec / (il_prec + il_rec + 1e-6)
        il_fpr = IL_FP / (IL_FP + IL_TN + 1e-6)
        il_mcc = float(IL_TP * IL_TN - IL_FP * IL_FN) / (
            (
                float(IL_TP + IL_FP)
                * float(IL_TP + IL_FN)
                * float(IL_TN + IL_FP)
                * float(IL_TN + IL_FN)
            )
            ** 0.5
            + 1e-6
        )
        out = {
            "precision": precision.mean(),
            "recall": recall.mean(),
            "F1": f1.mean(),
            "positive_micro_F1": pm_f1.mean(),
            "positive_macro_F1": (local_f1 / max(valid_f1, 1)).mean(),
            "IL_precision": il_prec,
            "IL_recall": il_rec,
            "IL_F1": il_f1,
            "IL_FPR": il_fpr,
            "IL_MCC": il_mcc,
            "cgF1": pm_f1.mean() * il_mcc,
            "cgF1_50": pm_f1[0] * il_mcc,
            "cgF1_75": pm_f1[5] * il_mcc,
        }
        return out
