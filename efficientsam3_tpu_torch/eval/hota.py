"""Copy of efficientsam3_tpu/eval/hota.py.

HOTA: Higher-Order Tracking Accuracy.

Replaces the reference's vendored TrackEval HOTA toolkit
(sam3/sam3/eval/hota_eval_toolkit/trackeval/metrics/hota.py) with a compact
numpy implementation of the standard algorithm (Luiten et al., IJCV 2021):

  for localization thresholds alpha in {0.05, ..., 0.95}:
    1. count potential cross-frame matches per (gt track, pred track) pair,
    2. per frame, Hungarian-match detections maximizing the global
       association potential (TrackEval's two-pass scheme),
    3. DetA = TP / (TP + FN + FP);
       AssA = mean over TPs of TPA(c) / (TPA(c) + FNA(c) + FPA(c));
       HOTA(alpha) = sqrt(DetA * AssA)
  HOTA = mean over alphas.

Inputs are per-frame lists of (gt_ids, pred_ids, iou_matrix).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

ALPHAS = np.arange(0.05, 0.96, 0.05)


class HOTAEvaluator:
    def __init__(self, alphas=ALPHAS):
        self.alphas = np.asarray(alphas)
        self.frames = []  # (gt_ids, pred_ids, iou)

    def add_frame(self, gt_ids, pred_ids, iou):
        """gt_ids: (G,) ints; pred_ids: (P,) ints; iou: (G, P)."""
        self.frames.append(
            (np.asarray(gt_ids), np.asarray(pred_ids), np.asarray(iou, np.float64))
        )

    def _evaluate_alpha(self, alpha: float) -> dict:
        gt_tracks = sorted({int(g) for gt, _, _ in self.frames for g in gt})
        pr_tracks = sorted({int(p) for _, pr, _ in self.frames for p in pr})
        gi = {g: i for i, g in enumerate(gt_tracks)}
        pi = {p: i for i, p in enumerate(pr_tracks)}
        ng, np_ = len(gt_tracks), len(pr_tracks)
        # pass 1: potential matches per track pair
        potential = np.zeros((ng, np_), np.float64)
        gt_count = np.zeros(ng)
        pr_count = np.zeros(np_)
        for gt, pr, iou in self.frames:
            gt_count[[gi[int(g)] for g in gt]] += 1
            pr_count[[pi[int(p)] for p in pr]] += 1
            if len(gt) and len(pr):
                ok = iou >= alpha - 1e-9
                for a in range(len(gt)):
                    for b in range(len(pr)):
                        if ok[a, b]:
                            potential[gi[int(gt[a])], pi[int(pr[b])]] += 1
        # global association potential (TrackEval's ass score for matching)
        with np.errstate(divide="ignore", invalid="ignore"):
            glob = potential / np.maximum(
                gt_count[:, None] + pr_count[None, :] - potential, 1e-9
            )
        # pass 2: per-frame matching maximizing global + epsilon * iou
        tp_pairs = np.zeros((ng, np_), np.float64)
        tp = fp = fn = 0
        for gt, pr, iou in self.frames:
            if len(gt) and len(pr):
                score = np.zeros((len(gt), len(pr)))
                for a in range(len(gt)):
                    for b in range(len(pr)):
                        if iou[a, b] >= alpha - 1e-9:
                            score[a, b] = (
                                glob[gi[int(gt[a])], pi[int(pr[b])]] + iou[a, b] * 1e-3
                                + 1.0
                            )
                rows, cols = linear_sum_assignment(-score)
                matched_g = set()
                matched_p = set()
                for a, b in zip(rows, cols):
                    if score[a, b] > 0:
                        tp += 1
                        tp_pairs[gi[int(gt[a])], pi[int(pr[b])]] += 1
                        matched_g.add(a)
                        matched_p.add(b)
                fn += len(gt) - len(matched_g)
                fp += len(pr) - len(matched_p)
            else:
                fn += len(gt)
                fp += len(pr)
        det_a = tp / max(tp + fn + fp, 1e-9)
        # AssA: weighted by TP count of each pair
        if tp > 0:
            ass_scores = tp_pairs / np.maximum(
                gt_count[:, None] + pr_count[None, :] - tp_pairs, 1e-9
            )
            ass_a = float((tp_pairs * ass_scores).sum() / tp)
        else:
            ass_a = 0.0
        return {
            "DetA": det_a,
            "AssA": ass_a,
            "HOTA": float(np.sqrt(det_a * ass_a)),
            "TP": tp, "FP": fp, "FN": fn,
        }

    def summarize(self) -> dict:
        per_alpha = [self._evaluate_alpha(a) for a in self.alphas]
        return {
            "HOTA": float(np.mean([r["HOTA"] for r in per_alpha])),
            "DetA": float(np.mean([r["DetA"] for r in per_alpha])),
            "AssA": float(np.mean([r["AssA"] for r in per_alpha])),
            "HOTA(0)": per_alpha[0]["HOTA"],
            "per_alpha": per_alpha,
        }
