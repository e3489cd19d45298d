"""Copy of efficientsam3_tpu/eval/coco_map.py.

COCO-style detection mAP/AR evaluator (no pycocotools).

Reimplements the COCOeval core the reference wraps (sam3/sam3/eval/
coco_eval.py:42) with full pycocotools semantics:
  - IoU thresholds 0.5:0.95:0.05, 101-point interpolated AP
  - area ranges (all/small/medium/large) with per-range ignore handling
  - maxDets tiers (1/10/100) with AR@k
  - iscrowd ground truth: crowd IoU = inter / area(dt); crowd matches are
    ignored (never TP/FP), multiple detections may match one crowd gt
  - detections matched to ignored gt, or unmatched and outside the area
    range, are ignored in precision/recall

The per-detection matching is vectorized over ground truths: the reference
python loop's semantics ("best non-ignored candidate above threshold,
falling back to best ignored candidate") become two masked argmaxes.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0, 1, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _box_area(b):
    return b[:, 2] * b[:, 3]


def _iou_with_crowd(dt, gt, crowd, iou_type):
    """IoU matrix (D, G); crowd columns use union = area(dt)
    (pycocotools maskUtils.iou semantics)."""
    if iou_type == "bbox":
        dt = np.asarray(dt, np.float64)
        gt = np.asarray(gt, np.float64)
        x11, y11 = dt[:, 0:1], dt[:, 1:2]
        x12, y12 = x11 + dt[:, 2:3], y11 + dt[:, 3:4]
        x21, y21 = gt[None, :, 0], gt[None, :, 1]
        x22, y22 = x21 + gt[None, :, 2], y21 + gt[None, :, 3]
        iw = np.clip(np.minimum(x12, x22) - np.maximum(x11, x21), 0, None)
        ih = np.clip(np.minimum(y12, y22) - np.maximum(y11, y21), 0, None)
        inter = iw * ih
        a_dt = (_box_area(dt))[:, None]
        a_gt = (_box_area(gt))[None, :]
    else:
        dt = np.asarray(dt, bool).reshape(len(dt), -1)
        gt = np.asarray(gt, bool).reshape(len(gt), -1)
        inter = (dt[:, None, :] & gt[None, :, :]).sum(-1).astype(np.float64)
        a_dt = dt.sum(-1).astype(np.float64)[:, None]
        a_gt = gt.sum(-1).astype(np.float64)[None, :]
    union = np.where(crowd[None, :], a_dt, a_dt + a_gt - inter)
    return inter / np.maximum(union, 1e-9)


class CocoMAPEvaluator:
    """add_image(...) per (image, category); summarize() -> metric dict."""

    def __init__(self, iou_type: str = "bbox", max_dets=(1, 10, 100)):
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type
        self.max_dets = tuple(sorted(max_dets))
        self._recs = defaultdict(list)  # category -> per-image records

    def add_image(
        self,
        category_id,
        dt_scores,
        dt_geoms,
        gt_geoms,
        gt_iscrowd=None,
        gt_areas=None,
        dt_areas=None,
    ):
        """dt_geoms/gt_geoms: (N, 4) xywh boxes or (N, H, W) masks.
        gt_areas/dt_areas: optional annotation areas (defaults derived from
        the geometry, as pycocotools does when 'area' is absent)."""
        dt_scores = np.asarray(dt_scores, np.float64)
        order = np.argsort(-dt_scores, kind="mergesort")[: max(self.max_dets)]
        dt_scores = dt_scores[order]
        n_dt, n_gt = len(dt_scores), len(gt_geoms)
        gt_iscrowd = (
            np.zeros(n_gt, bool)
            if gt_iscrowd is None
            else np.asarray(gt_iscrowd, bool)
        )
        gt_geoms = np.asarray(gt_geoms)
        dt_geoms = np.asarray(dt_geoms)[order] if n_dt else np.asarray(dt_geoms)

        def area_of(geoms, n):
            if n == 0:
                return np.zeros(0)
            if self.iou_type == "bbox":
                return _box_area(np.asarray(geoms, np.float64))
            return np.asarray(geoms, bool).reshape(n, -1).sum(-1).astype(np.float64)

        gt_areas = area_of(gt_geoms, n_gt) if gt_areas is None else np.asarray(
            gt_areas, np.float64
        )
        dt_areas = area_of(dt_geoms, n_dt) if dt_areas is None else np.asarray(
            dt_areas, np.float64
        )[order]

        iou = (
            _iou_with_crowd(dt_geoms, gt_geoms, gt_iscrowd, self.iou_type)
            if n_dt and n_gt
            else np.zeros((n_dt, n_gt))
        )
        self._recs[category_id].append(
            dict(
                scores=dt_scores,
                iou=iou,
                gt_crowd=gt_iscrowd,
                gt_areas=gt_areas,
                dt_areas=dt_areas,
            )
        )

    # -- matching (pycocotools evaluateImg, vectorized over gts) -----------

    @staticmethod
    def _evaluate_img(rec, arng):
        lo, hi = arng
        gt_ig = rec["gt_crowd"] | (rec["gt_areas"] < lo) | (rec["gt_areas"] > hi)
        # gt sorted: non-ignored first (stable), as pycocotools does
        g_order = np.argsort(gt_ig, kind="mergesort")
        gt_ig = gt_ig[g_order]
        crowd = rec["gt_crowd"][g_order]
        iou = rec["iou"][:, g_order] if rec["iou"].size else rec["iou"]
        n_dt, n_gt = iou.shape if iou.size else (len(rec["scores"]), 0)
        n_dt = len(rec["scores"])
        t_n = len(IOU_THRS)
        dtm = np.full((t_n, n_dt), -1, np.int64)
        dt_ig = np.zeros((t_n, n_dt), bool)
        if n_gt:
            for ti, thr in enumerate(IOU_THRS):
                gt_taken = np.zeros(n_gt, bool)
                for di in range(n_dt):
                    t_ = min(thr, 1 - 1e-10)
                    avail = (~gt_taken | crowd) & (iou[di] >= t_)
                    pool = avail & ~gt_ig
                    if not pool.any():
                        pool = avail & gt_ig
                    if not pool.any():
                        continue
                    m = int(np.argmax(np.where(pool, iou[di], -1.0)))
                    dtm[ti, di] = m
                    gt_taken[m] = True
                    dt_ig[ti, di] = gt_ig[m]
        # unmatched detections outside the area range are ignored
        out = (rec["dt_areas"] < lo) | (rec["dt_areas"] > hi)
        dt_ig |= (dtm < 0) & out[None, :]
        npig = int((~gt_ig).sum())
        return dtm, dt_ig, npig

    # -- accumulate + summarize (pycocotools accumulate/summarize) ---------

    def _accumulate(self, area, max_det):
        """Returns (precision (T, R, C), recall (T, C))."""
        arng = AREA_RANGES[area]
        cats = sorted(self._recs)
        t_n, r_n = len(IOU_THRS), len(RECALL_THRS)
        precision = -np.ones((t_n, r_n, len(cats)))
        recall = -np.ones((t_n, len(cats)))
        for ci, cat in enumerate(cats):
            scores_all, tps_all, igs_all = [], [], []
            npig = 0
            for rec in self._recs[cat]:
                dtm, dt_ig, n = self._evaluate_img(rec, arng)
                scores_all.append(rec["scores"][:max_det])
                tps_all.append(dtm[:, :max_det] >= 0)
                igs_all.append(dt_ig[:, :max_det])
                npig += n
            if npig == 0:
                continue
            scores = np.concatenate(scores_all)
            tps = np.concatenate(tps_all, axis=1)
            igs = np.concatenate(igs_all, axis=1)
            order = np.argsort(-scores, kind="mergesort")
            tps, igs = tps[:, order], igs[:, order]
            tp = tps & ~igs
            fp = ~tps & ~igs
            cum_tp = np.cumsum(tp, axis=1).astype(np.float64)
            cum_fp = np.cumsum(fp, axis=1).astype(np.float64)
            rc = cum_tp / npig
            pr = cum_tp / np.maximum(cum_tp + cum_fp, np.spacing(1))
            for ti in range(t_n):
                p = pr[ti].copy()
                for i in range(len(p) - 1, 0, -1):
                    p[i - 1] = max(p[i - 1], p[i])
                inds = np.searchsorted(rc[ti], RECALL_THRS, side="left")
                q = np.zeros(r_n)
                valid = inds < len(p)
                q[valid] = p[inds[valid]]
                precision[ti, :, ci] = q
                recall[ti, ci] = rc[ti, -1] if len(rc[ti]) else 0.0
        return precision, recall

    @staticmethod
    def _mean(x):
        x = x[x > -1]
        return float(x.mean()) if x.size else float("nan")

    def summarize(self) -> dict:
        md = max(self.max_dets)
        p_all = {a: self._accumulate(a, md)[0] for a in AREA_RANGES}
        out = {
            "AP": self._mean(p_all["all"]),
            "AP50": self._mean(p_all["all"][0]),
            "AP75": self._mean(p_all["all"][5]),
            "AP_small": self._mean(p_all["small"]),
            "AP_medium": self._mean(p_all["medium"]),
            "AP_large": self._mean(p_all["large"]),
        }
        for k in self.max_dets:
            _, recall = self._accumulate("all", k)
            out[f"AR@{k}"] = self._mean(recall)
        for a in ("small", "medium", "large"):
            _, recall = self._accumulate(a, md)
            out[f"AR_{a}"] = self._mean(recall)
        return out
