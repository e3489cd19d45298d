"""Copy of efficientsam3_tpu/eval/video_eval.py.

End-to-end video PCS evaluation: pipeline outputs -> tracking metrics.

The reference evaluates SA-Co/VEval runs with the saco_veval_evaluators
(VideoTetaEvaluator :328, VideoPhraseHotaEvaluator :493 over YTVIS-style
prediction files). Here the same loop is a thin host-side pass: per frame,
build the (gt x pred) mask-IoU matrix and feed the HOTA and TETA
accumulators; DAVIS J&F is reported for the best-matched track pairs.

Ground truth format (one video): a list of per-frame dicts
  {"obj_ids": [int, ...], "masks": (N, H, W) bool}
exactly mirroring the pipeline's per-frame output records, so the script
(scripts/eval_video.py) can feed either decoded GT annotations or another
run's outputs (for A/B heuristic comparisons, e.g. the *_noheur configs in
eval/gold.SACO_VEVAL_SUBSETS).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from efficientsam3_tpu_torch.eval.coco_format import mask_iou_np
from efficientsam3_tpu_torch.eval.hota import HOTAEvaluator
from efficientsam3_tpu_torch.eval.jf_metric import f_measure, j_measure
from efficientsam3_tpu_torch.eval.teta import TETAEvaluator


def _frame_masks(frame) -> tuple:
    ids = list(frame["obj_ids"])
    masks = np.asarray(frame["masks"])
    if masks.dtype != bool:
        masks = masks > 0
    return ids, masks


def evaluate_video_predictions(
    pred_frames: List[dict],
    gt_frames: List[dict],
    hota: Optional[HOTAEvaluator] = None,
    teta: Optional[TETAEvaluator] = None,
) -> dict:
    """One video's pipeline outputs vs ground truth.

    pred_frames / gt_frames: per-frame {obj_ids, masks}. Pass shared
    hota/teta accumulators to aggregate across videos (summarize once at
    the end); with none given, per-video metrics are returned directly.
    """
    own = hota is None
    hota = hota or HOTAEvaluator()
    teta = teta or TETAEvaluator()
    assert len(pred_frames) == len(gt_frames)

    jf_sums: dict = {}
    for pred, gt in zip(pred_frames, gt_frames):
        p_ids, p_masks = _frame_masks(pred)
        g_ids, g_masks = _frame_masks(gt)
        if len(g_ids) and len(p_ids):
            iou = mask_iou_np(g_masks, p_masks)
        else:
            iou = np.zeros((len(g_ids), len(p_ids)))
        hota.add_frame(g_ids, p_ids, iou)
        teta.add_frame(g_ids, p_ids, iou)
        # greedy per-frame J&F on the best IoU pairing (DAVIS-style)
        if len(g_ids) and len(p_ids):
            for gi_, g_id in enumerate(g_ids):
                pi_ = int(np.argmax(iou[gi_]))
                j = j_measure(p_masks[pi_], g_masks[gi_])
                f = f_measure(p_masks[pi_], g_masks[gi_])
                s = jf_sums.setdefault(g_id, [0.0, 0.0, 0])
                s[0] += j
                s[1] += f
                s[2] += 1

    out = {}
    if jf_sums:
        js = [s[0] / s[2] for s in jf_sums.values()]
        fs = [s[1] / s[2] for s in jf_sums.values()]
        out["J"] = float(np.mean(js))
        out["F"] = float(np.mean(fs))
        out["J&F"] = float((out["J"] + out["F"]) / 2)
    if own:
        out.update(hota.summarize())
        out.update(teta.summarize())
    return out
