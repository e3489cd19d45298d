"""Copy of efficientsam3_tpu/eval/eval_coco.py.

COCO box-prompt mIoU harness (SAM1-task evaluation).

Mirrors the reference repo-root harness (eval/eval_coco.py:29
evaluate_model): for every COCO instance annotation, prompt the interactive
predictor with the GT box, take the best-IoU-scored mask, and average the
mask IoU against the GT segmentation.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from efficientsam3_tpu_torch.eval.coco_format import CocoDataset, ann_to_mask


def evaluate_box_prompt_miou(
    predictor,
    dataset: CocoDataset,
    load_image,  # callable(image_info) -> (H, W, 3) uint8
    max_images: Optional[int] = None,
    max_anns_per_image: Optional[int] = None,
) -> dict:
    ious = []
    n_img = 0
    for image_id, info in dataset.images.items():
        anns = [a for a in dataset.annotations(image_id) if not a.get("iscrowd", 0)]
        if not anns:
            continue
        img = load_image(info)
        h, w = img.shape[:2]
        predictor.set_image(img)
        for ann in anns[:max_anns_per_image]:
            x, y, bw, bh = ann["bbox"]
            gt = ann_to_mask(ann, h, w)
            masks, pred_iou, _ = predictor.predict(
                box=np.asarray([x, y, x + bw, y + bh]), multimask_output=True
            )
            best = masks[int(np.argmax(pred_iou))]
            inter = np.logical_and(best, gt).sum()
            union = np.logical_or(best, gt).sum()
            ious.append(inter / max(union, 1))
        n_img += 1
        if max_images is not None and n_img >= max_images:
            break
    return {
        "miou": float(np.mean(ious)) if ious else float("nan"),
        "num_instances": len(ious),
        "num_images": n_img,
    }
