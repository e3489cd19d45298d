"""Port of efficientsam3_tpu/eval/postprocess.py.

Postprocessors: model outputs -> evaluator formats.

Mirrors reference sam3/sam3/eval/postprocessors.py (PostProcessImage :30:
top-k by score x presence, box rescale, RLE-encoded masks; video variants
aggregate per-frame results into YTVIS-style records). The outputs may be
torch tensors, on the card or the CPU, or numpy arrays. Scores, ordering
and boxes are computed on the host as in the JAX package; the kept masks
are upsampled in one ``ops.interpolate.resize_bilinear`` call on the device
they are on and thresholded there (> 0 on the logits), then RLE-encoded on
the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from efficientsam3_tpu_torch.eval.coco_format import mask_to_rle, rle_encode_string
from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array (bf16 widened
    to fp32, which numpy lacks)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def postprocess_image(
    outputs: dict,
    image_id,
    category_id: int = 1,
    orig_hw: Optional[tuple] = None,
    top_k: int = 100,
    score_threshold: float = 0.0,
    encode_rle: bool = True,
) -> list:
    """One image's grounding outputs -> COCO-format detection records.

    outputs: dict with pred_logits (NQ, 1)/(1, NQ, 1), pred_boxes cxcywh in
    [0,1], optional pred_masks + presence_logit_dec.
    """
    logits = _host(outputs["pred_logits"])
    boxes = _host(outputs["pred_boxes"])
    if logits.ndim == 3:
        logits, boxes = logits[0], boxes[0]
    scores = _sigmoid(logits[..., 0])
    if outputs.get("presence_logit_dec") is not None:
        scores = scores * float(_sigmoid(_host(outputs["presence_logit_dec"]).reshape(-1)[0]))
    order = np.argsort(-scores)[:top_k]
    order = order[scores[order] > score_threshold]

    masks = outputs.get("pred_masks")
    if masks is not None and len(order):
        if not isinstance(masks, torch.Tensor):
            masks = torch.from_numpy(np.ascontiguousarray(masks))
        if masks.ndim == 4:
            masks = masks[0]
        masks = masks[torch.as_tensor(order, device=masks.device)]
        if orig_hw is not None and tuple(masks.shape[1:]) != tuple(orig_hw):
            masks = resize_bilinear(masks.float()[:, None], orig_hw)[:, 0]
        masks = (masks > 0).cpu().numpy()

    h, w = orig_hw if orig_hw is not None else (None, None)
    records = []
    for i, qi in enumerate(order):
        cx, cy, bw, bh = boxes[qi]
        rec = {
            "image_id": image_id,
            "category_id": category_id,
            "score": float(scores[qi]),
            "bbox": [
                float((cx - bw / 2) * (w or 1)),
                float((cy - bh / 2) * (h or 1)),
                float(bw * (w or 1)),
                float(bh * (h or 1)),
            ],
        }
        if masks is not None:
            m = masks[i]
            rle = mask_to_rle(m)
            if encode_rle:
                rle = {"size": rle["size"], "counts": rle_encode_string(rle["counts"])}
            rec["segmentation"] = rle
        records.append(rec)
    return records


def postprocess_video(per_frame_outputs: list, video_id, category_id: int = 1) -> list:
    """Per-frame tracker outputs -> YTVIS-style video records
    (reference PostProcessAPIVideo :323).

    per_frame_outputs: list of dicts {obj_ids, masks (N, H, W) logits/bool,
    scores optional} in frame order.
    """
    tracks: dict = {}
    for t, frame in enumerate(per_frame_outputs):
        for i, obj_id in enumerate(frame["obj_ids"]):
            tr = tracks.setdefault(
                obj_id,
                {"video_id": video_id, "category_id": category_id,
                 "segmentations": {}, "scores": []},
            )
            m = _host(frame["masks"][i])
            if m.dtype != bool:
                m = m > 0
            rle = mask_to_rle(m)
            tr["segmentations"][t] = {
                "size": rle["size"],
                "counts": rle_encode_string(rle["counts"]),
            }
            if "scores" in frame:
                tr["scores"].append(float(frame["scores"][i]))
    out = []
    num_frames = len(per_frame_outputs)
    for obj_id, tr in tracks.items():
        segs = [tr["segmentations"].get(t) for t in range(num_frames)]
        out.append(
            {
                "video_id": tr["video_id"],
                "category_id": tr["category_id"],
                "track_id": obj_id,
                "score": float(np.mean(tr["scores"])) if tr["scores"] else 1.0,
                "segmentations": segs,
            }
        )
    return out
