"""Copy of efficientsam3_tpu/eval/gold.py.

SA-Co/Gold-style cgF1 evaluation harness.

Mirrors the reference gold pipeline:
  - sam3/sam3/eval/cgf1_eval.py:558 CGF1Evaluator: file-level evaluation
    where each IMAGE entry is one (image, query) pair (useCats=False), only
    `is_instance_exhaustive` pairs are scored, and with several ground-truth
    annotator files the best-scoring annotation per pair is selected
    (3-annotator oracle).
  - sam3/scripts/eval/gold/eval_efficientsam3_all_subsets.py:33-74: the
    7-subset script producing the per-subset cgF1 table + average.
  - sam3/scripts/eval/standalone_cgf1.py: the standalone metric CLI
    (scripts/standalone_cgf1.py wraps evaluate_cgf1_files).

Distribution: (image, query) pairs are sharded across processes with
eval/distributed.shard_for_process; predictions rendezvous through the
filesystem (all_gather_via_filesys), replacing the reference's torchrun +
NCCL gather.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from efficientsam3_tpu_torch.eval.cgf1 import IOU_THRS, CGF1Evaluator
from efficientsam3_tpu_torch.eval.coco_format import ann_to_mask, box_iou_np, mask_iou_np

# reference subset table (eval_efficientsam3_all_subsets.py:33-70): subset ->
# the three annotator files
SACO_GOLD_GTS = {
    "metaclip_nps": [
        "gold_metaclip_merged_a_release_test.json",
        "gold_metaclip_merged_b_release_test.json",
        "gold_metaclip_merged_c_release_test.json",
    ],
    "sa1b_nps": [
        "gold_sa1b_merged_a_release_test.json",
        "gold_sa1b_merged_b_release_test.json",
        "gold_sa1b_merged_c_release_test.json",
    ],
    "crowded": [
        "gold_crowded_merged_a_release_test.json",
        "gold_crowded_merged_b_release_test.json",
        "gold_crowded_merged_c_release_test.json",
    ],
    "fg_food": [
        "gold_fg_food_merged_a_release_test.json",
        "gold_fg_food_merged_b_release_test.json",
        "gold_fg_food_merged_c_release_test.json",
    ],
    "fg_sports_equipment": [
        "gold_fg_sports_equipment_merged_a_release_test.json",
        "gold_fg_sports_equipment_merged_b_release_test.json",
        "gold_fg_sports_equipment_merged_c_release_test.json",
    ],
    "attributes": [
        "gold_attributes_merged_a_release_test.json",
        "gold_attributes_merged_b_release_test.json",
        "gold_attributes_merged_c_release_test.json",
    ],
    "wiki_common": [
        "gold_wiki_common_merged_a_release_test.json",
        "gold_wiki_common_merged_b_release_test.json",
        "gold_wiki_common_merged_c_release_test.json",
    ],
}

# silver image-eval subsets (single-annotator cgF1 per domain dataset;
# reference train/configs/silver_image_evals/*.yaml, 10 domains)
SACO_SILVER_SUBSETS = (
    "bdd100k", "droid", "ego4d", "fathomnet", "food_rec",
    "geode", "inaturalist", "nga", "sav", "yt1b",
)

# SA-Co/VEval video subsets: dataset x split x (with/without the tracking
# heuristics — hotstart, occlusion suppression, reconditioning; reference
# train/configs/saco_video_evals/*.yaml, 12 configs). The video pipeline's
# heuristics map to VideoPCSConfig fields; "noheur" runs with
# hotstart_delay=0 and suppression off.
SACO_VEVAL_SUBSETS = tuple(
    f"{ds}_{split}{suffix}"
    for ds in ("sav", "smartglasses", "yt1b")
    for split in ("val", "test")
    for suffix in ("", "_noheur")
)

PHRASE_KEYS = ("query", "text", "noun_phrase", "phrase", "caption")


def _load(path_or_obj):
    if isinstance(path_or_obj, (str, os.PathLike)):
        with open(path_or_obj) as f:
            return json.load(f)
    return path_or_obj


def _pred_geom(rec, h, w, iou_type):
    if iou_type == "segm":
        from efficientsam3_tpu_torch.eval.coco_format import rle_to_mask

        seg = rec["segmentation"]
        if isinstance(seg, dict):
            return rle_to_mask(seg)
        return ann_to_mask({"segmentation": seg}, h, w)
    return np.asarray(rec["bbox"], np.float64)


def _gt_geom(ann, h, w, iou_type):
    if iou_type == "segm":
        return ann_to_mask(ann, h, w)
    return np.asarray(ann["bbox"], np.float64)


def _pair_counts(iou, num_dt, num_gt, iou_thrs):
    """Hungarian TP counts per threshold (cgf1.py add semantics)."""
    from scipy.optimize import linear_sum_assignment

    tps = np.zeros(len(iou_thrs), np.int64)
    if num_dt and num_gt:
        rows, cols = linear_sum_assignment(-iou)
        matched = iou[rows, cols]
        for i, thr in enumerate(iou_thrs):
            tps[i] = int((matched >= thr).sum())
    return tps


def evaluate_cgf1_files(
    predictions: Union[str, List[dict]],
    gt_paths: Sequence[Union[str, dict]],
    iou_type: str = "segm",
) -> dict:
    """File-level cgF1 with the multi-annotator oracle.

    predictions: COCO-format records (or a path to them).
    gt_paths: one or more COCO-format ground-truth files; with several, the
    best-scoring annotation per (image, query) pair is used
    (cgf1_eval.py:640 _select_best_scoring).
    """
    preds = _load(predictions)
    gts = [_load(p) for p in gt_paths]

    img2preds = defaultdict(list)
    for p in preds:
        img2preds[p["image_id"]].append(p)

    # per annotator: image -> annotations; image info from the first file
    per_gt_anns = []
    for g in gts:
        by_img = defaultdict(list)
        for a in g.get("annotations", []):
            by_img[a["image_id"]].append(a)
        per_gt_anns.append(by_img)
    images0 = {im["id"]: im for im in gts[0]["images"]}

    # only pairs exhaustively annotated in every file are scored
    # (cgf1_eval.py:593-608)
    excluded = set()
    for g in gts[1:]:
        excluded |= {
            im["id"]
            for im in g.get("images", [])
            if not im.get("is_instance_exhaustive", True)
        }
    eval_ids = [
        i
        for i, im in images0.items()
        if im.get("is_instance_exhaustive", True) and i not in excluded
    ]

    ev = CGF1Evaluator()
    for img_id in eval_ids:
        info = images0[img_id]
        h, w = info.get("height", 0), info.get("width", 0)
        recs = sorted(img2preds.get(img_id, []), key=lambda r: -r["score"])
        dt = [_pred_geom(r, h, w, iou_type) for r in recs]
        candidates = []
        for by_img in per_gt_anns:
            anns = by_img.get(img_id, [])
            gt = [_gt_geom(a, h, w, iou_type) for a in anns]
            if dt and gt:
                if iou_type == "segm":
                    iou = mask_iou_np(np.stack(dt), np.stack(gt))
                else:
                    dtb = np.stack(dt).copy()
                    gtb = np.stack(gt).copy()
                    dtb[:, 2:] += dtb[:, :2]
                    gtb[:, 2:] += gtb[:, :2]
                    iou = box_iou_np(dtb, gtb)
            else:
                iou = np.zeros((len(dt), len(gt)))
            candidates.append((iou, len(dt), len(gt)))
        # oracle: best mean-F1 annotator for this pair
        best = None
        for cand in candidates:
            tps = _pair_counts(*cand, ev.iou_thrs)
            fps, fns = cand[1] - tps, cand[2] - tps
            prec = tps / np.maximum(tps + fps, 1e-4)
            rec = tps / np.maximum(tps + fns, 1e-4)
            f1 = (2 * prec * rec / np.maximum(prec + rec, 1e-4)).mean()
            # empty-gt pairs: prefer the annotator that also says empty
            if cand[2] == 0 and cand[1] == 0:
                f1 = 2.0
            if best is None or f1 > best[0]:
                best = (f1, cand)
        ev.add(*best[1])
    return ev.summarize()


def run_gold_inference(
    predict_fn: Callable,
    gt_path: Union[str, dict],
    load_image: Callable[[dict], np.ndarray],
    max_pairs: Optional[int] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[dict]:
    """Run (image, query) inference over one gold file, sharded by process.

    predict_fn(image (H,W,3) uint8, phrase str, image_id) -> list of
    COCO-format records. Returns this shard's records.
    """
    from efficientsam3_tpu_torch.eval.distributed import shard_for_process

    g = _load(gt_path)
    images = g["images"][:max_pairs]
    shard = shard_for_process(images, process_index, process_count)
    records = []
    for info in shard:
        phrase = next(
            (info[k] for k in PHRASE_KEYS if k in info), None
        )
        img = load_image(info)
        records.extend(predict_fn(img, phrase, info["id"]))
    return records


def evaluate_gold_subsets(
    predict_fn: Callable,
    gt_folder: str,
    load_image: Callable[[dict], np.ndarray],
    subsets: Optional[Dict[str, List[str]]] = None,
    iou_type: str = "segm",
    max_pairs: Optional[int] = None,
    rendezvous_dir: Optional[str] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> dict:
    """Per-subset cgF1 table + average (the reference's headline PCS eval).

    With rendezvous_dir + process_count set, inference shards across
    processes and predictions gather through the filesystem.
    """
    subsets = subsets or SACO_GOLD_GTS
    table = {}
    for name, files in subsets.items():
        paths = [os.path.join(gt_folder, f) for f in files]
        if not os.path.exists(paths[0]):
            continue
        records = run_gold_inference(
            predict_fn, paths[0], load_image, max_pairs,
            process_index, process_count,
        )
        if rendezvous_dir is not None and (process_count or 1) > 1:
            from efficientsam3_tpu_torch.eval.distributed import all_gather_via_filesys

            shards = all_gather_via_filesys(
                records, rendezvous_dir, tag=f"gold_{name}",
                process_index=process_index, process_count=process_count,
            )
            records = [r for s in shards for r in s]
        existing = [p for p in paths if os.path.exists(p)]
        table[name] = evaluate_cgf1_files(records, existing, iou_type)
    if table:
        keys = ("cgF1", "IL_MCC", "positive_micro_F1")
        table["average"] = {
            k: float(np.mean([v[k] for s, v in table.items() if s != "average"]))
            for k in keys
        }
    return table


def evaluate_silver_subsets(
    predict_fn: Callable,
    gt_folder: str,
    load_image: Callable[[dict], np.ndarray],
    subsets: Sequence[str] = SACO_SILVER_SUBSETS,
    iou_type: str = "segm",
    max_pairs: Optional[int] = None,
    rendezvous_dir: Optional[str] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> dict:
    """Per-domain silver cgF1 table (reference silver_image_evals configs:
    one annotation file per domain, `sam3_silver_image_<domain>.json`),
    same inference/gather machinery as the gold harness."""
    table = {}
    for name in subsets:
        path = os.path.join(gt_folder, f"sam3_silver_image_{name}.json")
        if not os.path.exists(path):
            continue
        records = run_gold_inference(
            predict_fn, path, load_image, max_pairs,
            process_index, process_count,
        )
        if rendezvous_dir is not None and (process_count or 1) > 1:
            from efficientsam3_tpu_torch.eval.distributed import all_gather_via_filesys

            shards = all_gather_via_filesys(
                records, rendezvous_dir, tag=f"silver_{name}",
                process_index=process_index, process_count=process_count,
            )
            records = [r for s in shards for r in s]
        table[name] = evaluate_cgf1_files(records, [path], iou_type)
    if table:
        keys = ("cgF1", "IL_MCC", "positive_micro_F1")
        table["average"] = {
            k: float(np.mean([v[k] for s, v in table.items() if s != "average"]))
            for k in keys
        }
    return table
