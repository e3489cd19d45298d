"""Data engine: VLM pseudo-labels for SA-1B-style mask datasets.

Capability match for the reference Stage-3 data engine
(stage3/data_engine/generate.py, annotations.py, build_manifest.py,
audit.py): each class-agnostic GT mask is cropped, sent to a
vision-language model that returns a JSON noun-phrase label with a
confidence, labels are normalized/filtered (generic or ambiguous labels
rejected), duplicate labels within an image are disambiguated with spatial
prefixes, and the accepted records are grouped into text→instances
find-queries.

Different output design from the reference: instead of a bespoke manifest
row format, `records_to_coco` emits a standard COCO-format dict whose
categories are the normalized phrases — this feeds
`efficientsam3_tpu_torch.data.stage3_mixed.Stage3MixedDataset` (our Stage-3
trainer input) with no adapter. `build_grouped_queries` additionally gives
the per-image query view (merge / distinct strategies) for auditing.

The VLM client is injected as a callable `(crop: np.ndarray | None,
system: str, user: str) -> str` so the engine is testable offline;
`stub_vlm` is the deterministic no-model backend (reference
generate.py --inference-backend=stub), and `chat_vlm_client` adapts any
OpenAI-style chat client.

A copy of efficientsam3_tpu/data/engine.py for the port (numpy only).
"""

from __future__ import annotations

import json
import re
from typing import Callable, Iterable, Optional

import numpy as np

MAX_LABEL_WORDS = 10
GENERIC_LABELS = frozenset(
    {
        "", "unknown", "unclear", "not sure", "object", "objects", "item",
        "items", "thing", "things", "stuff", "entity", "entities", "part",
        "parts", "region", "regions", "area", "areas", "background",
        "foreground",
    }
)
_ARTICLES = ("a", "an", "the")
_NON_ALNUM = re.compile(r"[^a-z0-9\s/-]+")
_JSON_BLOB = re.compile(r"\{.*\}", re.DOTALL)

SYSTEM_PROMPT = (
    "You label one segmentation mask at a time. Reply with JSON only: "
    '{"label": <noun phrase, max 10 words>, "confidence": <0..1>, '
    '"ambiguous": <bool>, "reject_reason": <string>}. Name the main visible '
    "object or object part as specifically as possible; avoid vague words "
    "(object, thing, stuff, region). If the crop is unreadable set "
    "ambiguous=true with a short reject_reason."
)
USER_PROMPT = (
    "What is the main object or object part visible in this crop? "
    "JSON only, label of at most 10 words."
)


# ---------------------------------------------------------------- text utils


def normalize_label(text: Optional[str], max_words: int = MAX_LABEL_WORDS) -> str:
    """Lowercase, strip punctuation/articles, cap word count."""
    if not text:
        return ""
    s = _NON_ALNUM.sub(" ", text.lower().replace("_", " "))
    words = s.split()
    while words and words[0] in _ARTICLES:
        words = words[1:]
    return " ".join(words[:max_words])


def is_generic_label(text: str) -> bool:
    return normalize_label(text) in GENERIC_LABELS


def extract_json(text: str) -> dict:
    """Parse a JSON object out of a (possibly fenced / chatty) VLM reply."""
    s = text.strip()
    if s.startswith("```"):
        s = s.strip("`")
        if "\n" in s:
            s = s.split("\n", 1)[1]
    m = _JSON_BLOB.search(s)
    return json.loads(m.group(0) if m else s)


def parse_vlm_response(raw: str) -> tuple[str, float, bool, str]:
    """-> (normalized label, confidence in [0,1], ambiguous, reject_reason)."""
    try:
        obj = extract_json(raw)
    except (json.JSONDecodeError, ValueError):
        return "", 0.0, True, "unparseable response"
    label = normalize_label(obj.get("label"))
    try:
        conf = float(obj.get("confidence", 0.0))
    except (TypeError, ValueError):
        conf = 0.0
    return (
        label,
        min(max(conf, 0.0), 1.0),
        bool(obj.get("ambiguous", False)),
        str(obj.get("reject_reason", "") or "").strip(),
    )


def spatial_prefix(bbox_xywh, width: int, height: int) -> str:
    """'upper left' / 'lower right' etc. from the box center."""
    x, y, w, h = [float(v) for v in bbox_xywh]
    return ("upper" if y + h / 2 < height / 2 else "lower") + " " + (
        "left" if x + w / 2 < width / 2 else "right"
    )


def disambiguate_label(label, bbox_xywh, width, height, used: set) -> str:
    """Make `label` unique within an image: spatial prefix, then a counter."""
    base = normalize_label(label)
    if base not in used:
        return base
    pref = normalize_label(f"{spatial_prefix(bbox_xywh, width, height)} {base}")
    if pref not in used:
        return pref
    n = 2
    while normalize_label(f"{pref} {n}") in used:
        n += 1
    return normalize_label(f"{pref} {n}")


# --------------------------------------------------------------- VLM clients


def stub_vlm(crop, system: str, user: str) -> str:
    """Deterministic no-model backend: label derived from the crop's mean
    intensity / shape so pipelines and tests run without a VLM."""
    if crop is None:
        return json.dumps({"label": "object", "confidence": 0.0, "ambiguous": True,
                           "reject_reason": "no image"})
    h, w = crop.shape[:2]
    mean = float(np.asarray(crop, np.float32).mean())
    shade = "dark" if mean < 96 else ("gray" if mean < 176 else "bright")
    shape = "wide" if w > 1.3 * h else ("tall" if h > 1.3 * w else "square")
    return json.dumps(
        {"label": f"{shade} {shape} patch", "confidence": 0.5, "ambiguous": False,
         "reject_reason": ""}
    )


def chat_vlm_client(chat_fn: Callable) -> Callable:
    """Adapt an OpenAI-style `chat(messages) -> str` (e.g.
    the JAX package's agent.openai_chat_client) into an engine VLM client.
    Crops are sent as base64 PNG data URIs (OpenAI vision format)."""

    def client(crop, system: str, user: str) -> str:
        content = [{"type": "text", "text": user}]
        if crop is not None:
            import base64
            import io

            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(np.asarray(crop, np.uint8)).save(buf, format="PNG")
            uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
            content.append({"type": "image_url", "image_url": {"url": uri}})
        return chat_fn(
            [{"role": "system", "content": system},
             {"role": "user", "content": content}]
        )

    return client


# ------------------------------------------------------------------ pipeline


def crop_around_box(image: np.ndarray, bbox_xywh, pad_frac=0.15, min_pad=16):
    """Padded crop of the mask's bbox (context for the VLM)."""
    H, W = image.shape[:2]
    x, y, w, h = [float(v) for v in bbox_xywh]
    px = max(min_pad, int(round(w * pad_frac)))
    py = max(min_pad, int(round(h * pad_frac)))
    x0 = max(0, int(round(x - px)))
    y0 = max(0, int(round(y - py)))
    x1 = min(W, int(round(x + w + px)))
    y1 = min(H, int(round(y + h + py)))
    if x1 <= x0 or y1 <= y0:
        return None
    return image[y0:y1, x0:x1]


def label_masks(
    samples: Iterable[dict],
    vlm: Callable = stub_vlm,
    min_confidence: float = 0.0,
    min_area_frac: float = 0.0,
) -> list:
    """Run the VLM over every mask of every sample.

    sample: {"image_id", "width", "height", "image": HxWx3 array or None,
             "masks": [{"mask_id", "bbox_xywh", "area", "segmentation"}]}
    Returns flat records with label/confidence/rejected fields (the raw
    jsonl rows of the reference engine).
    """
    records = []
    for sample in samples:
        W, H = int(sample["width"]), int(sample["height"])
        image = sample.get("image")
        for idx, mask in enumerate(sample["masks"]):
            bbox = [float(v) for v in mask["bbox_xywh"]]
            area = float(mask.get("area", bbox[2] * bbox[3]))
            rec = {
                "image_id": sample["image_id"],
                "mask_id": str(mask.get("mask_id", f"{sample['image_id']}_{idx}")),
                "mask_index": idx,
                "width": W,
                "height": H,
                "bbox_xywh": bbox,
                "area": area,
                "area_frac": area / max(W * H, 1),
                "segmentation": mask.get("segmentation"),
                "label": "",
                "confidence": 0.0,
                "ambiguous": False,
                "rejected": False,
                "reject_reason": "",
                "raw_response": "",
            }
            if rec["area_frac"] < min_area_frac:
                rec.update(rejected=True, reject_reason="mask too small")
                records.append(rec)
                continue
            crop = crop_around_box(image, bbox) if image is not None else None
            raw = vlm(crop, SYSTEM_PROMPT, USER_PROMPT)
            label, conf, ambiguous, reason = parse_vlm_response(raw)
            rec.update(label=label, confidence=conf, ambiguous=ambiguous,
                       raw_response=raw)
            if ambiguous:
                rec.update(rejected=True, reject_reason=reason or "ambiguous")
            elif not label or is_generic_label(label):
                rec.update(rejected=True, reject_reason="generic label")
            elif conf < min_confidence:
                rec.update(rejected=True, reject_reason="low confidence")
            records.append(rec)
    return records


def accepted(records, min_confidence: float = 0.0):
    return [
        r for r in records
        if not r["rejected"] and r["label"] and r["confidence"] >= min_confidence
    ]


def records_to_coco(records, min_confidence: float = 0.0) -> dict:
    """Accepted records -> COCO-format dict (categories = unique normalized
    labels) directly loadable by eval.coco_format.CocoDataset and hence by
    Stage3MixedDataset as a pseudo-label training source."""
    keep = accepted(records, min_confidence)
    labels = sorted({r["label"] for r in keep})
    cat_id = {lab: i + 1 for i, lab in enumerate(labels)}
    images, seen = [], set()
    for r in keep:
        if r["image_id"] not in seen:
            seen.add(r["image_id"])
            images.append(
                {"id": r["image_id"], "width": r["width"], "height": r["height"],
                 "file_name": str(r["image_id"])}
            )
    annotations = [
        {
            "id": i + 1,
            "image_id": r["image_id"],
            "category_id": cat_id[r["label"]],
            "bbox": r["bbox_xywh"],
            "area": r["area"],
            "segmentation": r["segmentation"],
            "iscrowd": 0,
            "score": r["confidence"],
        }
        for i, r in enumerate(keep)
    ]
    return {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": cat_id[lab], "name": lab} for lab in labels],
    }


def build_grouped_queries(
    records, min_confidence: float = 0.0, strategy: str = "merge"
) -> dict:
    """Per-image text->instances queries.

    merge: one query per unique label, all matching masks as outputs
    (exhaustive-per-phrase find-query).  distinct: one query per mask,
    duplicate labels disambiguated with spatial prefixes / counters."""
    if strategy not in ("merge", "distinct"):
        raise ValueError(f"unknown strategy {strategy!r}")
    by_image = {}
    for r in accepted(records, min_confidence):
        by_image.setdefault(r["image_id"], []).append(r)
    rows = {}
    for image_id, recs in by_image.items():
        W, H = recs[0]["width"], recs[0]["height"]
        queries = []
        if strategy == "merge":
            groups = {}
            for r in recs:
                groups.setdefault(r["label"], []).append(r)
            for label in sorted(groups):
                members = groups[label]
                queries.append(
                    {
                        "query_text": label,
                        "mask_ids": [m["mask_id"] for m in members],
                        "boxes_xywh": [m["bbox_xywh"] for m in members],
                        "confidence": min(m["confidence"] for m in members),
                        "is_exhaustive": False,
                    }
                )
        else:
            used = set()
            for r in sorted(recs, key=lambda r: r["mask_index"]):
                text = disambiguate_label(r["label"], r["bbox_xywh"], W, H, used)
                used.add(text)
                queries.append(
                    {
                        "query_text": text,
                        "mask_ids": [r["mask_id"]],
                        "boxes_xywh": [r["bbox_xywh"]],
                        "confidence": r["confidence"],
                        "is_exhaustive": False,
                    }
                )
        rows[image_id] = {"width": W, "height": H, "queries": queries}
    return rows


def audit(records) -> dict:
    """Acceptance / rejection statistics (reference audit.py counters)."""
    keep = accepted(records)
    reject_reasons = {}
    for r in records:
        if r["rejected"]:
            reject_reasons[r["reject_reason"]] = (
                reject_reasons.get(r["reject_reason"], 0) + 1
            )
    hist = {}
    for r in keep:
        hist[r["label"]] = hist.get(r["label"], 0) + 1
    confs = [r["confidence"] for r in keep]
    return {
        "num_records": len(records),
        "num_accepted": len(keep),
        "acceptance_rate": len(keep) / max(len(records), 1),
        "num_images": len({r["image_id"] for r in records}),
        "num_unique_labels": len(hist),
        "mean_confidence": float(np.mean(confs)) if confs else 0.0,
        "top_labels": sorted(hist.items(), key=lambda kv: -kv[1])[:20],
        "reject_reasons": reject_reasons,
    }
