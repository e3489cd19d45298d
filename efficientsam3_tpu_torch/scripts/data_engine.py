#!/usr/bin/env python
"""Data engine: VLM pseudo-labels from a SA-1B-style mask dataset.

Counterpart of scripts/data_engine.py of the JAX package (the reference's
stage3/data_engine generate.py, build_manifest.py and audit.py in one
tool): label every ground-truth mask with a VLM (or the deterministic
``stub`` backend), filter and normalise, and write the raw records
(jsonl), a COCO-format pseudo-label json (input of
``efficientsam3_tpu_torch.scripts.train_stage3 --sources``) and audit
statistics. The ``openai_api`` backend needs a reachable chat server.
Host code: ``--device`` is checked and not otherwise used.

    python -m efficientsam3_tpu_torch.scripts.data_engine --ann masks.json \
        --image-root images/ [--backend stub] [--output-root data/pseudo_labels]
"""

from __future__ import annotations

import argparse
import json
import os

from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts._common import add_device_flag, load_rgb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ann", required=True, help="COCO-format mask json")
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--output-root", default="data/pseudo_labels")
    ap.add_argument("--backend", default="stub", choices=["stub", "openai_api"])
    ap.add_argument("--server-url", default=None)
    ap.add_argument("--api-key", default=os.environ.get("OPENAI_API_KEY", ""))
    ap.add_argument("--model-name", default="Qwen/Qwen2.5-VL-7B-Instruct")
    ap.add_argument("--min-confidence", type=float, default=0.4)
    ap.add_argument("--min-area-frac", type=float, default=0.0005)
    ap.add_argument("--max-images", type=int, default=0, help="0 = all")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from efficientsam3_tpu_torch.data import engine
    from efficientsam3_tpu_torch.eval.coco_format import CocoDataset

    if args.backend == "stub":
        vlm = engine.stub_vlm
    else:
        from efficientsam3_tpu_torch.agent import openai_chat_client

        vlm = engine.chat_vlm_client(
            openai_chat_client(args.server_url, args.api_key, args.model_name)
        )

    ds = CocoDataset(args.ann)
    image_ids = list(ds.images)
    if args.max_images:
        image_ids = image_ids[: args.max_images]

    def samples():
        for img_id in image_ids:
            info = ds.images[img_id]
            path = os.path.join(args.image_root, info["file_name"])
            yield {
                "image_id": img_id,
                "width": info["width"],
                "height": info["height"],
                "image": load_rgb(path) if os.path.exists(path) else None,
                "masks": [
                    {
                        "mask_id": str(a["id"]),
                        "bbox_xywh": a["bbox"],
                        "area": a.get("area", a["bbox"][2] * a["bbox"][3]),
                        "segmentation": a.get("segmentation"),
                    }
                    for a in ds.annotations(img_id)
                ],
            }

    records = engine.label_masks(
        samples(), vlm=vlm,
        min_confidence=args.min_confidence, min_area_frac=args.min_area_frac,
    )

    os.makedirs(args.output_root, exist_ok=True)
    with open(os.path.join(args.output_root, "raw_records.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    coco = engine.records_to_coco(records, min_confidence=args.min_confidence)
    with open(os.path.join(args.output_root, "pseudo_labels_coco.json"), "w") as f:
        json.dump(coco, f)
    stats = engine.audit(records)
    with open(os.path.join(args.output_root, "audit.json"), "w") as f:
        json.dump(stats, f, indent=2)
    summary = {k: stats[k] for k in ("num_records", "num_accepted", "acceptance_rate",
                                     "num_images", "num_unique_labels")}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
