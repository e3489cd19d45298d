#!/usr/bin/env python
"""Standalone cgF1: a predictions file and ground-truth file(s) -> metrics.

Counterpart of scripts/standalone_cgf1.py of the JAX package (reference
sam3/scripts/eval/standalone_cgf1.py). With several GT files (SA-Co gold's
a / b / c annotators), the multi-annotator oracle keeps the best-scoring
annotation of each (image, query) pair. Host code: ``--device`` is
checked and not otherwise used.

    python -m efficientsam3_tpu_torch.scripts.standalone_cgf1 --pred_file preds.json \
        --gt_files gold_a.json gold_b.json gold_c.json [--iou_type segm]
"""

from __future__ import annotations

import argparse
import json

from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts._common import add_device_flag


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_file", required=True,
                    help="COCO-format predictions json")
    ap.add_argument("--gt_files", nargs="+", required=True,
                    help="COCO-format ground-truth json file(s)")
    ap.add_argument("--iou_type", default="segm", choices=("segm", "bbox"))
    add_device_flag(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from efficientsam3_tpu_torch.eval.gold import evaluate_cgf1_files

    if len(args.gt_files) < 3 and any("gold" in g for g in args.gt_files):
        print("WARNING: gold subsets usually ship 3 annotator files (a/b/c)")
    out = evaluate_cgf1_files(args.pred_file, args.gt_files, args.iou_type)
    print(json.dumps(out, indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
