#!/usr/bin/env python
"""COCO box-prompt mIoU evaluation entry point.

Counterpart of scripts/eval_coco.py of the JAX package (reference
eval/eval_coco.py): run the SAM1-task predictor (``EfficientSam3System.
interactive_predictor``) over a COCO file's instance boxes and report the
mask mIoU. ``--checkpoint`` loads a released EfficientSAM3 .pt into the
image model and the tracker (``load_reference_checkpoint``); without one
both keep seeded weights (the numbers then mean nothing).

    python -m efficientsam3_tpu_torch.scripts.eval_coco --ann instances_val2017.json \
        --images-dir val2017 --checkpoint efficientsam3_ev_m.pt \
        --backbone efficientvit --model b1 --max-images 100
"""

from __future__ import annotations

import argparse
import os

import torch

from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts._common import add_device_flag, load_rgb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ann", required=True)
    ap.add_argument("--images-dir", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--backbone", default="efficientvit")
    ap.add_argument("--model", default="b1")
    ap.add_argument("--max-images", type=int, default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from efficientsam3_tpu_torch.eval.coco_format import CocoDataset
    from efficientsam3_tpu_torch.eval.eval_coco import evaluate_box_prompt_miou
    from efficientsam3_tpu_torch.system import EfficientSam3System

    image_model, tracker_core = build_efficientsam3_video_model(
        backbone_type=args.backbone, model_name=args.model, dtype=torch.bfloat16,
        device=resolve_device(args.device),
    )
    if args.checkpoint:
        from efficientsam3_tpu_torch.utils.checkpoint import (
            load_reference_checkpoint,
            load_torch_state_dict,
        )

        sd = load_torch_state_dict(args.checkpoint)
        load_reference_checkpoint(image_model, sd, part="image", backbone_type=args.backbone,
                                  model_name=args.model, text_encoder_type="MobileCLIP-S0",
                                  add_sam2_neck=True)
        load_reference_checkpoint(tracker_core, sd, part="tracker")
    else:
        print("WARNING: seeded weights (no checkpoint) — numbers are meaningless")

    predictor = EfficientSam3System(image_model, tracker_core).interactive_predictor()
    dataset = CocoDataset(args.ann)

    def load_image(info):
        return load_rgb(os.path.join(args.images_dir, info["file_name"]))

    out = evaluate_box_prompt_miou(
        predictor, dataset, load_image, max_images=args.max_images
    )
    print(out)
    return out


if __name__ == "__main__":
    main()
