#!/usr/bin/env python
"""SA-Co/VEval-style video PCS evaluation driver.

Counterpart of scripts/eval_video.py of the JAX package (reference
saco_veval_evaluators.py and train/configs/saco_video_evals/*.yaml): run
the whole video pipeline (detector + tracker + association heuristics,
``video/pipeline.VideoPCSPredictor``) over each video, and score HOTA,
TETA and J&F against the ground truth.

Dataset JSON format:
  {"videos": [
      {"id": ..., "frames_dir": "path", "text": "noun phrase",
       "annotations": [  # per frame, at the pipeline's output size
          {"obj_ids": [1, 2], "masks_npz": "gt_000.npz"}  # bool (N, H, W) under "masks"
          ...
       ]}
  ]}
``--no-heuristics`` maps to the reference's *_noheur configs: hotstart
off, occlusion suppression off (eval/gold.SACO_VEVAL_SUBSETS).

Frames are loaded at ``--resolution`` and normalised (mean / std 0.5), as
both the tracker and the detector take them; the detector encodes each
frame with ``Sam3Processor.set_preprocessed_image`` and grounds the video's
text with ``run_grounding``. ``--ckpt`` loads a reference .pt into the image
model and the tracker (``load_reference_checkpoint``); without one both
keep seeded weights.

    python -m efficientsam3_tpu_torch.scripts.eval_video --dataset veval.json \
        --ckpt sam3.pt --out VEVAL_METRICS.json [--no-heuristics]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.eval.hota import HOTAEvaluator
from efficientsam3_tpu_torch.eval.teta import TETAEvaluator
from efficientsam3_tpu_torch.eval.video_eval import evaluate_video_predictions
from efficientsam3_tpu_torch.scripts._common import add_device_flag


def load_gt_frames(video_root, anns):
    frames = []
    for a in anns:
        masks = np.load(os.path.join(video_root, a["masks_npz"]))["masks"]
        frames.append({"obj_ids": a["obj_ids"], "masks": masks})
    return frames


def namespace_ids(frames, vidx):
    """Track ids restart each video; HOTA / TETA accumulate global ids."""
    return [dict(f, obj_ids=[(vidx << 20) + int(i) for i in f["obj_ids"]]) for f in frames]


def make_detector(proc, text_state):
    """The pipeline's detector: ground the encoded text on a frame that is
    already at the model's resolution and normalised."""

    def detector(frame, _):
        st = proc.set_preprocessed_image(frame, dict(text_state))
        st = proc.run_grounding(st)
        return {"masks": st["masks"], "scores": st["scores"], "boxes": st["boxes"]}

    return detector


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default="VEVAL_METRICS.json")
    ap.add_argument("--backbone", default="efficientvit")
    ap.add_argument("--model-name", default="b1")
    ap.add_argument("--resolution", type=int, default=1008)
    ap.add_argument("--no-heuristics", action="store_true",
                    help="hotstart + occlusion suppression off (the "
                         "reference's *_noheur eval configs)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from efficientsam3_tpu_torch.processor import Sam3Processor
    from efficientsam3_tpu_torch.system import EfficientSam3System
    from efficientsam3_tpu_torch.video.io import load_video_frames
    from efficientsam3_tpu_torch.video.pipeline import VideoPCSConfig, VideoPCSPredictor

    dev = resolve_device(args.device)
    with open(args.dataset) as f:
        dataset = json.load(f)
    root = os.path.dirname(os.path.abspath(args.dataset))

    model, core = build_efficientsam3_video_model(
        backbone_type=args.backbone, model_name=args.model_name,
        text_encoder_type="MobileCLIP-S0", text_encoder_context_length=32,
        dtype=torch.bfloat16, device=dev,
    )
    if args.ckpt:
        from efficientsam3_tpu_torch.utils.checkpoint import (
            load_reference_checkpoint,
            load_torch_state_dict,
        )

        sd = load_torch_state_dict(args.ckpt)
        load_reference_checkpoint(model, sd, part="image", backbone_type=args.backbone,
                                  model_name=args.model_name,
                                  text_encoder_type="MobileCLIP-S0", add_sam2_neck=True)
        load_reference_checkpoint(core, sd, part="tracker")
    proc = Sam3Processor(model, resolution=args.resolution)
    system = EfficientSam3System(model, core)

    cfg_kwargs = {}
    if args.no_heuristics:
        cfg_kwargs.update(
            hotstart_delay=0,
            suppress_unmatched_only_within_hotstart=True,
        )
    cfg = VideoPCSConfig(**cfg_kwargs)

    hota, teta = HOTAEvaluator(), TETAEvaluator()
    per_video = {}
    for vidx, video in enumerate(dataset["videos"]):
        frames = load_video_frames(
            os.path.join(root, video["frames_dir"]), resolution=args.resolution
        )
        frames = (frames.astype(np.float32) / 255.0 - 0.5) / 0.5
        text_state = proc.set_image(
            np.zeros((args.resolution, args.resolution, 3), np.uint8)
        )
        text_state = proc.set_text_prompt(video["text"], text_state)
        tracker = system.tracker_predictor(obj_slots=cfg.obj_slots)
        pipe = VideoPCSPredictor(make_detector(proc, text_state), tracker, cfg)
        preds = list(pipe.run_video(frames, text_state=None))
        gts = load_gt_frames(root, video["annotations"])
        per_video[str(video["id"])] = evaluate_video_predictions(
            namespace_ids(preds, vidx), namespace_ids(gts, vidx), hota, teta
        )

    metrics = {"per_video_JF": per_video}
    metrics.update(hota.summarize())
    metrics.update(teta.summarize())
    metrics["heuristics"] = not args.no_heuristics
    with open(args.out, "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps({k: v for k, v in metrics.items()
                      if not isinstance(v, dict)}, indent=2))
    return metrics


if __name__ == "__main__":
    main()
