"""Video PCS example: "track every <concept>" over a frame folder.

Counterpart of examples/video_pcs_example.py of the JAX package (the
reference's sam3 video predictor notebooks): the image detector grounds a
text prompt on every frame, detections are associated with tracked
masklets, and the SAM2-style streaming tracker propagates each object's
memory (``video/pipeline.VideoPCSPredictor``). The detector takes each
frame at the model's resolution, normalised, through the public
``Sam3Processor.set_preprocessed_image`` and ``run_grounding``. A
reference checkpoint (third argument) loads into the image model and the
tracker; without one the weights are seeded (a pipeline dry run). The
text prompt needs ``EFFICIENTSAM3_BPE_PATH``.

    python -m efficientsam3_tpu_torch.examples.video_pcs_example <frames_dir> "<concept>" [ckpt.pt]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.processor import Sam3Processor
from efficientsam3_tpu_torch.scripts._common import add_device_flag, model_resolution
from efficientsam3_tpu_torch.system import EfficientSam3System
from efficientsam3_tpu_torch.video.io import load_video_frames
from efficientsam3_tpu_torch.video.pipeline import VideoPCSConfig, VideoPCSPredictor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("frames_dir")
    ap.add_argument("concept", nargs="?", default="person")
    ap.add_argument("ckpt", nargs="?", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    image_model, tracker_core = build_efficientsam3_video_model(
        backbone_type="efficientvit", model_name="m",
        text_encoder_type="MobileCLIP-S0", text_encoder_context_length=32,
        dtype=torch.bfloat16, device=resolve_device(args.device),
    )
    res = model_resolution(image_model)
    if args.ckpt is not None:
        from efficientsam3_tpu_torch.utils.checkpoint import (
            load_reference_checkpoint,
            load_torch_state_dict,
        )

        sd = load_torch_state_dict(args.ckpt)
        load_reference_checkpoint(image_model, sd, part="image", backbone_type="efficientvit",
                                  model_name="b1", text_encoder_type="MobileCLIP-S0",
                                  add_sam2_neck=True)
        load_reference_checkpoint(tracker_core, sd, part="tracker")

    proc = Sam3Processor(image_model, resolution=res)

    def detector(frame, text_state):
        # one frame's grounding of the encoded prompt, thresholded on the
        # host; `frame` arrives normalised at the model's resolution
        state = proc.set_preprocessed_image(frame, dict(text_state))
        state = proc.run_grounding(state)
        return {"masks": state["masks"], "scores": state["scores"],
                "boxes": state["boxes"]}

    # encode the concept once; reused on every frame
    text_state = proc.set_image(np.zeros((res, res, 3), np.uint8))
    text_state = proc.set_text_prompt(args.concept, text_state)

    tracker = EfficientSam3System(image_model, tracker_core).tracker_predictor()
    pipe = VideoPCSPredictor(detector, tracker, VideoPCSConfig())

    frames = load_video_frames(args.frames_dir, resolution=res)
    frames = (np.asarray(frames, np.float32) / 255.0 - 0.5) / 0.5
    out = []
    for t, o in enumerate(pipe.run_video(frames, text_state=text_state)):
        print(f"frame {t}: {len(o['obj_ids'])} objects "
              f"{[int(i) for i in o['obj_ids']]}")
        out.append(o)
    return out


if __name__ == "__main__":
    main()
