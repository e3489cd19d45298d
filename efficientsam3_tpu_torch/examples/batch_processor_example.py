"""Batched image PCS example: one concept over a batch of images.

Counterpart of examples/batch_processor_example.py of the JAX package (the
reference's batched inference, sam3_image_processor.py set_image_batch):
encode a whole batch in one call, set one text prompt, read each image's
detections. With no images synthetic ones are used (seeded weights: an API
demonstration). The text prompt needs ``EFFICIENTSAM3_BPE_PATH``.

    python -m efficientsam3_tpu_torch.examples.batch_processor_example [image1.jpg ...]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.processor import Sam3Processor
from efficientsam3_tpu_torch.scripts._common import add_device_flag, load_rgb, model_resolution


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="*", help="images")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.paths:
        images = [load_rgb(p) for p in args.paths]
    else:
        rng = np.random.default_rng(0)
        images = [(rng.random((480, 640, 3)) * 255).astype(np.uint8) for _ in range(4)]

    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="m",
        text_encoder_type="MobileCLIP-S0", text_encoder_context_length=32,
        dtype=torch.bfloat16, device=resolve_device(args.device),
    )
    proc = Sam3Processor(model, resolution=model_resolution(model))

    state = proc.set_image_batch(images)
    state = proc.set_text_prompt("a red ball", state)
    for i in range(len(images)):
        scores = np.asarray(state["scores"][i])
        masks = np.asarray(state["masks"][i])
        print(
            f"image {i}: {len(scores)} detections"
            + (f", best score {scores.max():.3f}" if len(scores) else "")
            + (f", mask px {int(masks.sum())}" if len(masks) else "")
        )
    return state


if __name__ == "__main__":
    main()
