"""EfficientSAM3 image PCS example: text + box + point prompting.

Counterpart of examples/image_predictor_example.py of the JAX package (the
reference's efficientsam3_examples image predictor notebooks): EV-M in
bf16 through ``Sam3Processor``. A released checkpoint (.pt, first
argument) loads through ``load_reference_checkpoint``; without one the
weights are seeded (a dry run); without an image a synthetic one is used.
The text prompt needs ``EFFICIENTSAM3_BPE_PATH``.

    python -m efficientsam3_tpu_torch.examples.image_predictor_example [ckpt.pt] [image.jpg]
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
    ap.add_argument("paths", nargs="*", help="[ckpt.pt] [image]")
    ap.add_argument("--random-init", action="store_true", help="seeded weights (the default)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    paths = list(args.paths)
    image_path = paths[0] if paths else None
    model = build_efficientsam3_image_model(
        backbone_type="efficientvit",
        model_name="m",  # EV-M
        text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32,
        dtype=torch.bfloat16,
        device=resolve_device(args.device),
    )
    if image_path and image_path.endswith(".pt"):
        from efficientsam3_tpu_torch.utils.checkpoint import load_reference_checkpoint

        load_reference_checkpoint(model, image_path, part="image", backbone_type="efficientvit",
                                  model_name="b1", text_encoder_type="MobileCLIP-S0")
        image_path = paths[1] if len(paths) > 1 else None

    if image_path:
        image = load_rgb(image_path)
    else:
        image = (np.random.default_rng(0).random((480, 640, 3)) * 255).astype(np.uint8)

    proc = Sam3Processor(model, resolution=model_resolution(model))
    state = proc.set_image(image)
    state = proc.set_text_prompt("a dog", state)
    print(f"text prompt: {len(state['scores'])} detections, "
          f"scores={np.round(state['scores'][:5], 3)}")

    state = proc.add_geometric_prompt([0.5, 0.5, 0.4, 0.4], True, state)
    print(f"+box prompt: {len(state['scores'])} detections")

    state = proc.add_point_prompt([image.shape[1] // 2, image.shape[0] // 2], 1, state)
    print(f"+point prompt: {len(state['scores'])} detections; "
          f"masks shape {state['masks'].shape}")
    return state


if __name__ == "__main__":
    main()
