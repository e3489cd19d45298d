"""SAM1-task example: interactive point / box segmentation and automatic masks.

Counterpart of examples/sam1_task_example.py of the JAX package (the
reference's efficientsam3_for_sam1_task_example): the tracker core's SAM
heads over a student encoder's SAM2-neck features (no memory: the SAM1
task), through ``EfficientSam3System.interactive_predictor``, plus SAM's
automatic mask generation over a point grid. Seeded weights (an API
demonstration).

    python -m efficientsam3_tpu_torch.examples.sam1_task_example [image.jpg]
"""

from __future__ import annotations

import argparse

import numpy as np

from efficientsam3_tpu_torch.automatic_mask_generator import AutomaticMaskGenerator
from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts._common import add_device_flag, load_rgb
from efficientsam3_tpu_torch.system import EfficientSam3System


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.image:
        image = load_rgb(args.image)
    else:
        image = np.random.default_rng(0).integers(0, 255, (480, 640, 3), np.uint8)

    # the tracker core owns the SAM heads; its no-memory path is the SAM1
    # task. The frame pyramid comes from the image model's SAM2 neck.
    image_model, core = build_efficientsam3_video_model(
        backbone_type="repvit", model_name="m1.1",
        text_encoder_type="MobileCLIP-S0", text_encoder_context_length=32,
        device=resolve_device(args.device),
    )
    predictor = EfficientSam3System(image_model, core).interactive_predictor()
    predictor.set_image(image)

    h, w = image.shape[:2]
    masks, ious, logits = predictor.predict(
        point_coords=np.asarray([[w // 2, h // 2]]),
        point_labels=np.asarray([1]),
        multimask_output=True,
    )
    best = int(np.argmax(ious))
    print(f"point prompt -> {masks.shape[0]} masks, best IoU pred "
          f"{float(ious[best]):.3f}, area {int(masks[best].sum())} px")

    box = np.asarray([w * 0.25, h * 0.25, w * 0.75, h * 0.75])
    masks_b, ious_b, _ = predictor.predict(box=box, multimask_output=False)
    print(f"box prompt   -> mask area {int(masks_b[0].sum())} px")

    amg = AutomaticMaskGenerator(predictor, points_per_side=8)
    anns = amg.generate(image)
    print(f"automatic    -> {len(anns)} masks")
    return masks, masks_b, anns


if __name__ == "__main__":
    main()
