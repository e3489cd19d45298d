"""EdgeSAM-style standalone SAM1 student example.

Counterpart of examples/edge_sam_example.py of the JAX package (the
reference's student_sam predictor and build_sam.py registry): a distilled
student trunk (RepViT / TinyViT / EfficientViT) with the original SAM
prompt encoder and mask decoder, no SAM3 detector and no tracker, for
classic point / box segmentation. Seeded weights (an API demonstration).

    python -m efficientsam3_tpu_torch.examples.edge_sam_example [image.jpg] [registry_key]
"""

from __future__ import annotations

import argparse

import numpy as np

from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts._common import add_device_flag, load_rgb
from efficientsam3_tpu_torch.student_sam import SamStudentPredictor, sam_model_registry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("image", nargs="?", default=None)
    ap.add_argument("key", nargs="?", default="efficientvit", help="sam_model_registry key")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    key = args.key
    if args.image:
        image = load_rgb(args.image)
    else:
        image = np.random.default_rng(0).integers(0, 255, (480, 640, 3), np.uint8)

    model = sam_model_registry[key](device=resolve_device(args.device), seed=0)
    pred = SamStudentPredictor(model)
    pred.set_image(image)

    # single positive click
    masks, ious, low = pred.predict(
        point_coords=np.array([[320.0, 240.0]]), point_labels=[1]
    )
    print(f"[{key}] point prompt: masks {masks.shape}, predicted IoUs {ious}")

    # box prompt, single-mask output
    m2, i2, _ = pred.predict(
        box=np.array([120.0, 80.0, 520.0, 400.0]), multimask_output=False
    )
    print(f"[{key}] box prompt: mask {m2.shape}, area {int(m2.sum())}")
    return masks, m2


if __name__ == "__main__":
    main()
