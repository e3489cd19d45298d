#!/usr/bin/env python
"""Teacher embedding export for Stage-1 distillation.

Counterpart of scripts/save_embedding_image_stage1.py of the JAX package
(reference stage1/save_embedding_image_stage1.py): one pass of the ViT-H
teacher (bf16) over the folder's images, storing [aug seed | fp16
embedding] records (``data/sa1b``); ``--check-saved-embed`` re-reads up to
16 records and compares them with fresh teacher outputs (the reference's
verification mode; ``main`` returns the largest error and the largest
magnitude of the records read). ``--teacher-checkpoint`` loads a SAM3 .pt's trunk
through ``load_reference_checkpoint(part="vitdet")``; without one the
teacher's weights are seeded.

    python -m efficientsam3_tpu_torch.scripts.save_embedding_image_stage1 \
        --images-dir data/sa1b --store data/teacher_embeds.bin [--check-saved-embed]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from efficientsam3_tpu_torch.build import init_parameters
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
from efficientsam3_tpu_torch.scripts._common import add_device_flag, image_paths


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images-dir", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--teacher-checkpoint", default=None, help="sam3.pt path")
    ap.add_argument("--image-size", type=int, default=1008)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--check-saved-embed", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from efficientsam3_tpu_torch.data.sa1b import (
        SA1BDistillationDataset,
        export_teacher_embeddings,
    )
    from efficientsam3_tpu_torch.train.stage1 import teacher_embedder

    dev = resolve_device(args.device)
    teacher = ViTTrunk(dtype=torch.bfloat16)
    if args.teacher_checkpoint:
        from efficientsam3_tpu_torch.utils.checkpoint import load_reference_checkpoint

        load_reference_checkpoint(teacher, args.teacher_checkpoint, part="vitdet",
                                  depth=len(teacher.blocks))
    else:
        print("WARNING: no teacher checkpoint; exporting random-teacher embeddings")
        init_parameters(teacher, 0)
    teacher = teacher.requires_grad_(False).eval().to(dev)
    apply_fn = teacher_embedder(teacher)
    paths = image_paths(args.images_dir)
    embed_size = args.image_size // teacher.patch_size

    if args.check_saved_embed:
        ds = SA1BDistillationDataset(paths, args.store, image_size=args.image_size,
                                     embed_dim=teacher.embed_dim, embed_size=embed_size)
        errs, mags = [], []
        for i in range(min(len(ds), 16)):
            s = ds[i]
            fresh = apply_fn(s["image"][None])[0]
            errs.append(float(np.abs(fresh.astype(np.float16) - s["teacher"]).max()))
            mags.append(float(np.abs(s["teacher"]).max()))
        print(f"max record error over {len(errs)} samples: {max(errs):.4f} "
              f"(largest magnitude {max(mags):.4f})")
        return max(errs), max(mags)

    export_teacher_embeddings(
        apply_fn, paths, args.store,
        image_size=args.image_size, batch_size=args.batch_size,
    )
    print(f"exported {len(paths)} records to {args.store}")
    return len(paths)


if __name__ == "__main__":
    main()
