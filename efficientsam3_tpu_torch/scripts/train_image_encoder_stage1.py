#!/usr/bin/env python
"""Stage-1 image encoder distillation entry point.

Counterpart of scripts/train_image_encoder_stage1.py of the JAX package
(reference stage1/train_image_encoder_stage1.py): train a student trunk
against stored teacher embeddings (see save_embedding_image_stage1 for the
export pass) through the port's ``Trainer``, checkpoints and auto-resume
under ``--checkpoint-dir``. Data parallelism: the processes of a
``torch.distributed`` world (ranks from the environment,
``parallel.initialize_distributed``; e.g. ``torchrun --nproc_per_node=N``),
one card each; ``--dp`` picks the mesh's size (0 = the whole world) and a
mesh is made when it is above 1.

    python -m efficientsam3_tpu_torch.scripts.train_image_encoder_stage1 \
        --images-dir data/sa1b --store data/teacher_embeds.bin \
        --backbone efficientvit --model b1 --batch-size 64 --epochs 50
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from efficientsam3_tpu_torch.build import init_parameters
from efficientsam3_tpu_torch.data.sa1b import SA1BDistillationDataset, batch_iterator
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.parallel import initialize_distributed, make_mesh
from efficientsam3_tpu_torch.scripts._common import add_device_flag, image_paths
from efficientsam3_tpu_torch.train.stage1 import (
    Stage1ImageConfig,
    make_optimizer,
    make_student,
    stage1_train_step,
)
from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images-dir", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--backbone", default="efficientvit")
    ap.add_argument("--model", default="b1")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--base-lr", type=float, default=1e-3)
    ap.add_argument("--image-size", type=int, default=1008)
    ap.add_argument("--checkpoint-dir", default="checkpoints/stage1")
    ap.add_argument("--dp", type=int, default=0, help="data-parallel devices (0=all)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    initialize_distributed()
    dev = resolve_device(args.device)
    cfg = Stage1ImageConfig(
        backbone_type=args.backbone, model_name=args.model,
        image_size=args.image_size, embed_size=args.image_size // 14,
        base_lr=args.base_lr, epochs=args.epochs, global_batch=args.batch_size,
    )
    dataset = SA1BDistillationDataset(
        image_paths(args.images_dir), args.store, image_size=cfg.image_size,
        embed_dim=cfg.embed_dim, embed_size=cfg.embed_size,
    )
    steps_per_epoch = len(dataset) // args.batch_size
    model = init_parameters(make_student(cfg), 0).to(dev)
    opt = make_optimizer(cfg, steps_per_epoch, model)

    world = dist.get_world_size() if dist.is_initialized() else 1
    n_dev = args.dp or world
    mesh = make_mesh({"dp": n_dev}) if n_dev > 1 else None
    trainer = Trainer(
        stage1_train_step,
        TrainerConfig(
            max_steps=cfg.epochs * steps_per_epoch,
            checkpoint_dir=args.checkpoint_dir,
            mesh=mesh,
        ),
    )
    return trainer.run(model, opt, batch_iterator(dataset, args.batch_size, epochs=cfg.epochs))


if __name__ == "__main__":
    main()
