#!/usr/bin/env python
"""Stage-3 joint finetune entry point.

Counterpart of scripts/train_stage3.py of the JAX package (reference
stage3/train_stage3.py): finetune the student trunk and the text tower
inside the full model on mixed COCO-format sources, the heads frozen
(``train/stage3``), through the port's ``Trainer``: partial checkpoints of
``trunk`` and ``text_encoder`` under ``--checkpoint-dir``, auto-resume from
the latest one. ``--checkpoint`` loads a reference (Stage-1 spliced) .pt
through ``load_reference_checkpoint``.

Randomness: the batch of step s is drawn from a generator seeded by
(0, s), so a resumed run sees the batches an unbroken run would; dropout
draws from torch's generator, seeded once. Multi-process runs take their
ranks from the environment (``parallel.initialize_distributed``; e.g.
``torchrun``), one card a process.

    python -m efficientsam3_tpu_torch.scripts.train_stage3 --sources sources.json \
        [--max-steps 30000] [--checkpoint-dir checkpoints/stage3]
"""

from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.device import resolve_device
from efficientsam3_tpu_torch.scripts._common import add_device_flag, model_resolution
from efficientsam3_tpu_torch.train.stage3 import (
    Stage3Config,
    make_stage3_optimizer,
    stage3_train_step,
)


def step_batches(dataset, tokenizer, batch_size, context_length, start=0):
    """The dataset's batches from step ``start`` on, step s drawn from a
    generator seeded by (0, s)."""
    for s in itertools.count(start):
        dataset.rng = np.random.default_rng([0, s])
        yield next(dataset.batches(tokenizer, batch_size, context_length))


def to_step_batch(batch, device):
    """A ``Stage3MixedDataset`` batch (numpy) as ``stage3_train_step`` takes it."""
    from efficientsam3_tpu_torch.models.geometry import Prompt

    b = batch["images"].shape[0]
    return {
        "images": torch.as_tensor(batch["images"]).to(device),
        "tokens": torch.as_tensor(batch["tokens"]).long().to(device),
        "prompt": Prompt.empty(b, 8, 8, device=device),
        "targets": {k: torch.as_tensor(v).to(device) for k, v in batch["targets"].items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sources", required=True,
                    help="JSON: [{name, ann, image_root, weight}, ...]")
    ap.add_argument("--backbone", default="efficientvit")
    ap.add_argument("--model", default="b1")
    ap.add_argument("--text-encoder", default="MobileCLIP-S0")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=30000)
    ap.add_argument("--checkpoint", default=None, help="stage-1 spliced .pt")
    ap.add_argument("--checkpoint-dir", default="checkpoints/stage3")
    ap.add_argument("--context-length", type=int, default=32)
    ap.add_argument("--no-augment", action="store_true",
                    help="disable hflip/LSJ/color-jitter augmentations")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from efficientsam3_tpu_torch.parallel import initialize_distributed

    if initialize_distributed():
        import torch.distributed as dist

        print(f"multi-process: rank {dist.get_rank()}/{dist.get_world_size()}")

    from efficientsam3_tpu_torch.data.stage3_mixed import Source, Stage3MixedDataset
    from efficientsam3_tpu_torch.eval.coco_format import CocoDataset
    from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig
    from efficientsam3_tpu_torch.utils.checkpoint import latest_step
    from efficientsam3_tpu_torch.utils.tokenizer import ClipTokenizer

    dev = resolve_device(args.device)
    model = build_efficientsam3_image_model(
        backbone_type=args.backbone, model_name=args.model,
        text_encoder_type=args.text_encoder,
        text_encoder_context_length=args.context_length,
        dtype=torch.bfloat16, device=dev,
    )
    res = model_resolution(model)
    if args.checkpoint:
        from efficientsam3_tpu_torch.utils.checkpoint import load_reference_checkpoint

        load_reference_checkpoint(model, args.checkpoint, part="image",
                                  backbone_type=args.backbone, model_name=args.model,
                                  text_encoder_type=args.text_encoder)

    opt = make_stage3_optimizer(Stage3Config(), model)

    with open(args.sources) as f:
        srcs = [
            Source(s["name"], CocoDataset(s["ann"]), s["image_root"], s.get("weight", 1.0))
            for s in json.load(f)
        ]
    dataset = Stage3MixedDataset(srcs, image_size=res, augment=not args.no_augment)
    tokenizer = ClipTokenizer()
    torch.manual_seed(0)  # dropout's stream, seeded once

    def step(model, opt, batch):
        return stage3_train_step(model, opt, to_step_batch(batch, dev))

    trainer = Trainer(
        step,
        TrainerConfig(
            max_steps=args.max_steps,
            checkpoint_dir=args.checkpoint_dir,
            save_param_prefixes=("trunk", "text_encoder"),  # partial checkpoints
        ),
    )
    start = latest_step(args.checkpoint_dir) or 0
    return trainer.run(model, opt, step_batches(dataset, tokenizer, args.batch_size,
                                                args.context_length, start))


if __name__ == "__main__":
    main()
