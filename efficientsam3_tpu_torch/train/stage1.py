"""Stage-1 encoder distillation: student trunk vs saved teacher embeddings.

Counterpart of efficientsam3_tpu/train/stage1.py, the reference stage-1
image distillation (stage1/train_image_encoder_stage1.py): the student
(trunk + projection head) regresses the teacher's 72x72x1024 embedding
with a masked MSE plus a masked per-pixel cosine loss
(train_image_encoder_stage1.py:284-297), under AdamW + gradient clip 5.0
and a cosine learning-rate schedule scaled linearly by global batch / 512
(stage1/configs/base_stage1.yaml).

``stage1_train_step(model, optimizer, batch)`` has the Stage-3 step's
signature, so ``train/trainer.Trainer`` runs it unchanged; ``model`` may be
any trunk (a ``make_student`` encoder, or a ViTDet ``ViTTrunk`` whose
output is the embedding). The step runs the model in training mode:
BatchNorm statistics update (flax's ``mutable=["batch_stats"]``) and
DropPath is active. As in JAX, where ``stage1_loss`` passes no rngs to
``apply``, it passes no generator: a model with a nonzero drop-path rate
(the ViTDet default 0.1, TinyViT-11M and -21M) raises.

``make_optimizer`` is the optax chain of the JAX package: clip by global
norm, then ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on
every parameter) at ``cosine_decay_schedule(lr, epochs x steps_per_epoch,
alpha=1e-2)``, read at the number of updates taken so far (0 for the
first), on ``torch.optim.AdamW``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from efficientsam3_tpu_torch.build import make_student_trunk
from efficientsam3_tpu_torch.train.stage3 import clip_by_global_norm_


@dataclasses.dataclass(frozen=True)
class Stage1ImageConfig:
    backbone_type: str = "efficientvit"
    model_name: str = "b1"
    embed_dim: int = 1024
    embed_size: int = 72
    image_size: int = 1008
    pixel_loss_weight: float = 1.0  # MSE (base_stage1.yaml PIXEL_WISE)
    cosine_loss_weight: float = 1.0  # COSINE
    base_lr: float = 1e-3
    weight_decay: float = 0.05
    grad_clip: float = 5.0
    epochs: int = 50
    global_batch: int = 64


def make_student(cfg: Stage1ImageConfig, dtype: Optional[torch.dtype] = None):
    """The student trunk + projection head, parameters uninitialised (the
    caller loads or draws them: ``build.init_parameters``)."""
    return make_student_trunk(cfg.backbone_type, cfg.model_name, embed_dim=cfg.embed_dim,
                              embed_size=cfg.embed_size, dtype=dtype)


def masked_mse(pred, target, valid_mask):
    """reference stage1/train_image_encoder_stage1.py:284.

    pred / target (B, H, W, C); valid_mask (B, H, W), 1.0 where valid."""
    err = (pred.float() - target.float()).square().mean(-1) * valid_mask
    return err.sum() / valid_mask.sum().clamp_min(1.0)


def masked_cosine_loss(pred, target, valid_mask):
    """reference stage1/train_image_encoder_stage1.py:291: 1 - cos per pixel."""
    p, t = pred.float(), target.float()
    dot = (p * t).sum(-1)
    denom = torch.linalg.vector_norm(p, dim=-1) * torch.linalg.vector_norm(t, dim=-1) + 1e-6
    loss = (1.0 - dot / denom) * valid_mask
    return loss.sum() / valid_mask.sum().clamp_min(1.0)


def stage1_loss(model, images, teacher_embed, valid_mask,
                cfg: Optional[Stage1ImageConfig] = None):
    """(total, mse, cosine) of the model's training-mode forward."""
    pix_w = cfg.pixel_loss_weight if cfg else 1.0
    cos_w = cfg.cosine_loss_weight if cfg else 1.0
    model.train()
    pred = model(images)
    mse = masked_mse(pred, teacher_embed, valid_mask)
    cos = masked_cosine_loss(pred, teacher_embed, valid_mask)
    return pix_w * mse + cos_w * cos, mse, cos


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule: init * ((1 - alpha) * 0.5 * (1 + cos(pi
    * min(count, decay_steps) / decay_steps)) + alpha)."""

    def fn(count):
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return fn


class Stage1Optimizer:
    """The Stage-1 optax chain (module docstring) over every parameter of a
    model; turns on every parameter's gradient."""

    def __init__(self, cfg: Stage1ImageConfig, steps_per_epoch: int, model: torch.nn.Module):
        self.cfg = cfg
        model.requires_grad_(True)
        self.params = list(model.parameters())
        lr = cfg.base_lr * cfg.global_batch / 512.0
        self.schedule = cosine_decay_schedule(lr, cfg.epochs * steps_per_epoch, alpha=1e-2)
        self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=cfg.weight_decay)
        self.count = 0  # updates taken (optax's schedule count)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """Clip every gradient by their global norm (optax: unchanged below
        grad_clip, else g / norm * grad_clip), then one AdamW update at the
        schedule's rate for the current count."""
        for p in self.params:
            if p.grad is None:  # unused parameters: JAX's gradient is 0
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in self.params], self.cfg.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


def make_optimizer(cfg: Stage1ImageConfig, steps_per_epoch: int,
                   model: torch.nn.Module) -> Stage1Optimizer:
    """AdamW + cosine schedule + clip over ``model``'s parameters, the
    learning rate scaled linearly by batch / 512."""
    return Stage1Optimizer(cfg, steps_per_epoch, model)


def stage1_train_step(model, optimizer: Stage1Optimizer, batch: dict,
                      cfg: Optional[Stage1ImageConfig] = None) -> dict:
    """One distillation step in training mode; updates the model's
    parameters and BatchNorm statistics in place.

    batch: image (B, S, S, 3) normalised, teacher (B, E, E, C), valid
    (B, E, E), as ``data.sa1b.SA1BDistillationDataset`` gives them (numpy
    arrays are moved to the model's device). Returns loss, mse and cosine
    as 0-d tensors."""
    dev = next(model.parameters()).device
    images, teacher, valid = (torch.as_tensor(batch[k]).to(dev)
                              for k in ("image", "teacher", "valid"))
    optimizer.zero_grad()
    loss, mse, cos = stage1_loss(model, images, teacher, valid, cfg)
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach(), "mse": mse.detach(), "cosine": cos.detach()}


def teacher_embedder(trunk: torch.nn.Module):
    """The teacher's forward as ``data.sa1b.export_teacher_embeddings``
    takes it: numpy images (B, S, S, 3) in, numpy fp32 embeddings out, the
    trunk in eval mode under inference mode on its own device."""
    dev = next(trunk.parameters()).device

    def apply(images):
        trunk.eval()
        with torch.inference_mode():
            out = trunk(torch.as_tensor(np.asarray(images, np.float32)).to(dev))
        return out.float().cpu().numpy()

    return apply
