"""Stage-3 joint finetune: train the student trunk and text tower inside the
full model, the SAM3 heads frozen.

Counterpart of efficientsam3_tpu/train/stage3.py (the reference stage-3
recipe: vision lr 2.5e-5, text lr 5e-6, weight decay 0.1, gradient clip 1,
inverse-sqrt schedule with 1000 warm-up steps) on the port's
``Sam3ImageModel`` in training mode, with ``train/losses.py``. The
optimizer follows the JAX package's optax chain exactly:

  - parameters are labelled 'vision' (the trunk), 'text' (the text tower)
    or 'frozen' (everything else; 'vision' with train_all);
  - each trained group clips its own gradients by their global norm
    (optax: g unchanged if norm < max_norm, else g / norm * max_norm),
    then takes an AdamW step (decoupled weight decay, eps 1e-8) at the
    learning rate its schedule gives for the number of updates taken so
    far (0 for the first);
  - the frozen group's update is exactly zero: its parameters are not in
    the optimizer. They still take gradients, because the ``grad_norm``
    metric is the global norm of every parameter's gradient, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from efficientsam3_tpu_torch.train.losses import sam3_detection_loss


@dataclasses.dataclass(frozen=True)
class Stage3Config:
    vision_lr: float = 2.5e-5
    text_lr: float = 5e-6
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 1000
    timescale: int = 10000
    # heads in the 'vision' group instead of frozen (from-scratch runs)
    train_all: bool = False
    # 'inverse_sqrt' (the reference stage-3 recipe) or 'cosine' (to ~0 at timescale)
    schedule: str = "inverse_sqrt"


def param_labels(model: torch.nn.Module, train_all: bool = False) -> dict:
    """{parameter name: 'vision' | 'text' | 'frozen'} by top-level module."""
    labels = {}
    for name, _ in model.named_parameters():
        top = name.split(".", 1)[0]
        if top == "trunk":
            labels[name] = "vision"
        elif top == "text_encoder":
            labels[name] = "text"
        else:
            labels[name] = "vision" if train_all else "frozen"
    return labels


def inverse_sqrt_schedule(base_lr: float, warmup: int, timescale: int):
    def fn(step):
        step = max(step, 1)
        warm = min(step / max(warmup, 1), 1.0)
        return base_lr * warm * math.sqrt(timescale / max(step, timescale))

    return fn


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def fn(step):
        warm = min(step / max(warmup, 1), 1.0)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * warm * 0.5 * (1.0 + math.cos(math.pi * frac))

    return fn


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    tensors = [t for t in tensors if t is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads, max_norm: float):
    """optax.clip_by_global_norm, in place: the gradients are unchanged when
    their global norm is below max_norm, else scaled by max_norm / norm."""
    norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))


class ClippedAdamW:
    """optax's chain(clip_by_global_norm, adamw) per group of parameters:
    each group {label: (parameters, schedule)} clips its own gradients by
    their global norm, then takes an AdamW step (b1 0.9, b2 0.999, eps
    1e-8, decoupled weight decay on each of its parameters, optax's
    default) at the rate ``schedule(count)`` for the count of updates taken
    so far (0 for the first). Parameters in no group get no update
    (optax.set_to_zero). ``params``: every parameter whose gradient
    ``zero_grad`` clears (the groups' by default)."""

    def __init__(self, groups: dict, weight_decay: float, grad_clip: float, params=None):
        self.grad_clip = grad_clip
        self.schedules = {g: sched for g, (_, sched) in groups.items()}
        self.params = list(params) if params is not None else [
            p for ps, _ in groups.values() for p in ps]
        self.adamw = torch.optim.AdamW(
            [{"params": list(ps), "label": g} for g, (ps, _) in groups.items() if ps],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.count = 0  # updates taken (optax's schedule count)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for group in self.adamw.param_groups:
            for p in group["params"]:
                if p.grad is None:  # unused parameters: JAX's gradient is 0
                    p.grad = torch.zeros_like(p)
            clip_by_global_norm_([p.grad for p in group["params"]], self.grad_clip)
            group["lr"] = self.schedules[group["label"]](self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


def constant_schedule(lr: float):
    return lambda count: lr


class Stage3Optimizer(ClippedAdamW):
    """The stage-3 optax chain (see the module docstring) over a model's
    parameters: per-group clip + AdamW, frozen group untouched. Turns on
    every parameter's gradient."""

    def __init__(self, cfg: Stage3Config, model: torch.nn.Module):
        self.cfg = cfg
        model.requires_grad_(True)
        labels = param_labels(model, cfg.train_all)
        groups = {"vision": [], "text": []}
        for name, p in model.named_parameters():
            if labels[name] != "frozen":
                groups[labels[name]].append(p)
        sched = cosine_schedule if cfg.schedule == "cosine" else inverse_sqrt_schedule
        super().__init__(
            {"vision": (groups["vision"], sched(cfg.vision_lr, cfg.warmup_steps, cfg.timescale)),
             "text": (groups["text"], sched(cfg.text_lr, cfg.warmup_steps, cfg.timescale))},
            cfg.weight_decay, cfg.grad_clip, model.parameters())


def make_stage3_optimizer(cfg: Stage3Config, model: torch.nn.Module) -> Stage3Optimizer:
    return Stage3Optimizer(cfg, model)


def stage3_train_step(model, optimizer: Stage3Optimizer, batch: dict, loss_weights=None) -> dict:
    """One Stage-3 step in training mode; updates the model's parameters and
    BatchNorm statistics in place.

    batch: images (B, H, W, 3) normalised, tokens (B, L) int, prompt
    (``models.geometry.Prompt``), targets {boxes (B, T, 4) cxcywh, valid
    (B, T) bool, masks (B, T, h, w)}. loss_weights: overrides of
    ``losses.DEFAULT_WEIGHTS``. Returns the metrics as 0-d tensors: loss,
    grad_norm (every parameter's gradient, before clipping) and
    loss_<part> for every loss part.
    """
    model.train()
    outs = model(batch["images"], batch["tokens"], batch["prompt"])
    total, parts = sam3_detection_loss(outs, batch["targets"], weights=loss_weights)
    optimizer.zero_grad()
    total.backward()
    grad_norm = global_norm(p.grad for p in optimizer.params)
    optimizer.step()
    return {"loss": total.detach(), "grad_norm": grad_norm,
            **{f"loss_{k}": v.detach() for k, v in parts.items()}}
