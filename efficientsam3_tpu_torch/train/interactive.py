"""Train-time interactive steps (geometric prompt refinement).

Counterpart of efficientsam3_tpu/train/interactive.py (the reference
training loop's ``for cur_step in range(num_interactive_steps + 1)`` with
corrective clicks from the prediction's error region, get_next_point's
"center" mode): the image and the text are encoded once, then
``num_interactive_steps + 1`` grounding passes; after each pass but the
last a corrective click, placed where the Euclidean distance transform of
that pass's error region peaks, fills the next free point slot of the
prompt (from the end). The losses of every pass add up.

The clicks are taken from the detached outputs, on the device: the ground
truth is downsampled to the mask grid by the antialiased linear resize
(``jax.image.resize(..., "linear")`` antialiases when it shrinks), the
distance transform is the port's tensor ``ops.edt``, and argmax ties go to
the first index, as both libraries document.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.ops.edt import edt_batch
from efficientsam3_tpu_torch.ops.interpolate import resize_antialiased
from efficientsam3_tpu_torch.train.losses import sam3_detection_loss


def sample_correction_click(prev_masks, prev_logits, tgt_masks, tgt_valid):
    """A corrective click a sample from its largest prediction error.

    prev_masks (B, Q, h, w) mask logits and prev_logits (B, Q, 1) of the
    previous pass; tgt_masks (B, T, H, W) float {0, 1}; tgt_valid (B, T).
    The best-scoring query's mask (> 0) is compared with the union of the
    valid targets; the click lands where the error region lies deepest:
    label 1 in false-negative area, 0 in false-positive area.
    Returns (xy (B, 2) in [0, 1], labels (B,) int32, has_click (B,) bool).
    """
    b, _, h, w = prev_masks.shape
    rows = torch.arange(b, device=prev_masks.device)
    pred = prev_masks[rows, prev_logits[..., 0].argmax(1)] > 0
    gt = (tgt_masks.float() * tgt_valid[:, :, None, None]).amax(1)
    if gt.shape[-2:] != (h, w):
        gt = resize_antialiased(gt[..., None], (h, w))[..., 0]
    gt = gt > 0.5
    fn_area = gt & ~pred
    error = fn_area | (pred & ~gt)
    idx = edt_batch(error).reshape(b, -1).argmax(-1)
    y, x = idx // w, idx % w
    labels = fn_area[rows, y, x].to(torch.int32)
    xy = torch.stack([(x + 0.5) / w, (y + 0.5) / h], dim=-1).float()
    return xy, labels, error.reshape(b, -1).any(-1)


def add_click_to_prompt(prompt: Prompt, slot: int, xy, labels, has_click) -> Prompt:
    """The prompt with a click written into point slot ``slot`` of every
    sample (left as padding where the sample had no error)."""
    points, point_labels, point_mask = (
        prompt.points.clone(), prompt.point_labels.clone(), prompt.point_mask.clone())
    points[:, slot] = xy.to(points.dtype)
    point_labels[:, slot] = labels.to(point_labels.dtype)
    point_mask[:, slot] = ~has_click
    return replace(prompt, points=points, point_labels=point_labels, point_mask=point_mask)


def interactive_grounding_loss(model, images, tokens, prompt: Prompt, targets: dict, *,
                               num_interactive_steps: int = 1,
                               rng: Optional[torch.Generator] = None,
                               loss_kwargs: Optional[dict] = None):
    """The unrolled interactive forward in the model's current mode
    (training mode: the JAX ``train=True``): image and text encoded once,
    ``num_interactive_steps + 1`` grounding passes, each scored by
    ``sam3_detection_loss(out, targets, rng=rng, **loss_kwargs)`` and
    followed, but for the last, by a corrective click into the next point
    slot from the end.

    Returns (total loss, [parts of each pass])."""
    loss_kwargs = loss_kwargs or {}
    img = model.encode_image(images)
    text_memory, text_mask = model.encode_text(tokens)
    total = 0.0
    parts_per_step = []
    cur_prompt = prompt
    n_point_slots = prompt.points.shape[1]
    for step in range(num_interactive_steps + 1):
        out = model.ground(img["fpn"], img["pos"], text_memory, text_mask, cur_prompt)
        loss, parts = sam3_detection_loss(out, targets, rng=rng, **loss_kwargs)
        total = total + loss
        parts_per_step.append(parts)
        if step < num_interactive_steps:
            xy, labels, has_click = sample_correction_click(
                out["pred_masks"].detach(), out["pred_logits"].detach(),
                targets["masks"], targets["valid"])
            cur_prompt = add_click_to_prompt(cur_prompt, n_point_slots - 1 - step, xy,
                                             labels, has_click)
    return total, parts_per_step
