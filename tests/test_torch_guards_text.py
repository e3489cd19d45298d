"""No-JAX guard of the port's text towers and the rest of training (split
from tests/test_torch_guards.py), in a fresh interpreter."""

import _torch_threads  # noqa: F401
from _torch_guard import run_without_jax

_SLICE22 = r"""
import sys
import numpy as np
import torch
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model, init_parameters
from efficientsam3_tpu_torch.data import engine, stage3_mixed, transforms
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.models.mobile_clip import TextStudentEncoder
from efficientsam3_tpu_torch.train import geometry_finetune as gf
from efficientsam3_tpu_torch.train import interactive, stage1_text, video_assoc

tok = torch.zeros((2, 16), dtype=torch.long)
tok[:, :4] = torch.tensor([49406, 320, 1125, 49407])
cfg = stage1_text.Stage1TextConfig(backbone_type="MobileCLIP-B", context_length=16)
student = init_parameters(stage1_text.make_text_student(cfg))
opt = stage1_text.make_text_optimizer(cfg, student)
m = stage1_text.stage1_text_train_step(student, opt, cfg, {
    "tokens": tok, "tokens_perm": tok.flip(1), "teacher": torch.randn(2, 16, 256),
    "teacher_perm": torch.randn(2, 16, 256)})
assert np.isfinite(float(m["loss"]))
model = build_efficientsam3_image_model(
    model_name="b0", embed_size=8, text_encoder_type="MobileCLIP2-S0",
    text_encoder_context_length=16, device="cpu", fusion_layers=1, decoder_layers=1)
gcfg = gf.GeometryFinetuneConfig()
gopt = gf.make_geometry_optimizer(gcfg, model)
prompt = Prompt.empty(2, 2, 2).with_box(0, 0, [0.5, 0.5, 0.3, 0.3])
m = gf.geometry_finetune_step(model, gopt, gcfg, {
    "images": torch.randn(2, 112, 112, 3), "tokens": tok, "prompt": prompt,
    "teacher_embed": torch.randn(2, 8, 8, 1024), "valid": torch.ones(2, 8, 8),
    "teacher_mask": torch.zeros(2, 48, 48)})
assert np.isfinite(float(m["loss"]))
model.train().requires_grad_(True)
targets = {"boxes": torch.tensor([[[0.5, 0.5, 0.3, 0.3]]] * 2), "valid": torch.ones(2, 1, dtype=torch.bool),
           "masks": torch.ones(2, 1, 32, 32)}
loss, parts = interactive.interactive_grounding_loss(
    model, torch.randn(2, 112, 112, 3), tok, prompt, targets,
    loss_kwargs={"num_sample_points": 16}, rng=torch.Generator().manual_seed(0))
loss.backward()
assert len(parts) == 2
head = init_parameters(video_assoc.AssocHead(32))
step = video_assoc.assoc_train_step(head, torch.optim.Adam(head.parameters(), 1e-3))
assert np.isfinite(float(step(video_assoc.FramePairDataset(d_model=32).batch(2))))
assert transforms.center_positive_sample(np.ones((9, 9), bool), 2).shape == (2, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "efficientsam3_tpu", "PIL"))
print("FOREIGN", bad)
"""



def test_text_towers_and_training_run_without_jax():
    """So do the slice of the text towers and the rest of training: a
    MobileCLIP-B student's Stage-1 text step, a geometry finetune step and
    a two-pass interactive loss (PointRend-sampled masks) over a
    MobileCLIP2-S0 model, the association head's step, and the data copies
    (the EDT click): no jax, flax, optax, efficientsam3_tpu or PIL module."""
    run_without_jax(_SLICE22)
