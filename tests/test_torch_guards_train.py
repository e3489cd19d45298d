"""No-JAX guards of the port's training paths (split from
tests/test_torch_guards.py): a Stage-3 step, the tracker's training
clip and Stage-1 distillation through Trainer, each in a fresh
interpreter that must load no jax, flax, optax or efficientsam3_tpu
module."""

import _torch_threads  # noqa: F401
from _torch_guard import run_without_jax

_TRAIN = r"""
import sys
import numpy as np
import torch
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.train.stage3 import Stage3Config, make_stage3_optimizer, stage3_train_step

model = build_efficientsam3_image_model(
    model_name="b0", embed_size=8, text_encoder_context_length=16, device="cpu",
    fusion_layers=1, decoder_layers=1)
opt = make_stage3_optimizer(Stage3Config(), model)
tokens = torch.zeros((2, 16), dtype=torch.long)
tokens[:, :3] = torch.tensor([49406, 320, 49407])
boxes = torch.tensor([[[0.5, 0.5, 0.3, 0.2], [0, 0, 0, 0]]] * 2)
batch = {"images": torch.randn(2, 64, 64, 3), "tokens": tokens, "prompt": Prompt.empty(2, 8, 8),
         "targets": {"boxes": boxes, "valid": torch.tensor([[True, False]] * 2),
                     "masks": torch.zeros(2, 2, 32, 32)}}
metrics = stage3_train_step(model, opt, batch)
assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "efficientsam3_tpu"))
print("FOREIGN", bad)
"""


_TRACKER_TRAIN = r"""
import sys
import numpy as np
import torch
import chip_smoke
from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.models.common import sine_pos_embed_2d
from efficientsam3_tpu_torch.ops.rms_norm import rms_norm_2d

image, core = build_efficientsam3_video_model(
    model_name="b0", embed_size=8, text_encoder_context_length=16, device="cpu")
core.train().requires_grad_(True)
fs, d = core.feat_size, core.d_model
with torch.no_grad():
    fpns = [image.encode_image(torch.zeros(1, 112, 112, 3))["sam2_fpn"] for _ in range(3)]
feats = [(f[2].reshape(1, fs * fs, d), f[0], f[1]) for f in fpns]
pos = sine_pos_embed_2d(fs, fs, d).reshape(fs * fs, d)
loss, outs = chip_smoke.tracker_clip(core, feats, pos, torch.ones(3, 2, 1, 4 * fs, 4 * fs), 2)
loss.backward()
assert core.memory_attention.layers[0].self_attn.q_proj.weight.grad is not None
x = torch.randn(2, 3, 5, 8, requires_grad=True)
rms_norm_2d(x, torch.ones(8), torch.zeros(8)).sum().backward()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "efficientsam3_tpu"))
print("FOREIGN", bad)
"""


_STAGE1 = r"""
import sys
import tempfile
import numpy as np
import torch
from efficientsam3_tpu_torch.build import init_parameters
from efficientsam3_tpu_torch.data.sa1b import SA1BDistillationDataset, batch_iterator
from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
from efficientsam3_tpu_torch.native import RecordStore
from efficientsam3_tpu_torch.train import stage1
from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig

teacher = init_parameters(ViTTrunk(embed_dim=64, depth=2, num_heads=1, window_size=4,
                                   global_att_blocks=(1,), pretrain_grid=4), 1)
embed = stage1.teacher_embedder(teacher)
images = np.random.default_rng(0).standard_normal((4, 112, 112, 3)).astype(np.float32)
targets = embed(images)
with tempfile.TemporaryDirectory() as tmp:
    store = tmp + "/records.bin"
    SA1BDistillationDataset.write_records(store, [1, 2, 3, 4], targets)
    assert RecordStore(store).count == 4

    class Items:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raw = RecordStore(store).read(i)
            t = np.frombuffer(raw[4:], np.float16).reshape(8, 8, 64).astype(np.float32)
            return {"image": images[i], "teacher": t, "valid": np.ones((8, 8), np.float32)}

    student = init_parameters(ViTTrunk(embed_dim=64, depth=2, num_heads=1, window_size=4,
                                       global_att_blocks=(1,), pretrain_grid=4,
                                       drop_path_rate=0.0), 2)
    opt = stage1.make_optimizer(stage1.Stage1ImageConfig(), 2, student)
    cfg = TrainerConfig(max_steps=2, checkpoint_dir=tmp + "/ckpt", handle_preemption_signals=False)
    assert Trainer(stage1.stage1_train_step, cfg).run(
        student, opt, batch_iterator(Items(), 2, seed=0)) == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "efficientsam3_tpu", "PIL"))
print("FOREIGN", bad)
"""



def test_train_step_runs_without_jax():
    """So does a tiny Stage-3 training step (model, losses, host Hungarian
    matcher, optimizer): no jax, flax, optax or efficientsam3_tpu module."""
    run_without_jax(_TRAIN)


def test_tracker_training_runs_without_jax():
    """So does the tracker's training path: a tiny 3-frame clip in training
    mode through chip_smoke.tracker_clip, its backward, and rms_norm_2d
    under autograd."""
    run_without_jax(_TRACKER_TRAIN)


def test_stage1_runs_without_jax():
    """So does Stage-1 distillation as the card drives it: a tiny ViTDet
    teacher's export (``train.stage1.teacher_embedder``) into the record
    store, and the ViT trunk trained on the records through
    ``data.sa1b.batch_iterator`` and ``Trainer`` over ``stage1_train_step``
    (checkpoints included): no jax, flax, optax or efficientsam3_tpu
    module, and no PIL (the card's machine has none; images come from
    memory)."""
    run_without_jax(_STAGE1)
