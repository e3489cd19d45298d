"""Guards of the PyTorch port: it never imports JAX or the JAX package,
its entry points refuse to run on a CUDA device that is not there, and
its processor needs the BPE vocab only for string prompts."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_SLICE = r"""
import sys
import numpy as np
import torch
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.processor import Sam3Processor

model = build_efficientsam3_image_model(
    model_name="b0", embed_size=8, text_encoder_type="MobileCLIP-S0",
    text_encoder_context_length=16, device="cpu", fusion_layers=2, decoder_layers=2)
proc = Sam3Processor(model, resolution=64, confidence_threshold=0.0, context_length=16)
state = proc.set_image(np.zeros((40, 56, 3), np.uint8))
tokens = np.zeros((1, 16), np.int64)
tokens[0, :3] = [49406, 320, 49407]
state["text"] = proc.encode_tokens(tokens)
state = proc.add_geometric_prompt([0.5, 0.5, 0.4, 0.4], True, state)
assert state["masks"].shape == (200, 40, 56), state["masks"].shape
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "efficientsam3_tpu"))
print("FOREIGN", bad)
"""


_TRACKER = r"""
import sys
import numpy as np
from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.video.predictor import TrackerPredictor

image, core = build_efficientsam3_video_model(
    model_name="b0", embed_size=8, text_encoder_context_length=16, device="cpu")
pred = TrackerPredictor(core, image.encode_image, obj_slots=2, max_point_prompts=4)
state = pred.init_state(np.zeros((3, 112, 112, 3), np.float32))
pred.add_new_points_or_box(state, 0, obj_id=5, points=[[40, 50]], labels=[1])
shapes = [tuple(m.shape) for _, _, m in pred.propagate_in_video(state)]
assert shapes == [(1, 1, 32, 32)] * 3, shapes
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "efficientsam3_tpu"))
print("FOREIGN", bad)
"""


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


_PCS = r"""
import sys
import numpy as np
from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
from efficientsam3_tpu_torch.system import EfficientSam3System
from efficientsam3_tpu_torch.video.pipeline import VideoPCSConfig

image, core = build_efficientsam3_video_model(
    model_name="b0", embed_size=8, text_encoder_context_length=16, device="cpu")
system = EfficientSam3System(image, core)
proc = system.processor()
tokens = np.zeros((1, 16), np.int64)
tokens[0, :3] = [49406, 320, 49407]
pipe = system.video_predictor(VideoPCSConfig(obj_slots=2, hotstart_delay=2), obj_slots=2,
                              max_point_prompts=4, quantize_bank=True)
frames = np.zeros((3, 112, 112, 3), np.float32)
outs = list(pipe.run_video(frames, {"text": proc.encode_tokens(tokens)}))
assert [o["frame_idx"] for o in outs] == [0, 1, 2], outs
server = system.server(obj_slots=2, max_point_prompts=4, fill_hole_area=8)
sid = server.start_session(frames)
server.add_points(sid, 0, 1, points=[[40, 50]], labels=[1])
assert [r["masks"].shape for r in server.propagate_in_video(sid)] == [(1, 1, 32, 32)] * 3
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "efficientsam3_tpu"))
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


_EVAL = r"""
import importlib
import sys
import numpy as np
import torch

MODULES = ["config", "utils.visualization"] + [f"eval.{m}" for m in (
    "jf_metric", "hota", "teta", "cgf1", "coco_map", "fixtures", "postprocess", "gold",
    "eval_coco", "video_eval", "distributed")] + [f"agent.{m}" for m in (
    "som", "zoom_in", "viz", "system_prompts", "core")] + ["agent"]
mods = {m: importlib.import_module("efficientsam3_tpu_torch." + m) for m in MODULES}
fx, gold = mods["eval.fixtures"], mods["eval.gold"]
images, gt, _ = fx.make_shapes_fixture(num_images=3, size=64, seed=3)
records = gold.run_gold_inference(fx.oracle_predict_fn(images, gt), gt,
                                  lambda info: images[info["image_index"]])
assert gold.evaluate_cgf1_files(records, [gt])["cgF1"] > 0.95
outputs = {"pred_logits": torch.randn(1, 6, 1), "pred_boxes": torch.rand(1, 6, 4),
           "pred_masks": torch.randn(1, 6, 8, 8), "presence_logit_dec": torch.zeros(1)}
assert len(mods["eval.postprocess"].postprocess_image(outputs, 0, orig_hw=(20, 12))) == 6
assert mods["eval.distributed"].shard_for_process([1, 2, 3]) == [1, 2, 3]
img = np.zeros((32, 40, 3), np.uint8)
mask = np.zeros((32, 40), bool)
mask[4:12, 6:20] = True

def segment(phrase):
    return {"scores": np.asarray([0.8]), "masks": mask[None], "boxes": np.asarray([[6, 4, 20, 12]])}

def llm(messages):
    if "verification" in messages[0]["content"]:
        return "<verdict>Accept</verdict>"
    last = [c["text"] for m in messages if isinstance(m.get("content"), list)
            for c in m["content"] if isinstance(c, dict) and c.get("type") == "text"][-1]
    if "user query is" in last:
        return '<tool>{"name": "segment_phrase", "parameters": {"text_prompt": "a box"}}</tool>'
    if "segment_phrase produced" in last:
        return '<tool>{"name": "examine_each_mask", "parameters": {}}</tool>'
    return '<tool>{"name": "select_masks_and_return", "parameters": {"final_answer_masks": [1]}}</tool>'

_, final, rendered = mods["agent"].agent_inference(img, "the box", llm, segment=segment)
assert len(final["masks"]) == 1 and rendered.shape == img.shape
cfg = mods["config"].load_config(mods["config"].TrainConfig, overrides=["model.embed_size=8"])
assert cfg.model.embed_size == 8
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "efficientsam3_tpu", "PIL", "matplotlib"))
print("FOREIGN", bad)
"""


_TEACHER = r"""
import sys
import numpy as np
from efficientsam3_tpu_torch.build import init_parameters
from efficientsam3_tpu_torch.models.sam3_image import Sam3ImageModel
from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
from efficientsam3_tpu_torch.processor import Sam3Processor
from efficientsam3_tpu_torch.video.predictor import TrackerPredictor
from efficientsam3_tpu_torch.video.tracker import TrackerCore, init_tracker_parameters

trunk = ViTTrunk(embed_dim=128, depth=2, num_heads=2, window_size=4, global_att_blocks=(1,),
                 pretrain_grid=4)
image = init_parameters(Sam3ImageModel(
    trunk, text_encoder_type=None, text_context_length=16, add_sam2_neck=True, fusion_layers=1,
    decoder_layers=1, trunk_dim=128, text_tower=dict(width=64, heads=4, layers=1))).eval()
core = init_tracker_parameters(TrackerCore(image_size=112, backbone_stride=14)).eval()
proc = Sam3Processor(image, resolution=112, confidence_threshold=0.0, context_length=16)
state = proc.set_image(np.zeros((40, 56, 3), np.uint8))
tokens = np.zeros((1, 16), np.int64)
tokens[0, :3] = [49406, 320, 49407]
state["text"] = proc.encode_tokens(tokens)
state = proc.add_geometric_prompt([0.5, 0.5, 0.4, 0.4], True, state)
assert state["masks"].shape == (200, 40, 56), state["masks"].shape
pred = TrackerPredictor(core, image.encode_image, obj_slots=2, max_point_prompts=4)
vstate = pred.init_state(np.zeros((3, 112, 112, 3), np.float32))
pred.add_new_points_or_box(vstate, 0, obj_id=5, points=[[40, 50]], labels=[1])
shapes = [tuple(m.shape) for _, _, m in pred.propagate_in_video(vstate)]
assert shapes == [(1, 1, 32, 32)] * 3, shapes
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


def _run_without_jax(script):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout[-2000:]


def test_slice_runs_without_jax():
    """The tiny grounding slice on the CPU leaves no jax, flax or
    efficientsam3_tpu module in sys.modules (matched by top-level name, so
    the port's own efficientsam3_tpu_torch does not count)."""
    _run_without_jax(_SLICE)


def test_tracker_slice_runs_without_jax():
    """So does the tiny video tracker: build_efficientsam3_video_model and
    TrackerPredictor over 3 frames."""
    _run_without_jax(_TRACKER)


def test_video_pcs_runs_without_jax():
    """So do the system handle, the video PCS pipeline over the real
    detector (int8 bank) and the session server (hole filling on)."""
    _run_without_jax(_PCS)


def test_train_step_runs_without_jax():
    """So does a tiny Stage-3 training step (model, losses, host Hungarian
    matcher, optimizer): no jax, flax, optax or efficientsam3_tpu module."""
    _run_without_jax(_TRAIN)


def test_tracker_training_runs_without_jax():
    """So does the tracker's training path: a tiny 3-frame clip in training
    mode through chip_smoke.tracker_clip, its backward, and rms_norm_2d
    under autograd."""
    _run_without_jax(_TRACKER_TRAIN)


def test_stage1_runs_without_jax():
    """So does Stage-1 distillation as the card drives it: a tiny ViTDet
    teacher's export (``train.stage1.teacher_embedder``) into the record
    store, and the ViT trunk trained on the records through
    ``data.sa1b.batch_iterator`` and ``Trainer`` over ``stage1_train_step``
    (checkpoints included): no jax, flax, optax or efficientsam3_tpu
    module, and no PIL (the card's machine has none; images come from
    memory)."""
    _run_without_jax(_STAGE1)


def test_text_towers_and_training_run_without_jax():
    """So do the slice of the text towers and the rest of training: a
    MobileCLIP-B student's Stage-1 text step, a geometry finetune step and
    a two-pass interactive loss (PointRend-sampled masks) over a
    MobileCLIP2-S0 model, the association head's step, and the data copies
    (the EDT click): no jax, flax, optax, efficientsam3_tpu or PIL module."""
    _run_without_jax(_SLICE22)


def test_eval_and_agent_run_without_jax():
    """So do the evaluation stack and the agent: the 19 modules of the slice
    imported, the oracle through the gold harness and cgF1, postprocess_image
    over tensors, the shard at world size 1, a tool-loop session and a config
    load: no jax, flax, optax, efficientsam3_tpu, PIL or matplotlib module
    (the card's machine has no matplotlib)."""
    _run_without_jax(_EVAL)


def test_teacher_runs_without_jax():
    """So do the SAM3 teacher's modules (ViTDet trunk, CLIP text tower) at a
    tiny config: the image model with the SAM2 neck through Sam3Processor,
    and the tracker over its frame features for 3 frames."""
    _run_without_jax(_TEACHER)


def test_refuse_grad_only_when_autograd_records():
    """The forward-only kernels' guard: it raises when grad mode is on and
    an input requires a gradient, and lets no_grad and gradient-free calls
    through (on the CPU the wrappers take their differentiable plain
    versions and never reach it; tests/test_torch_cuda.py holds the
    wrappers themselves on the card)."""
    from efficientsam3_tpu_torch.ops import _build

    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        _build.refuse_grad("k", x, None)
    with torch.no_grad():
        _build.refuse_grad("k", x)
    _build.refuse_grad("k", torch.zeros(3), None)
    assert _build.needs_grad(None, x) and not _build.needs_grad(torch.zeros(3))


def test_unported_training_options_raise():
    from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig

    with pytest.raises(NotImplementedError, match="Queue 1 item 19"):
        Trainer(None, TrainerConfig(max_steps=1, mesh=object()))
    from efficientsam3_tpu_torch.video.predictor import TrackerPredictor
    from efficientsam3_tpu_torch.video.tracker import TrackerCore

    core = TrackerCore(image_size=64, backbone_stride=8, d_model=32, mem_dim=8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 19"):
        TrackerPredictor(core, None, mesh=object())


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "efficientsam3_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "efficientsam3_tpu"), (f, mod)


def test_cuda_entry_points_raise_without_a_gpu():
    """The default device is cuda; without one, entry points raise instead
    of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run there")
    from efficientsam3_tpu_torch.build import (
        build_efficientsam3_image_model,
        build_efficientsam3_video_model,
    )
    from efficientsam3_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_efficientsam3_image_model(model_name="b0", embed_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_efficientsam3_video_model(model_name="b0", embed_size=8)
    assert resolve_device("cpu") == torch.device("cpu")


def test_teacher_builders_raise_without_a_gpu():
    """The SAM3 teacher's builders default to cuda too, and raise without a
    card before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run there")
    from efficientsam3_tpu_torch.build import build_sam3_image_model, build_sam3_video_model

    with pytest.raises(RuntimeError, match="CUDA"):
        build_sam3_image_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sam3_video_model()


@pytest.mark.parametrize("option,item", [(dict(mesh=object()), "Queue 1 item 19")])
def test_unported_tracker_options_raise(option, item):
    from efficientsam3_tpu_torch.video.predictor import TrackerPredictor
    from efficientsam3_tpu_torch.video.tracker import TrackerCore

    core = TrackerCore(image_size=64, backbone_stride=8, d_model=32, mem_dim=8)
    with pytest.raises(NotImplementedError, match=item):
        TrackerPredictor(core, None, **option)


def test_tokenizer_is_built_on_first_string_prompt(monkeypatch):
    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.processor import Sam3Processor

    monkeypatch.delenv("EFFICIENTSAM3_BPE_PATH", raising=False)
    model = build_efficientsam3_image_model(
        model_name="b0", embed_size=8, text_encoder_context_length=16, device="cpu",
        fusion_layers=1, decoder_layers=1)
    proc = Sam3Processor(model, resolution=64, bpe_path=None)
    state = proc.set_image(np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(FileNotFoundError, match="BPE"):
        proc.set_text_prompt("a cat", state)


@pytest.mark.parametrize("backbone,name", [("repvit", "m1.1"), ("efficientvit", "b2")])
def test_unported_backbones_raise(backbone, name):
    """A variant or a backbone the port's registry lacks raises."""
    from efficientsam3_tpu_torch.build import make_student_trunk

    with pytest.raises(KeyError):
        make_student_trunk(backbone, "x9")
    with pytest.raises(KeyError):
        make_student_trunk("mobilenet", name)
