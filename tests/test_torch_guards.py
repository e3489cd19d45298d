"""Guards of the PyTorch port: it never imports JAX or the JAX package,
its entry points refuse to run on a CUDA device that is not there, and
its processor needs the BPE vocab only for string prompts. The no-JAX
drives of the inference paths and of the multi-GPU layer run here;
training's are in tests/test_torch_guards_train.py and
test_torch_guards_text.py, video PCS's in test_torch_guards_video.py."""

import ast
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from _torch_guard import ROOT, run_without_jax

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


_PARALLEL = r"""
import sys
import tempfile
import numpy as np
import torch
import torch.distributed as dist
from efficientsam3_tpu_torch import parallel
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model, build_efficientsam3_video_model
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.train import stage1
from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig
from efficientsam3_tpu_torch.utils import checkpoint, convert_backbones, convert_model, torch_convert
from efficientsam3_tpu_torch.video.predictor import TrackerPredictor

tmp = tempfile.TemporaryDirectory()
dist.init_process_group("gloo", init_method="file://" + tmp.name + "/rdzv", rank=0, world_size=1)
cfg = stage1.Stage1ImageConfig(backbone_type="efficientvit", model_name="b0", embed_dim=32,
                               embed_size=4, image_size=64)
student = stage1.make_student(cfg)
torch.manual_seed(0)
for p in student.parameters():
    torch.nn.init.normal_(p, std=0.05)
opt = stage1.make_optimizer(cfg, 2, student)
rng = np.random.default_rng(0)
batch = {"image": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
         "teacher": rng.standard_normal((2, 4, 4, 32)).astype(np.float32),
         "valid": np.ones((2, 4, 4), np.float32)}
trainer = Trainer(stage1.stage1_train_step, TrainerConfig(
    max_steps=1, mesh=parallel.make_mesh({"dp": 1}), handle_preemption_signals=False))
assert trainer.run(student, opt, iter([batch])) == 1
det = build_efficientsam3_image_model(model_name="b0", embed_size=8, text_encoder_context_length=16,
                                      device="cpu", fusion_layers=1, decoder_layers=1)
spec = parallel.tp_param_spec(det)
parallel.shard_params(det, parallel.make_mesh({"tp": 1}), spec)
assert parallel.count_sharded(spec) == 17 + 24
detect = parallel.frame_parallel(
    lambda f, t: det(f, t.expand(f.shape[0], -1), Prompt.empty(f.shape[0], 2, 2)),
    parallel.make_mesh({"frames": 1}))
with torch.no_grad():
    out = detect(torch.zeros(2, 64, 64, 3), torch.zeros(1, 16, dtype=torch.long))
assert out["pred_logits"].shape == (2, 200, 1)
image, core = build_efficientsam3_video_model(model_name="b0", embed_size=8,
                                              text_encoder_context_length=16, device="cpu")
pred = TrackerPredictor(core, image.encode_image, obj_slots=2, max_point_prompts=4,
                        mesh=parallel.make_mesh({"objects": 1}))
state = pred.init_state(np.zeros((3, 112, 112, 3), np.float32))
pred.add_new_points_or_box(state, 0, obj_id=1, points=[[40, 50]], labels=[1])
assert [tuple(m.shape) for _, _, m in pred.propagate_in_video(state)] == [(1, 1, 32, 32)] * 3
assert callable(checkpoint.load_reference_checkpoint) and convert_model.convert_image_model
dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "efficientsam3_tpu", "PIL"))
print("FOREIGN", bad)
"""


def test_slice_runs_without_jax():
    """The tiny grounding slice on the CPU leaves no jax, flax or
    efficientsam3_tpu module in sys.modules (matched by top-level name, so
    the port's own efficientsam3_tpu_torch does not count)."""
    run_without_jax(_SLICE)


def test_tracker_slice_runs_without_jax():
    """So does the tiny video tracker: build_efficientsam3_video_model and
    TrackerPredictor over 3 frames."""
    run_without_jax(_TRACKER)


def test_eval_and_agent_run_without_jax():
    """So do the evaluation stack and the agent: the 19 modules of the slice
    imported, the oracle through the gold harness and cgF1, postprocess_image
    over tensors, the shard at world size 1, a tool-loop session and a config
    load: no jax, flax, optax, efficientsam3_tpu, PIL or matplotlib module
    (the card's machine has no matplotlib)."""
    run_without_jax(_EVAL)


def test_teacher_runs_without_jax():
    """So do the SAM3 teacher's modules (ViTDet trunk, CLIP text tower) at a
    tiny config: the image model with the SAM2 neck through Sam3Processor,
    and the tracker over its frame features for 3 frames."""
    run_without_jax(_TEACHER)


def test_parallel_and_converters_run_without_jax():
    """So does the multi-GPU layer on a gloo group of one: Trainer(mesh=...)
    over a Stage-1 step (data parallel), shard_params and frame_parallel
    on a tiny detector, TrackerPredictor(mesh=...) over 3 frames (object
    parallel), and the reference-checkpoint converters imported: no jax,
    flax, optax, efficientsam3_tpu or PIL module."""
    run_without_jax(_PARALLEL)


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


def _mesh(**axes):
    """A stand-in for a DeviceMesh where no process group is needed: its
    axis names and sizes."""
    return SimpleNamespace(mesh_dim_names=tuple(axes), size=lambda i: list(axes.values())[i])


def test_trainer_mesh_needs_its_batch_axis():
    """Trainer takes a mesh (data parallelism over its 'dp' axis, run on
    gloo ranks in tests/test_torch_parallel.py); one without the batch
    axis raises."""
    from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig

    Trainer(None, TrainerConfig(max_steps=1, mesh=_mesh(dp=2), handle_preemption_signals=False))
    with pytest.raises(ValueError, match="batch axis 'dp' not in"):
        Trainer(None, TrainerConfig(max_steps=1, mesh=_mesh(tp=2),
                                    handle_preemption_signals=False))


@pytest.mark.parametrize("slots", [3, 4])
def test_tracker_mesh_must_divide_the_slots(slots):
    """TrackerPredictor(mesh=...) splits its object slots over the mesh's
    'objects' axis, which must divide them (JAX's ValueError); under a mesh
    the cached bank is off."""
    from efficientsam3_tpu_torch.video.predictor import TrackerPredictor
    from efficientsam3_tpu_torch.video.tracker import TrackerCore

    core = TrackerCore(image_size=64, backbone_stride=8, d_model=32, mem_dim=8)
    if slots % 2:
        with pytest.raises(ValueError, match="obj_slots=3 not divisible by mesh axis objects=2"):
            TrackerPredictor(core, None, obj_slots=slots, mesh=_mesh(objects=2))
    else:
        assert not TrackerPredictor(core, None, obj_slots=slots, mesh=_mesh(objects=2)).cache_kv


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "efficientsam3_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(ROOT / "efficientsam3_tpu_torch")) for f in files[:-1]}
    assert {"parallel/__init__.py", "parallel/launch.py", "parallel/sharding.py",
            "parallel/tensor_parallel.py", "utils/torch_convert.py",
            "utils/convert_backbones.py", "utils/convert_model.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "efficientsam3_tpu"), (f, mod)


SCRIPTS = ("train_overfit_quality", "eval_quality", "standalone_cgf1", "train_stage3",
           "verify_checkpoint", "save_embedding_image_stage1", "train_image_encoder_stage1",
           "eval_coco", "eval_video", "data_engine")
EXAMPLES = ("image_predictor_example", "batch_processor_example", "sam1_task_example",
            "edge_sam_example", "video_tracking_example", "video_pcs_example", "agent_example")

_ENTRY_POINTS = r"""
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "efficientsam3_tpu"))
print("FOREIGN", bad)
"""


def test_entry_points_import_neither_jax_nor_the_jax_package():
    """Every ported script and example loads without JAX, flax, optax or
    the JAX package (what each imports when imported, not only what its
    source names)."""
    import subprocess
    import sys

    from _torch_guard import THREADS

    assert {p.stem for p in (ROOT / "efficientsam3_tpu_torch" / "scripts").glob("*.py")} == {
        *SCRIPTS, "__init__", "_common"}
    assert {p.stem for p in (ROOT / "efficientsam3_tpu_torch" / "examples").glob("*.py")} == {
        *EXAMPLES, "__init__"}
    assert {p.stem for p in (ROOT / "examples").glob("*.py")} == set(EXAMPLES)
    modules = ([f"efficientsam3_tpu_torch.scripts.{n}" for n in SCRIPTS]
               + [f"efficientsam3_tpu_torch.examples.{n}" for n in EXAMPLES])
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=str(THREADS))
    out = subprocess.run([sys.executable, "-c", _ENTRY_POINTS, *modules], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout[-2000:]


def _entry_argv(name):
    """Arguments that parse (the files need not exist: the device is
    checked first)."""
    return {"standalone_cgf1": ["--pred_file", "p.json", "--gt_files", "g.json"],
            "train_stage3": ["--sources", "s.json"],
            "save_embedding_image_stage1": ["--images-dir", "d", "--store", "s"],
            "train_image_encoder_stage1": ["--images-dir", "d", "--store", "s"],
            "eval_coco": ["--ann", "a.json", "--images-dir", "d"],
            "eval_video": ["--dataset", "v.json"],
            "data_engine": ["--ann", "a.json", "--image-root", "d"],
            "video_pcs_example": ["frames"]}.get(name, [])


@pytest.mark.parametrize("name", SCRIPTS + EXAMPLES)
def test_entry_points_default_to_cuda(name, tmp_path, monkeypatch):
    """Each entry point's --device defaults to cuda and, without a card,
    raises before it reads a file or builds a model on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run there")
    import importlib

    kind = "scripts" if name in SCRIPTS else "examples"
    mod = importlib.import_module(f"efficientsam3_tpu_torch.{kind}.{name}")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(_entry_argv(name))
    assert not any(tmp_path.iterdir())


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
