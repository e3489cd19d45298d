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


def test_slice_runs_without_jax():
    """The tiny slice on the CPU leaves no jax, flax or efficientsam3_tpu
    module in sys.modules (matched by top-level name, so the port's own
    efficientsam3_tpu_torch does not count)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _SLICE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout[-2000:]


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
    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_efficientsam3_image_model(model_name="b0", embed_size=8)
    assert resolve_device("cpu") == torch.device("cpu")


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
    from efficientsam3_tpu_torch.build import make_student_trunk

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_student_trunk(backbone, name)
