"""Each ported entry point takes the JAX script's command-line flags, with
the same names and defaults, plus ``--device`` (default ``cuda``). Both
sides are read with ``ast`` from the sources (``scripts/*.py`` and
``efficientsam3_tpu_torch/scripts/*.py``): nothing is imported or run."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("train_overfit_quality", "eval_quality", "standalone_cgf1", "train_stage3",
           "verify_checkpoint", "save_embedding_image_stage1", "train_image_encoder_stage1",
           "eval_coco", "eval_video", "data_engine")


def flags(path: Path) -> dict:
    """{option: ast dump of its default (None when it has none)} of every
    ``add_argument`` call in the file (positional arguments included)."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            default = kw.get("default")
            if default is None and isinstance(kw.get("action"), ast.Constant):
                default = ast.Constant(kw["action"].value)  # store_true and friends
            out[node.args[0].value] = None if default is None else ast.dump(default)
    return out


@pytest.mark.parametrize("name", SCRIPTS)
def test_flags_are_the_jax_scripts_plus_device(name):
    want = flags(ROOT / "scripts" / f"{name}.py")
    got = flags(ROOT / "efficientsam3_tpu_torch" / "scripts" / f"{name}.py")
    assert want, name
    # the device flag lives in a shared helper: every script calls it
    src = (ROOT / "efficientsam3_tpu_torch" / "scripts" / f"{name}.py").read_text()
    assert "add_device_flag(ap)" in src
    assert flags(ROOT / "efficientsam3_tpu_torch" / "scripts" / "_common.py") == {
        "--device": ast.dump(ast.Constant("cuda"))}
    assert got == want
