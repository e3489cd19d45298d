"""The port's Trainer over the tiny Stage-3 step (the configuration of
tests/test_torch_train_slice.py, whose helpers it uses): 2 steps with
partial checkpoints, then a fresh model resumed from step 2 takes step 3,
equal to an uninterrupted 3-step run. Only the seeded variables come from
the JAX package (``jax.eval_shape`` shapes); no JAX step runs."""

import json

import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.build import make_student_trunk
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu_torch.train.stage3 import (
    Stage3Config,
    make_stage3_optimizer,
    stage3_train_step,
)
from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig
from efficientsam3_tpu_torch.utils.checkpoint import latest_step
from test_torch_train_slice import CFG, CTX, build_port, make_batch, random_variables, torch_batch


@pytest.fixture(scope="module")
def variables():
    jm = JModel(trunk=make_student_trunk("efficientvit", "b0", embed_size=8),
                text_encoder_type="MobileCLIP-S0", text_context_length=CTX,
                fusion_layers=2, decoder_layers=2)
    tokens = jnp.asarray(make_batch()["tokens"][:1])
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, 64, 64, 3)), tokens, JPrompt.empty(1, 8, 8)),
        jax.random.PRNGKey(0))
    return random_variables(shapes)


def test_trainer_checkpoints_and_resumes(variables, tmp_path):
    """Two Trainer steps with partial checkpoints of the trunk and text
    tower, then a fresh model resumes from step 2 and takes step 3: its
    parameters, statistics and metrics log equal those of an
    uninterrupted 3-step run."""
    batches = [torch_batch(make_batch(seed)) for seed in (1, 2, 3)]

    def trainer(steps, ckpt, log_dir=None):
        return Trainer(stage3_train_step, TrainerConfig(
            max_steps=steps, log_every=1, checkpoint_every=1, checkpoint_dir=str(ckpt),
            save_param_prefixes=("trunk", "text_encoder"), log_dir=log_dir,
            handle_preemption_signals=False))

    straight = build_port(variables)
    opt = make_stage3_optimizer(Stage3Config(**CFG), straight)
    assert trainer(3, tmp_path / "a").run(straight, opt, iter(batches)) == 3

    first = build_port(variables)
    opt = make_stage3_optimizer(Stage3Config(**CFG), first)
    logs = tmp_path / "logs"
    assert trainer(2, tmp_path / "b", str(logs)).run(first, opt, iter(batches)) == 2
    assert latest_step(tmp_path / "b") == 2
    saved = torch.load(tmp_path / "b" / "step_2" / "state.pt", weights_only=True)
    assert {k.split(".")[0] for k in saved["params"]} == {"trunk", "text_encoder"}
    lines = (logs / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    assert any(p.name.startswith("events.out.tfevents") for p in logs.iterdir())

    resumed = build_port(variables)
    opt = make_stage3_optimizer(Stage3Config(**CFG), resumed)
    assert trainer(3, tmp_path / "b").run(resumed, opt, iter(batches[2:])) == 3
    assert opt.count == 3
    want = straight.state_dict()
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, want[k]), k
