"""The ported Stage-3 training slice against the JAX package, at the tiny
config (EfficientViT b0, embed_size 8, 64x64 images, MobileCLIP-S0 at
context 16, 2 fusion and 2 decoder layers), in fp32 on the CPU.

One ``stage3_train_step`` of each package on the same variables and batch:
loss and every loss part, grad_norm, the gradients of the trunk and the
text tower, the parameters after the optimizer update, the new BatchNorm
statistics, and the frozen heads left as they were. Dropout is off on both
sides (the two frameworks draw different bits): the port builds its model
with dropout 0, and in this test only flax's ``nn.Dropout`` is replaced by
the identity. Then the port's Trainer: 2 steps with partial checkpoints,
a resumed third step equal to an uninterrupted 3-step run.

The JAX variables are drawn with numpy over ``jax.eval_shape`` shapes and
carried across by ``utils/convert.py``.
"""

import json

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from efficientsam3_tpu.build import make_student_trunk
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu.train.stage3 import Stage3Config as JConfig
from efficientsam3_tpu.train.stage3 import make_stage3_optimizer as jmake_optimizer
from efficientsam3_tpu.train.stage3 import stage3_train_step as jstage3_train_step
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.train.stage3 import (
    Stage3Config,
    make_stage3_optimizer,
    stage3_train_step,
)
from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig
from efficientsam3_tpu_torch.utils.checkpoint import assert_frozen_unchanged, latest_step
from efficientsam3_tpu_torch.utils.convert import convert_variables, load_jax_variables

CTX = 16
B, T = 2, 6
# a learning rate large enough that one AdamW step moves every trained
# parameter well past fp32 rounding (the stage-3 defaults move them by
# 2.5e-8 in the first step)
CFG = dict(vision_lr=1e-3, text_lr=1e-4, warmup_steps=1)
FROZEN = ("neck", "geometry_encoder", "fusion_encoder", "decoder", "seg_head", "scoring")


def random_variables(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf, sh = path[-1].key, s.shape
        if leaf == "var":
            a = rng.uniform(0.5, 1.5, sh)
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(sh)
        elif len(sh) == 1:
            a = 0.1 * rng.standard_normal(sh)
        elif leaf in ("embedding", "positional_embedding"):
            a = rng.standard_normal(sh) / np.sqrt(sh[-1])
        else:
            a = rng.standard_normal(sh) / np.sqrt(np.prod(sh[:-1]))
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_batch(seed=0):
    """Sample 0 has 3 objects, sample 1 one; padded to T targets with
    masks at the seg head's 32x32, as Stage3MixedDataset pads to 40 at
    288x288."""
    rng = np.random.default_rng(seed)
    images = (0.5 * rng.standard_normal((B, 64, 64, 3))).astype(np.float32)
    tokens = np.zeros((B, CTX), np.int32)
    tokens[:, :4] = [49406, 320, 1125, 49407]
    tokens[1, 2] = 3309
    boxes = np.zeros((B, T, 4), np.float32)
    valid = np.zeros((B, T), bool)
    for b, n in ((0, 3), (1, 1)):
        xy = rng.uniform(0.25, 0.75, (n, 2))
        wh = rng.uniform(0.1, 0.4, (n, 2))
        boxes[b, :n] = np.concatenate([xy, wh], -1)
        valid[b, :n] = True
    masks = np.zeros((B, T, 32, 32), np.float32)
    masks[valid] = rng.random((int(valid.sum()), 32, 32)) > 0.6
    return dict(images=images, tokens=tokens, boxes=boxes, valid=valid, masks=masks)


def torch_batch(nb):
    return {
        "images": torch.from_numpy(nb["images"]),
        "tokens": torch.from_numpy(nb["tokens"]).long(),
        "prompt": Prompt.empty(B, 8, 8),
        "targets": {"boxes": torch.from_numpy(nb["boxes"]),
                    "valid": torch.from_numpy(nb["valid"]),
                    "masks": torch.from_numpy(nb["masks"])},
    }


def build_port(variables):
    pm = build_efficientsam3_image_model(
        model_name="b0", embed_size=8, text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=CTX, device="cpu", fusion_layers=2, decoder_layers=2,
        dropout=0.0)
    return load_jax_variables(pm, variables)


@pytest.fixture(scope="module")
def jax_step():
    """(variables, batch, metrics, grads, new variables) of one JAX step."""
    jm = JModel(trunk=make_student_trunk("efficientvit", "b0", embed_size=8),
                text_encoder_type="MobileCLIP-S0", text_context_length=CTX,
                fusion_layers=2, decoder_layers=2)
    nb = make_batch()
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, 64, 64, 3)), jnp.asarray(nb["tokens"][:1]),
                            JPrompt.empty(1, 8, 8)),
        jax.random.PRNGKey(0))
    variables = random_variables(shapes)
    tx = jmake_optimizer(JConfig(**CFG), variables["params"])

    def tap_update(grads, state, params):  # hands the gradients out with the state
        updates, state = tx.update(grads, state, params)
        return updates, (state, grads)

    tap = optax.GradientTransformation(tx.init, tap_update)
    batch = {
        "images": jnp.asarray(nb["images"]), "tokens": jnp.asarray(nb["tokens"]),
        "prompt": JPrompt.empty(B, 8, 8), "rng": jax.random.PRNGKey(1),
        "targets": {"boxes": jnp.asarray(nb["boxes"]), "valid": jnp.asarray(nb["valid"]),
                    "masks": jnp.asarray(nb["masks"])},
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        step = jax.jit(lambda v, o, bt: jstage3_train_step(jm, tap, v, o, bt))
        new_vars, (_, grads), metrics = step(variables, tx.init(variables["params"]), batch)
    metrics = {k: float(v) for k, v in metrics.items()}
    return variables, nb, metrics, grads, new_vars


@pytest.fixture(scope="module")
def port_step(jax_step):
    variables = jax_step[0]
    pm = build_port(variables)
    before = {k: v.detach().clone() for k, v in pm.state_dict().items()}
    opt = make_stage3_optimizer(Stage3Config(**CFG), pm)
    captured = {}
    clip_and_update = opt.step

    def step():  # keep the gradients before the in-place clip
        captured.update({k: p.grad.clone() for k, p in pm.named_parameters()
                         if p.grad is not None})
        clip_and_update()

    opt.step = step
    metrics = stage3_train_step(pm, opt, torch_batch(jax_step[1]))
    return pm, before, {k: float(v) for k, v in metrics.items()}, captured


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - np.asarray(want)).max())


def test_step_loss_and_grad_norm_match_jax(jax_step, port_step):
    """Loss and every part within 1e-4 relative (fp32 through the whole
    model, both sides, summed in other orders: ~1e-5 seen); grad_norm
    within 1e-3 (see the gradients' test for why it moves more)."""
    want, got = jax_step[2], port_step[2]
    assert sorted(got) == sorted(want)
    assert want["loss_loss_mask"] > 0 and want["loss_loss_ce_o2m"] > 0
    for k, w in want.items():
        tol = 1e-3 if k == "grad_norm" else 1e-4
        assert abs(got[k] - w) <= tol * max(1.0, abs(w)), (k, got[k], w)


def test_step_gradients_match_jax(jax_step, port_step):
    """Trunk and text-tower gradients (before clipping), per tensor:
    ||port - jax|| <= 3e-2 ||jax|| + 1e-5 of the norm of all of them.
    fp32 itself moves them this far: ReLU / hardswish pre-activations
    within rounding of 0 land on the other side of it in another
    summation order, which changes single entries of a layer's local
    gradient, and that spreads upstream (the port in fp32 against the same
    port in fp64 differs by as much); the second term covers BatchNorm biases whose exact gradient is 0 (a
    BatchNorm in training mode follows them), where both sides hold
    rounding noise."""
    want = convert_variables({"params": jax_step[3]})
    got = port_step[3]
    trained = [k for k in want if k.split(".")[0] in ("trunk", "text_encoder")]
    assert len(trained) > 100
    total = np.sqrt(sum(np.square(want[k], dtype=np.float64).sum() for k in trained))
    for k in trained:
        g = got.get(k, torch.zeros(want[k].shape)).numpy()
        err = np.linalg.norm(g - want[k])
        assert err <= 3e-2 * np.linalg.norm(want[k]) + 1e-5 * total, k


def test_step_updates_match_jax(jax_step, port_step):
    """The port's step left the frozen heads bit-identical, moved the
    trained parameters, and updated the BatchNorm running statistics as
    flax does (momentum 0.9, biased variance; within 1e-5 relative). The
    optimizer on its own: given the JAX step's gradients, the port's
    per-group clip + AdamW + schedule gives JAX's updated parameters
    within two fp32 ulps of the parameter plus 1e-3 of the learning rate
    (Adam divides each gradient by its own magnitude, so the step's
    gradients, which differ by fp32 noise, are not compared this way)."""
    variables, grads, new_vars = jax_step[0], jax_step[3], jax_step[4]
    pm, before = port_step[0], port_step[1]
    sd = pm.state_dict()
    assert_frozen_unchanged(before, sd, FROZEN)
    old = convert_variables({"params": variables["params"]})
    new = convert_variables({"params": new_vars["params"]})
    moved = [float((sd[k] != before[k]).float().mean()) for k in new
             if k.split(".")[0] not in FROZEN]
    assert min(moved) > 0.9
    stats = convert_variables({"batch_stats": new_vars["batch_stats"]})
    assert len(stats) > 50
    for k, w in stats.items():
        assert not np.allclose(w, before[k].numpy()), k
        assert _err(sd[k], w) <= 1e-5 * max(1.0, np.abs(w).max()), k

    fresh = build_port(variables)
    opt = make_stage3_optimizer(Stage3Config(**CFG), fresh)
    jgrads = convert_variables({"params": grads})
    for k, p in fresh.named_parameters():
        p.grad = torch.tensor(jgrads[k])
    opt.step()
    for k, p in fresh.named_parameters():
        top = k.split(".")[0]
        if top in FROZEN:
            assert np.array_equal(p.detach().numpy(), new[k]), k
            continue
        lr = CFG["vision_lr"] if top == "trunk" else CFG["text_lr"]
        tol = 2 * np.spacing(np.abs(new[k]).astype(np.float32)) + 1e-3 * lr
        assert (np.abs(p.detach().numpy() - new[k]) <= tol).all(), k


def test_trainer_checkpoints_and_resumes(jax_step, tmp_path):
    """Two Trainer steps with partial checkpoints of the trunk and text
    tower, then a fresh model resumes from step 2 and takes step 3: its
    parameters, statistics and metrics log equal those of an
    uninterrupted 3-step run."""
    variables, nb = jax_step[0], jax_step[1]
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


@pytest.mark.parametrize("step", [None, 0, 7, 2**40])
def test_tensorboard_events_match_jax(step):
    """The hand-written TensorBoard encoder writes the JAX package's bytes:
    the Event payload and its masked CRC32-C framing."""
    from efficientsam3_tpu.utils import observability as jobs
    from efficientsam3_tpu_torch.utils import observability as tobs

    scalars = {"loss": 1.25, "grad_norm": 3e5, "loss_loss_ce_aux_0_o2m": -0.5}
    for kw in (dict(step=step, scalars=scalars), dict(file_version=True)):
        want = jobs.TensorBoardWriter._event(wall_time=1700000000.5, **kw)
        got = tobs.TensorBoardWriter._event(wall_time=1700000000.5, **kw)
        assert got == want
        assert tobs._masked_crc(got) == jobs._masked_crc(want)


@pytest.mark.parametrize("schedule", ["inverse_sqrt", "cosine"])
@pytest.mark.parametrize("base_lr,warmup,horizon", [(2.5e-5, 1000, 10000), (1e-3, 3, 7)])
def test_schedules_match_jax(schedule, base_lr, warmup, horizon):
    """Both learning-rate schedules against the JAX ones over counts from 0
    (the first update's) past the warm-up and the horizon; 1e-6 relative
    (JAX evaluates in fp32, the port in Python floats)."""
    from efficientsam3_tpu.train import stage3 as jstage3
    from efficientsam3_tpu_torch.train import stage3 as tstage3

    name = f"{schedule}_schedule"
    jfn = getattr(jstage3, name)(base_lr, warmup, horizon)
    tfn = getattr(tstage3, name)(base_lr, warmup, horizon)
    for count in sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, horizon - 1, horizon,
                         horizon + 5, 3 * horizon}):
        want = float(jfn(count))
        assert abs(tfn(count) - want) <= 1e-6 * abs(want) + 1e-12, (count, tfn(count), want)
