"""The port's Stage-1 geometry-aware finetune against the JAX package's, at
the tiny config (EfficientViT b0, embed_size 8, 112x112 images,
MobileCLIP-S0 at context 16, 2 fusion and 2 decoder layers) in fp32 on the
CPU: one ``geometry_finetune_step`` of each on the same variables and
batch (box prompts from the ground truth, a 48x48 teacher mask resized to
the 32x32 mask grid). The loss parts, the trunk's gradient (both passes),
the trunk's BatchNorm statistics after pass 1, the optimizer's update fed
JAX's gradients, and the frozen parameters left bit for bit; and the
route of the decoder's boxRPB cross-attention (``xattn_rpb_takes_kernel``).

flax's BatchNorm updates its running statistics differentiably, and JAX's
loss hands pass 1's statistics to pass 2 inside the differentiated
function, so JAX's trunk gradient also flows through the statistics. The
port updates them without a gradient, as torch's BatchNorm (and the
reference's) does: its gradient is held to JAX's loss with the statistics
held constant in pass 2 (``ConstantStats``), and a test shows the two JAX
gradients differ by that path alone (ROADMAP, "Numerics choices").
"""

import numpy as np
import optax
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.build import make_student_trunk
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu.train import geometry_finetune as jgf
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.models.common import xattn_rpb_takes_kernel
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.train import geometry_finetune as pgf
from efficientsam3_tpu_torch.utils.checkpoint import assert_frozen_unchanged
from efficientsam3_tpu_torch.utils.convert import convert_variables, load_jax_variables
from test_torch_train_slice import random_variables

CTX, B, S = 16, 2, 112
CFG = dict(lr=1e-3)
FROZEN = ("neck", "text_encoder", "geometry_encoder", "fusion_encoder", "decoder", "seg_head",
          "scoring")
BOXES = ([0.5, 0.45, 0.4, 0.3], [0.3, 0.6, 0.2, 0.5])


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, CTX), np.int32)
    tokens[:, :4] = [49406, 320, 1125, 49407]
    mask = np.zeros((B, 48, 48), np.float32)
    for i, (cx, cy, w, h) in enumerate(BOXES):
        x0, x1 = int((cx - w / 2) * 48), int((cx + w / 2) * 48)
        y0, y1 = int((cy - h / 2) * 48), int((cy + h / 2) * 48)
        mask[i, y0:y1, x0:x1] = 1.0
    return dict(images=(0.5 * rng.standard_normal((B, S, S, 3))).astype(np.float32),
                tokens=tokens, teacher_embed=rng.standard_normal((B, 8, 8, 1024)).astype(
                    np.float32),
                valid=(rng.random((B, 8, 8)) > 0.2).astype(np.float32), teacher_mask=mask)


def prompts(cls):
    p = cls.empty(B, 2, 2)
    for i, box in enumerate(BOXES):
        p = p.with_box(i, 0, box)
    return p


class ConstantStats:
    """A flax model whose ``apply`` takes the variables' BatchNorm
    statistics as constants (stop_gradient): pass 1's statistics reach pass
    2 without a gradient path."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *a, **kw):
        stats = jax.lax.stop_gradient(variables["batch_stats"])
        return self.model.apply(dict(variables, batch_stats=stats), *a, **kw)


@pytest.fixture(scope="module")
def steps():
    jm = JModel(trunk=make_student_trunk("efficientvit", "b0", embed_size=8),
                text_encoder_type="MobileCLIP-S0", text_context_length=CTX,
                fusion_layers=2, decoder_layers=2)
    nb = make_batch()
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, S, S, 3)), jnp.asarray(nb["tokens"][:1]),
                            JPrompt.empty(1, 2, 2)), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=5)
    jcfg = jgf.GeometryFinetuneConfig(**CFG)
    tx = jgf.make_geometry_optimizer(jcfg, variables["params"])

    def tap_update(grads, state, params):  # hands the gradients out with the state
        updates, state = tx.update(grads, state, params)
        return updates, (state, grads)

    tap = optax.GradientTransformation(tx.init, tap_update)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    jbatch["prompt"] = prompts(JPrompt)
    new_vars, (_, grads), metrics = jax.jit(
        lambda v, o, bt: jgf.geometry_finetune_step(jm, tap, jcfg, v, o, bt))(
            variables, tx.init(variables["params"]), jbatch)

    def loss_grad(model):
        return jax.jit(jax.grad(lambda p: jgf.geometry_finetune_loss(
            model, dict(variables, params=p), jbatch, jcfg)[0]))(variables["params"])

    const_grads = loss_grad(ConstantStats(jm))

    def port_model():
        pm = build_efficientsam3_image_model(
            model_name="b0", embed_size=8, text_encoder_type="MobileCLIP-S0",
            text_encoder_context_length=CTX, device="cpu", fusion_layers=2, decoder_layers=2)
        return load_jax_variables(pm, variables)

    cfg = pgf.GeometryFinetuneConfig(**CFG)
    pm = port_model()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    opt = pgf.make_geometry_optimizer(cfg, pm)
    captured = {}
    clip_and_update = opt.step

    def step():  # keep the gradients before the in-place clip
        captured.update({k: p.grad.clone() for k, p in pm.named_parameters()
                         if p.grad is not None})
        clip_and_update()

    opt.step = step
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    tbatch["prompt"] = prompts(Prompt)
    got = pgf.geometry_finetune_step(pm, opt, cfg, tbatch)
    return dict(variables=variables, grads=grads, const_grads=const_grads, new=new_vars,
                model=pm, before=before,
                metrics={k: float(v) for k, v in metrics.items()}, cfg=cfg,
                got={k: float(v) for k, v in got.items()}, port_grads=captured,
                fresh=port_model())


def test_loss_parts_match_jax(steps):
    """loss, embed, bce and dice within 1e-4 relative (fp32 through the
    whole model on both sides)."""
    want, got = steps["metrics"], steps["got"]
    assert sorted(got) == sorted(want) == ["bce", "dice", "embed", "loss"]
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)


def test_trunk_gradient_matches_jax(steps):
    """The trunk's gradient of both passes against JAX's with pass 1's
    statistics constant in pass 2, per tensor: ||port - jax|| <= 3e-2
    ||jax|| + 1e-5 of the norm of all of them (the Stage-3 slice's bound:
    hardswish pre-activations within rounding of 0 flip sides in another
    summation order); every other parameter took none."""
    want = convert_variables({"params": steps["const_grads"]})
    got = steps["port_grads"]
    trunk = [k for k in want if k.startswith("trunk.")]
    assert sorted(got) == sorted(trunk) and len(trunk) > 50
    total = np.sqrt(sum(np.square(want[k], dtype=np.float64).sum() for k in trunk))
    for k in trunk:
        err = np.linalg.norm(got[k].numpy() - want[k])
        assert err <= 3e-2 * np.linalg.norm(want[k]) + 1e-5 * total, k


def test_jax_gradient_also_flows_through_the_statistics(steps):
    """JAX's own step differentiates through pass 1's running statistics:
    some trunk tensor's gradient leaves the constant-statistics one by more
    than 5% (over the bound above), while every parameter outside the
    trunk, upstream of no statistics that pass 1 updates, keeps its
    gradient within 1e-4 of its norm plus 1e-6 of the norm of all of them
    (two compiled programs summing in other orders; the second term for
    gradients that are rounding noise around 0): the difference is that
    path."""
    full = convert_variables({"params": steps["grads"]})
    const = convert_variables({"params": steps["const_grads"]})
    diff = {k: np.linalg.norm(full[k] - const[k]) / max(np.linalg.norm(const[k]), 1e-30)
            for k in full}
    assert max(v for k, v in diff.items() if k.startswith("trunk.")) > 0.05
    others = [k for k in full if not k.startswith("trunk.")]
    assert len(others) > 100
    total = np.sqrt(sum(np.square(const[k], dtype=np.float64).sum() for k in others))
    for k in others:
        err = np.linalg.norm(full[k] - const[k])
        assert err <= 1e-4 * np.linalg.norm(const[k]) + 1e-6 * total, k


def test_step_updates_trunk_and_leaves_the_rest(steps):
    """After the port's step: the frozen parameters and statistics bit for
    bit, every trunk parameter moved, the trunk's BatchNorm statistics as
    flax's after pass 1 (1e-5 relative). Fed JAX's gradients, the port's
    optimizer gives JAX's updated trunk within two fp32 ulps plus 1e-3 of
    the learning rate, and JAX's frozen group as it was."""
    pm, before, new = steps["model"], steps["before"], steps["new"]
    sd = pm.state_dict()
    assert_frozen_unchanged(before, sd, FROZEN)
    for k, p in pm.named_parameters():
        if k.startswith("trunk."):
            assert not torch.equal(sd[k], before[k]), k
    stats = convert_variables({"batch_stats": new["batch_stats"]})
    trunk_stats = [k for k in stats if k.startswith("trunk.")]
    assert len(trunk_stats) > 20
    for k, w in stats.items():
        assert not np.allclose(w, before[k].numpy()) or not k.startswith("trunk."), k
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())

    fresh, cfg = steps["fresh"], steps["cfg"]
    opt = pgf.make_geometry_optimizer(cfg, fresh)
    jgrads = convert_variables({"params": steps["grads"]})
    for k, p in fresh.named_parameters():
        if p.requires_grad:
            p.grad = torch.tensor(jgrads[k])
    opt.step()
    want = convert_variables({"params": new["params"]})
    old = convert_variables({"params": steps["variables"]["params"]})
    for k, p in fresh.named_parameters():
        got = p.detach().numpy()
        if not k.startswith("trunk."):
            assert np.array_equal(want[k], old[k]) and np.array_equal(got, old[k]), k
            continue
        tol = 2 * np.spacing(np.abs(want[k]).astype(np.float32)) + 1e-3 * cfg.lr
        assert (np.abs(got - want[k]) <= tol).all(), k


@pytest.mark.parametrize("is_cuda,needs_grad,kernel", [
    (True, False, True), (True, True, False), (False, False, False), (False, True, False)])
def test_xattn_route_by_gradient(is_cuda, needs_grad, kernel):
    """The boxRPB cross-attention takes the forward-only kernel only on CUDA
    where autograd records nothing: eval under no_grad keeps it, training
    and the geometry finetune's eval-mode pass under autograd take the
    matmul path (the CPU always does)."""
    assert xattn_rpb_takes_kernel(is_cuda, needs_grad) is kernel
