"""The port's interactive-steps training against the JAX package's, in fp32
on the CPU: JAX's two scenarios of tests/test_interactive_train.py run on
the port (the click lands in the error region with the right label; the
unrolled two-pass loss runs with finite gradients), the clicks against
JAX's on targets that need the antialiased downsample, and the loss of
each pass and every gradient against ``jax.value_and_grad`` at the tiny
config (EfficientViT b0, embed_size 8, 112x112, MobileCLIP-S0 at context
16, 2 fusion and 2 decoder layers) with dropout off on both sides (the
port built with dropout 0, flax's ``nn.Dropout`` replaced by the identity
in this test only).
"""

import flax.linen as nn
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.build import make_student_trunk
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu.train import interactive as jit_
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.train import interactive as pit
from efficientsam3_tpu_torch.utils.convert import convert_variables, load_jax_variables
from test_torch_train_slice import random_variables

CTX, B, S = 16, 2, 112


def test_sample_correction_click_targets_error_region():
    """JAX's first scenario on the port: a false-negative click inside the
    target square (label 1), a false-positive click inside the wrong
    prediction (label 0); and JAX's clicks."""
    h = w = 32
    prev = np.full((2, 3, h, w), -5.0, np.float32)
    gt = np.zeros((2, 2, h, w), np.float32)
    gt[0, 0, 8:16, 8:16] = 1.0
    prev[1, 0, 20:28, 4:12] = 5.0
    valid = np.array([[True, False], [False, False]])
    logits = np.zeros((2, 3, 1), np.float32)
    logits[1, 0, 0] = 3.0
    xy, labels, has = pit.sample_correction_click(*map(torch.from_numpy,
                                                       (prev, logits, gt, valid)))
    assert has.all()
    x0, y0 = xy[0].numpy() * [w, h]
    assert 8 <= x0 < 16 and 8 <= y0 < 16 and labels[0] == 1
    x1, y1 = xy[1].numpy() * [w, h]
    assert 4 <= x1 < 12 and 20 <= y1 < 28 and labels[1] == 0
    want = jit_.sample_correction_click(*map(jnp.asarray, (prev, logits, gt, valid)))
    for g, w_ in zip((xy, labels, has), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clicks_match_jax_through_the_downsample(seed):
    """64x64 targets onto a 32x32 mask grid (JAX's antialiased linear
    resize, the port's resize_antialiased), rectangles on even coordinates
    so that no downsampled value sits at the 0.5 threshold; one sample with
    no error (its slot stays padding). xy, labels and has_click equal."""
    rng = np.random.default_rng(seed)
    prev = rng.standard_normal((3, 4, 32, 32)).astype(np.float32) - 1.5
    logits = rng.standard_normal((3, 4, 1)).astype(np.float32)
    gt = np.zeros((3, 3, 64, 64), np.float32)
    for b in range(2):
        for t in range(3):
            y0, x0 = 2 * rng.integers(0, 24, 2)
            hh, ww = 2 * rng.integers(3, 8, 2)
            gt[b, t, y0:y0 + hh, x0:x0 + ww] = 1.0
    valid = rng.random((3, 3)) > 0.3
    prev[2] = -5.0  # nothing predicted, nothing to find: no click
    got = pit.sample_correction_click(*map(torch.from_numpy, (prev, logits, gt, valid)))
    want = jit_.sample_correction_click(*map(jnp.asarray, (prev, logits, gt, valid)))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=1e-7)
    assert not bool(got[2][2])
    p = pit.add_click_to_prompt(Prompt.empty(3, 2, 4), 3, *got)
    jp = jit_.add_click_to_prompt(JPrompt.empty(3, 2, 4), 3, *want)
    for f in ("points", "point_labels", "point_mask"):
        np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(jp, f)), atol=1e-7)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    images = (0.5 * rng.standard_normal((B, S, S, 3))).astype(np.float32)
    tokens = np.zeros((B, CTX), np.int32)
    tokens[:, :4] = [49406, 320, 1125, 49407]
    boxes = np.array([[[0.5, 0.5, 0.25, 0.25], [0.2, 0.3, 0.1, 0.1]],
                      [[0.4, 0.6, 0.3, 0.2], [0.0, 0.0, 0.0, 0.0]]], np.float32)
    valid = np.array([[True, True], [True, False]])
    masks = np.zeros((B, 2, 64, 64), np.float32)
    masks[0, 0, 24:40, 24:40] = 1.0
    masks[0, 1, 14:24, 8:18] = 1.0
    masks[1, 0, 32:46, 16:36] = 1.0
    return images, tokens, {"boxes": boxes, "valid": valid, "masks": masks}


@pytest.fixture(scope="module")
def losses():
    """(JAX: total, parts per pass, grads; port: the same) of a two-pass
    interactive loss in training mode, dropout off."""
    jm = JModel(trunk=make_student_trunk("efficientvit", "b0", embed_size=8),
                text_encoder_type="MobileCLIP-S0", text_context_length=CTX,
                fusion_layers=2, decoder_layers=2)
    images, tokens, targets = batch()
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, S, S, 3)), jnp.asarray(tokens[:1]),
                            JPrompt.empty(1, 2, 4)), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=6)
    prompt = JPrompt.empty(B, 2, 4).with_box(0, 0, [0.5, 0.5, 0.3, 0.3])

    def loss_fn(params):
        total, (parts, _) = jit_.interactive_grounding_loss(
            jm, dict(variables, params=params), jnp.asarray(images), jnp.asarray(tokens),
            prompt, jax.tree.map(jnp.asarray, targets), num_interactive_steps=1)
        return total, parts

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])

    pm = build_efficientsam3_image_model(
        model_name="b0", embed_size=8, text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=CTX, device="cpu", fusion_layers=2, decoder_layers=2,
        dropout=0.0)
    pm = load_jax_variables(pm, variables).train().requires_grad_(True)
    tprompt = Prompt.empty(B, 2, 4).with_box(0, 0, [0.5, 0.5, 0.3, 0.3])
    total, parts = pit.interactive_grounding_loss(
        pm, torch.from_numpy(images), torch.from_numpy(tokens).long(), tprompt,
        {k: torch.from_numpy(v) for k, v in targets.items()}, num_interactive_steps=1)
    total.backward()
    grads = {k: p.grad for k, p in pm.named_parameters()}
    return float(jtotal), jparts, convert_variables({"params": jgrads}), float(total), parts, grads


def test_interactive_loss_runs_and_grads(losses):
    """JAX's second scenario on the port: a finite loss on both passes and
    finite, nonzero gradients."""
    _, _, _, total, parts, grads = losses
    assert np.isfinite(total) and len(parts) == 2
    sums = [float(g.abs().sum()) for g in grads.values() if g is not None]
    assert np.isfinite(sums).all() and sum(sums) > 0


def test_interactive_loss_matches_jax(losses):
    """The total and every part of both passes within 1e-4 relative (fp32
    through the model twice, the second pass on the click of the first)."""
    jtotal, jparts, _, total, parts, _ = losses
    assert abs(total - jtotal) <= 1e-4 * max(1.0, abs(jtotal))
    for j, p in zip(jparts, parts):
        assert sorted(p) == sorted(j)
        for k in j:
            w = float(j[k])
            assert abs(float(p[k]) - w) <= 1e-4 * max(1.0, abs(w)), k


def test_interactive_gradients_match_jax(losses):
    """Every parameter's gradient: ||port - jax|| <= 3e-2 ||jax|| + 1e-5 of
    the norm of all of them (the Stage-3 slice's bound)."""
    _, _, jgrads, _, _, grads = losses
    assert len(jgrads) > 300
    total = np.sqrt(sum(np.square(v, dtype=np.float64).sum() for v in jgrads.values()))
    for k, w in jgrads.items():
        g = grads[k]
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w) + 1e-5 * total, k
