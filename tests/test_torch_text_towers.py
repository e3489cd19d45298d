"""The port's MobileCLIP text towers against the JAX package's, in fp32 on
the CPU: each variant ('mct', 'base', causal 'base') at a tiny width in
eval and training mode (BatchNorm statistics included), MobileCLIP-S1 at
its full width at context 16, ``truncate_pos_embed``, and the image-model
build over every ``MOBILECLIP_TEXT_CFGS`` entry (the tower's key map
against JAX's, one encode_text). JAX variables are drawn with numpy over
``jax.eval_shape`` shapes and carried across by ``utils/convert.py``.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.models import mobile_clip as jmc
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.models import mobile_clip as pmc
from efficientsam3_tpu_torch.utils.convert import (
    convert_variables,
    converted_shapes,
    load_jax_variables,
)
from test_torch_train_slice import random_variables

# fp32 on both sides, the same operations in other orders: 1e-5 of the
# output's scale (about 80 fp32 ulps) over a handful of layers
TOL = 1e-5
CTX = 16


def tokens(b=3, ctx=CTX, seed=0):
    rng = np.random.default_rng(seed)
    t = np.zeros((b, ctx), np.int32)
    for i in range(b):
        n = 3 + 2 * i
        t[i, 0], t[i, n - 1] = 49406, 49407
        t[i, 1:n - 1] = rng.integers(320, 49000, n - 2)
    return t


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("variant,causal", [("mct", False), ("base", False), ("base", True)])
@pytest.mark.parametrize("train", [False, True])
def test_tiny_tower_matches_jax(variant, causal, train):
    """A tiny tower (dim 32, 2 layers, 2 heads) of each variant; in
    training mode also the 'mct' tower's new BatchNorm statistics."""
    kw = dict(dim=32, layers=2, heads=2, variant=variant, causal=causal, context_length=CTX)
    jm = jmc.MobileCLIPTextTransformer(**kw)
    tok = tokens()
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), tok), seed=1)
    pm = load_jax_variables(pmc.MobileCLIPTextTransformer(**kw), variables).train(train)
    if train:
        want, mut = jm.apply(variables, tok, train=True, mutable=["batch_stats"])
    else:
        want, mut = jm.apply(variables, tok), {}
    got = pm(torch.from_numpy(tok).long())
    assert_close(got.detach().numpy(), want)
    if mut:
        state = pm.state_dict()
        for k, v in convert_variables(mut).items():
            assert_close(state[k].numpy(), v)


def test_causal_mask_cuts_later_tokens():
    """MobileCLIP-B's mask: a token's features do not depend on later
    tokens (the non-causal tower's do)."""
    for causal in (True, False):
        kw = dict(dim=32, layers=2, heads=2, variant="base", causal=causal, context_length=CTX)
        pm = pmc.MobileCLIPTextTransformer(**kw)
        torch.manual_seed(0)
        for p in pm.parameters():
            torch.nn.init.normal_(p, std=0.2)
        tok = torch.from_numpy(tokens(1)).long()
        tok2 = tok.clone()
        tok2[0, 5] = 1234
        a, b = pm(tok), pm(tok2)
        assert torch.equal(a[0, :5], b[0, :5]) == causal
        assert not torch.equal(a[0, 5:], b[0, 5:])


def test_mobileclip_s1_full_width_matches_jax():
    """MobileCLIP-S1 (12 'base' layers of width 512) with its projector at
    context 16, through the student encoder; the pad mask too."""
    jm = jmc.TextStudentEncoder(backbone_type="MobileCLIP-S1", context_length=CTX)
    tok = tokens()
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), tok), seed=2)
    want, want_mask = jax.jit(jm.apply)(variables, tok)
    pm = load_jax_variables(pmc.TextStudentEncoder("MobileCLIP-S1", CTX), variables).eval()
    with torch.no_grad():
        got, mask = pm(torch.from_numpy(tok).long())
    assert_close(got.numpy(), want, tol=1e-4)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_truncate_pos_embed_matches_jax():
    """A context-77 MobileCLIP-S0 tower cut to 16 tokens: the port's cut of
    the state_dict equals JAX's cut of the param tree, and the cut tower
    loads into a context-16 build and agrees with JAX's."""
    j77 = jmc.TextStudentEncoder(backbone_type="MobileCLIP-S0", context_length=77)
    tok = tokens()
    variables = random_variables(jax.eval_shape(j77.init, jax.random.PRNGKey(0), tok), seed=3)
    jparams = jmc.truncate_pos_embed(variables["params"], CTX)
    want_state = convert_variables(dict(variables, params=jparams))
    p77 = load_jax_variables(pmc.TextStudentEncoder("MobileCLIP-S0", 77), variables)
    cut = pmc.truncate_pos_embed(p77.state_dict(), CTX)
    assert cut["encoder.positional_embedding"].shape == (CTX, 512)
    assert p77.encoder.positional_embedding.shape == (77, 512)  # the source is left as it was
    for k, v in want_state.items():
        np.testing.assert_array_equal(cut[k].numpy(), v)
    p16 = pmc.TextStudentEncoder("MobileCLIP-S0", CTX)
    p16.load_state_dict(cut)
    j16 = jmc.TextStudentEncoder(backbone_type="MobileCLIP-S0", context_length=CTX)
    want, _ = jax.jit(j16.apply)(dict(variables, params=jparams), tok)
    with torch.no_grad():
        got, _ = p16.eval()(torch.from_numpy(tok).long())
    assert_close(got.numpy(), want, tol=1e-4)


@pytest.mark.parametrize("name", sorted(jmc.MOBILECLIP_TEXT_CFGS))
def test_build_takes_every_tower(name):
    """build_efficientsam3_image_model(text_encoder_type=name): the tower's
    parameter names and shapes are JAX's (strict convert), and encode_text
    gives (B, 16, 256) features and the pad mask."""
    assert set(pmc.MOBILECLIP_TEXT_CFGS) == set(jmc.MOBILECLIP_TEXT_CFGS)
    assert pmc.MOBILECLIP_TEXT_CFGS[name] == jmc.MOBILECLIP_TEXT_CFGS[name]
    model = build_efficientsam3_image_model(
        model_name="b0", embed_size=8, text_encoder_type=name, text_encoder_context_length=CTX,
        device="cpu", fusion_layers=1, decoder_layers=1)
    jm = jmc.TextStudentEncoder(backbone_type=name, context_length=CTX)
    want = converted_shapes(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                           jnp.zeros((1, CTX), jnp.int32)))
    got = {k: tuple(v.shape) for k, v in model.text_encoder.state_dict().items()}
    assert got == want
    tok = torch.from_numpy(tokens(2)).long()
    with torch.no_grad():
        mem, mask = model.encode_text(tok)
    assert mem.shape == (2, CTX, 256) and torch.isfinite(mem).all()
    assert torch.equal(mask, tok == 0)
