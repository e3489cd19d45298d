"""Grounding modules of the PyTorch port against the JAX modules: the
shared primitives of models/common.py, the geometry encoder, the fusion
encoder, the decoder with boxRPB and the presence token, dot-product
scoring and the segmentation head.

Each JAX module's variables are drawn with numpy from a seed over the
shapes ``jax.eval_shape(module.init)`` reports, carried across by
``utils/convert.py``, and both modules run the same numpy inputs in fp32.
On the CPU the attentions take the matmul path in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientsam3_tpu.models import common as jc
from efficientsam3_tpu.models import decoder as jdec
from efficientsam3_tpu.models import fusion_encoder as jfe
from efficientsam3_tpu.models import geometry as jgeo
from efficientsam3_tpu.models import seg_head as jsh
from efficientsam3_tpu_torch.models import common as pc
from efficientsam3_tpu_torch.models import decoder as pdec
from efficientsam3_tpu_torch.models import fusion_encoder as pfe
from efficientsam3_tpu_torch.models import geometry as pgeo
from efficientsam3_tpu_torch.models import seg_head as psh
from efficientsam3_tpu_torch.utils.convert import load_jax_variables

# fp32 on both sides; products and norms sum in other orders on XLA:CPU
# and ATen: ~1e-6 relative per layer, 2e-5 after a few layers
TOL = 2e-5
RNG = np.random.default_rng(7)


def random_variables(module, *args, seed=0, **kw):
    """Seeded numpy values over the module's variable shapes: fan-in
    scaled kernels, scales near 1, small biases."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf, sh = path[-1].key, s.shape
        if leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(sh)
        elif len(sh) == 1:
            a = 0.1 * rng.standard_normal(sh)
        elif leaf == "embedding":
            a = rng.standard_normal(sh) / np.sqrt(sh[-1])
        else:
            a = rng.standard_normal(sh) / np.sqrt(np.prod(sh[:-1]))
        return jnp.asarray(a.astype(np.float32))

    # static arguments (map sizes, flags) stay Python values: close over them
    shapes = jax.eval_shape(lambda key: module.init(key, *args, **kw), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype == bool:
        assert np.array_equal(got, want)
        return
    err = np.abs(got.astype(np.float32) - want.astype(np.float32)).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def randn(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(np.float32)


def run_both(jm, pm, *args, seed=0, **kw):
    """Init the JAX module, carry its variables into pm, run both on args."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    v = random_variables(jm, *jargs, seed=seed, **kw)
    want = jax.jit(lambda v_: jm.apply(v_, *jargs, **kw))(v)
    load_jax_variables(pm, v)
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    with torch.no_grad():
        got = pm(*targs, **kw)
    return got, want


# ---------------------------------------------------------------- common.py


def test_mlp_residual_out_norm():
    got, want = run_both(jc.MLP(48, 32, 3, residual=True, out_norm=True),
                         pc.MLP(32, 48, 32, 3, residual=True, out_norm=True), randn(2, 5, 32))
    assert_close(got, want)


def test_conv_transpose_2x():
    got, want = run_both(jc.ConvTranspose2x(6), pc.ConvTranspose2x(5, 6), randn(2, 3, 4, 5))
    assert_close(got, want)


def test_layer_norm_2d_and_fused_layer_norm():
    x = randn(2, 4, 5, 16, scale=3.0)
    got, want = run_both(jc.LayerNorm2d(), pc.LayerNorm2d(16), x)
    assert_close(got, want)
    got, want = run_both(jc.FusedLayerNorm(), pc.FusedLayerNorm(16), x)
    assert_close(got, want)


@pytest.mark.parametrize("case", ["key_padding", "rpb"])
def test_multihead_attention(case):
    """Key-padding mask, and the decomposed boxRPB bias on a non-square 3x5
    map (built whole for the matmul path on CPU in both packages)."""
    q, kv = randn(2, 7, 32), randn(2, 15, 32)
    jkw, tkw = {}, {}
    if case == "key_padding":
        pad = np.zeros((2, 15), bool)
        pad[1, 9:] = True
        jkw = dict(key_padding_mask=jnp.asarray(pad))
        tkw = dict(key_padding_mask=torch.from_numpy(pad))
    else:
        ey, ex = randn(2, 4, 7, 3), randn(2, 4, 7, 5)
        jkw = dict(rpb=(jnp.asarray(ey), jnp.asarray(ex), (3, 5)))
        tkw = dict(rpb=(torch.from_numpy(ey), torch.from_numpy(ex), (3, 5)))
    jm = jc.MultiheadAttention(32, 4)
    v = random_variables(jm, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), **jkw)
    want = jm.apply(v, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), **jkw)
    pm = load_jax_variables(pc.MultiheadAttention(32, 4), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv), **tkw)
    assert_close(got, want)


def test_sine_embeddings():
    assert_close(pc.sine_pos_embed_2d(6, 9, 64), jc.sine_pos_embed_2d(6, 9, 64), 1e-6)
    x, y, w, h = (RNG.random((3, 4)).astype(np.float32) for _ in range(4))
    tx, ty, tw, th = (torch.from_numpy(a) for a in (x, y, w, h))
    assert_close(pc.sine_encode_boxes(tx, ty, tw, th, 64),
                 jc.sine_encode_boxes(x, y, w, h, 64), 1e-6)


# ---------------------------------------------------------------- modules


def _prompt_pair():
    jp = jgeo.Prompt.empty(2, 3, 2)
    pp = pgeo.Prompt.empty(2, 3, 2)
    for b, slot, box, label in ((0, 0, [0.5, 0.45, 0.4, 0.3], 1), (0, 1, [0.2, 0.3, 0.1, 0.2], 0),
                                (1, 0, [0.7, 0.6, 0.5, 0.6], 1)):
        jp = jp.with_box(b, slot, jnp.asarray(box), label)
        pp = pp.with_box(b, slot, box, label)
    jp = jp.with_point(0, 0, jnp.asarray([0.3, 0.6]), 1)
    pp = pp.with_point(0, 0, [0.3, 0.6], 1)
    return jp, pp


def test_geometry_encoder():
    """Boxes and points (roi_align, grid_sample, sine encodings, labels,
    CLS) and three prompt/image fusion layers over a 6x8 token map."""
    jp, pp = _prompt_pair()
    img, pos = randn(2, 48, 64), randn(48, 64)
    jm = jgeo.SequenceGeometryEncoder(d_model=64, num_heads=4, dim_feedforward=96)
    v = random_variables(jm, jp, jnp.asarray(img), (6, 8), jnp.asarray(pos))
    want_tok, want_mask = jax.jit(
        lambda v_: jm.apply(v_, jp, jnp.asarray(img), (6, 8), jnp.asarray(pos)))(v)
    pm = load_jax_variables(
        pgeo.SequenceGeometryEncoder(d_model=64, num_heads=4, dim_feedforward=96), v)
    with torch.no_grad():
        got_tok, got_mask = pm(pp, torch.from_numpy(img), (6, 8), torch.from_numpy(pos))
    assert_close(got_tok, want_tok)
    assert_close(got_mask, want_mask)


def test_fusion_encoder():
    """Two pre-norm layers; the prompt carries a key-padding mask."""
    src, pos, prompt = randn(2, 40, 64), randn(40, 64), randn(2, 9, 64)
    mask = np.zeros((2, 9), bool)
    mask[0, 6:] = True
    got, want = run_both(jfe.FusionEncoder(num_layers=2, d_model=64, num_heads=4,
                                           dim_feedforward=96),
                         pfe.FusionEncoder(2, 64, 96, 4), src, pos, prompt, mask)
    assert_close(got, want)


@pytest.mark.parametrize("apply_dac", [False, True])
def test_decoder_and_scoring(apply_dac):
    """Two layers, 10 queries (20 with DAC), presence token, boxRPB 'log'
    over a 4x6 map, text cross-attention with padding; then dot-product
    scoring."""
    mem, mem_pos, text = randn(2, 24, 64), randn(2, 24, 64), randn(2, 9, 64)
    mask = np.zeros((2, 9), bool)
    mask[1, 5:] = True
    jm = jdec.TransformerDecoder(num_layers=2, num_queries=10, d_model=64, dim_feedforward=96)
    args = (jnp.asarray(mem), (4, 6))
    kw = dict(memory_pos=jnp.asarray(mem_pos), memory_text=jnp.asarray(text),
              text_key_padding_mask=jnp.asarray(mask), apply_dac=apply_dac)
    v = random_variables(jm, *args, **kw)
    want = jax.jit(lambda v_: jm.apply(v_, *args, **kw))(v)
    pm = load_jax_variables(pdec.TransformerDecoder(2, 10, 64, 96), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(mem), (4, 6), memory_pos=torch.from_numpy(mem_pos),
                 memory_text=torch.from_numpy(text), text_key_padding_mask=torch.from_numpy(mask),
                 apply_dac=apply_dac)
    for key in ("hs", "references", "presence_logits"):
        assert_close(got[key], want[key])

    hs = np.asarray(want["hs"])
    got, want = run_both(jdec.DotProductScoring(d_model=64, d_proj=64),
                         pdec.DotProductScoring(64, 64), hs, text, mask)
    assert_close(got, want)


def test_seg_head():
    """Pixel decoder over 3 levels (16, 8, 4), prompt cross-attention with
    padding, instance/semantic heads and the query-pixel masks."""
    feats = [randn(1, 16, 16, 64), randn(1, 8, 8, 64), randn(1, 4, 4, 64)]
    queries, enc, prompt = randn(1, 10, 64), randn(1, 16, 64), randn(1, 5, 64)
    mask = np.array([[False, False, False, True, True]])
    jm = jsh.UniversalSegmentationHead(hidden_dim=64, num_heads=4)
    jargs = ([jnp.asarray(f) for f in feats], jnp.asarray(queries), jnp.asarray(enc),
             jnp.asarray(prompt), jnp.asarray(mask))
    v = random_variables(jm, *jargs)
    want = jax.jit(lambda v_: jm.apply(v_, *jargs))(v)
    pm = load_jax_variables(psh.UniversalSegmentationHead(64, 4), v)
    with torch.no_grad():
        got = pm([torch.from_numpy(f) for f in feats], torch.from_numpy(queries),
                 torch.from_numpy(enc), torch.from_numpy(prompt), torch.from_numpy(mask))
    assert_close(got["pred_masks"], want["pred_masks"])
    assert_close(got["semantic_seg"], want["semantic_seg"])
