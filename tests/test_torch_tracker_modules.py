"""The tracker's modules in the PyTorch port against the JAX package: the
SAM prompt encoder and mask decoder, memory attention (plain and cached),
the memory encoder, every TrackerCore method, flatten_kv_bank, and the
cached path against the plain path.

A small TrackerCore (64x64 images, 8x8 tokens, d_model 32, mem_dim 8, 3
memories, 4 pointers) gets JAX variables drawn with numpy from a seed over
the shapes ``jax.eval_shape(init_tracker_variables)`` reports; they are
carried into the port by ``utils/convert.py`` (strictly: every key
matches), and both run the same numpy inputs in fp32 on the CPU, where
every attention takes the matmul path in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from efficientsam3_tpu.models.sam import MaskDecoder as JMaskDecoder
from efficientsam3_tpu.video import tracker as jtr
from efficientsam3_tpu_torch.models.common import ConvTranspose2x
from efficientsam3_tpu_torch.models.sam import MaskDecoder
from efficientsam3_tpu_torch.utils.convert import convert_variables, load_jax_variables
from efficientsam3_tpu_torch.video import tracker as ptr

# fp32 on both sides; products, norms and softmaxes sum in other orders on
# XLA:CPU and ATen: ~1e-6 relative per layer, 2e-5 after the stack
TOL = 2e-5
CFG = dict(image_size=64, backbone_stride=8, d_model=32, mem_dim=8, num_maskmem=3,
           max_obj_ptrs=4)
B, FS, D, MD, NM, NP = 3, 8, 32, 8, 3, 4


def random_variables(shapes, seed=0):
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

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float32) - want.astype(np.float32)).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def cores():
    jcore = jtr.TrackerCore(**CFG)
    shapes = jax.eval_shape(lambda key: jtr.init_tracker_variables(jcore, key),
                            jax.random.PRNGKey(0))
    v = random_variables(shapes)
    pcore = load_jax_variables(ptr.TrackerCore(**CFG), v).requires_grad_(False).eval()
    return jcore, v, pcore


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    valid = np.array([[True, True, False], [True, True, True], [False, False, False]])
    pvalid = np.array([[True, True, False, False], [True] * 4, [False] * 4])
    return dict(
        tokens=f(B, FS * FS, D, sc=0.5), pos=f(FS * FS, D, sc=0.2),
        mem=f(B, NM, FS, FS, MD, sc=0.5), tpos=np.array([[0, 1, 2], [2, 0, 1], [0, 0, 0]]),
        valid=valid, ptrs=f(B, NP, D, sc=0.5),
        tdiff=np.array([[0.0, 1, 2, 3]] * B, np.float32), pvalid=pvalid,
        s0=f(B, 4 * FS, 4 * FS, D // 8, sc=0.3), s1=f(B, 2 * FS, 2 * FS, D // 4, sc=0.3),
        coords=np.array([[[10, 12], [40, 50], [0, 0]], [[5, 60], [0, 0], [0, 0]],
                         [[30, 30], [20, 21], [55, 3]]], np.float32),
        labels=np.array([[2, 3, -1], [1, -1, -1], [1, 0, -1]]),
        mask_prompt=f(B, 4 * FS, 4 * FS, 1), hi_masks=f(B, 1, 64, 64, sc=4.0),
        score=np.array([[1.5], [-0.5], [0.2]], np.float32),
        bin_masks=(rng.random((B, 64, 64, 1)) > 0.6).astype(np.float32),
    )


def _japply(jcore, v, method, *args):
    return jcore.apply(v, *args, method=method)


def test_convert_carries_the_tracker_tree_strictly(cores):
    """Every JAX leaf lands on a port parameter of the same shape, and back;
    the raw parameters and the _ConvParams holders included."""
    _, v, pcore = cores
    converted = convert_variables(v)
    sd = pcore.state_dict()
    assert sd.keys() == converted.keys()
    for k, a in converted.items():
        assert np.array_equal(sd[k].numpy(), a), k
    for key in ("maskmem_tpos_enc", "no_obj_embed_spatial", "memory_encoder.fuser.0.gamma",
                "memory_encoder.fuser.1.dwconv.weight",
                "memory_encoder.mask_downsampler.encoder.0.weight",
                "sam_prompt_encoder.point_embeddings.3.weight",
                "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
                "memory_attention.layers.2.cross_attn_image.k_proj.weight"):
        assert key in sd, key


def test_mask_decoder_conv_transpose_layout():
    """flax nn.ConvTranspose's (2, 2, in, out) kernel, carried by the conv
    rule, is ConvTranspose2x's (out, in, 2, 2) weight."""
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 6)).astype(np.float32)
    m = fnn.ConvTranspose(4, (2, 2), strides=(2, 2), padding="VALID")
    v = m.init(jax.random.PRNGKey(3), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: a + 0.1, v)
    want = m.apply(v, jnp.asarray(x))
    got = load_jax_variables(ConvTranspose2x(6, 4), v)(_t(x))
    assert_close(got, want)


def test_prompt_encoder(cores, inputs):
    jcore, v, pcore = cores
    i = inputs
    for mask in (None, i["mask_prompt"]):
        want = _japply(jcore, v, lambda m, c, l, mk: m.sam_prompt_encoder(c, l, mk),
                       i["coords"], i["labels"], mask)
        got = pcore.sam_prompt_encoder(_t(i["coords"]), _t(i["labels"]),
                                       None if mask is None else _t(mask))
        assert_close(got[0], want[0])
        assert_close(got[1], want[1])
    assert_close(pcore.sam_prompt_encoder.dense_pe(),
                 _japply(jcore, v, lambda m: m.sam_prompt_encoder.dense_pe()))


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder(cores, inputs, multimask):
    jcore, v, pcore = cores
    i = inputs
    pix = i["tokens"].reshape(B, FS, FS, D)

    def run(m, p, c, l, s0, s1):
        sparse, dense = m.sam_prompt_encoder(c, l)
        return m.sam_mask_decoder(p, m.sam_prompt_encoder.dense_pe(), sparse, dense, multimask,
                                  (s0, s1))

    want = _japply(jcore, v, run, pix, i["coords"], i["labels"], i["s0"], i["s1"])
    pe = pcore.sam_prompt_encoder
    sparse, dense = pe(_t(i["coords"]), _t(i["labels"]))
    got = pcore.sam_mask_decoder(_t(pix), pe.dense_pe(), sparse, dense, multimask,
                                 (_t(i["s0"]), _t(i["s1"])))
    for g, w in zip(got, want):
        assert_close(g, w)


def test_mask_decoder_stability_choice():
    """The dynamic multimask choice when multimask is off: a stable single
    mask is kept, an unstable one gives way to the best of the others."""
    rng = np.random.default_rng(2)
    masks = rng.standard_normal((2, 4, 6, 6)).astype(np.float32)
    masks[0, 0] = 5.0  # stable: every logit far from 0
    ious = rng.random((2, 4)).astype(np.float32)
    jm = JMaskDecoder(transformer_dim=32)
    want = jm.apply({}, jnp.asarray(masks), jnp.asarray(ious), method=jm._dynamic_multimask)
    got = MaskDecoder(transformer_dim=32)._dynamic_multimask(_t(masks), _t(ious))
    assert_close(got[0], want[0])
    assert_close(got[1], want[1])
    assert np.array_equal(got[0][0].numpy(), masks[0, 0:1])
    best = 1 + ious[1, 1:].argmax()
    assert np.array_equal(got[0][1].numpy(), masks[1, best:best + 1])


def _cond_args(i):
    return (i["tokens"], i["pos"], i["mem"], i["tpos"], i["valid"], i["ptrs"], i["tdiff"],
            i["pvalid"])


def test_condition_features_plain(cores, inputs):
    """Memory attention on the plain path; slot 2 is empty (every memory and
    pointer masked) and takes the matmul path's uniform average on both."""
    jcore, v, pcore = cores
    want = _japply(jcore, v, jcore.condition_features, *_cond_args(inputs), 4.0)
    got = pcore.condition_features(*(_t(a) for a in _cond_args(inputs)), 4.0)
    assert_close(got, want)


def _banks(core, mem, to_arr):
    ks, vs = [], []
    for j in range(mem.shape[1]):
        k, v = core(mem[:, j])
        ks.append(k)
        vs.append(v)
    return to_arr(ks, vs)


@pytest.mark.parametrize("shared", [False, True])
def test_condition_features_cached(cores, inputs, shared):
    """The cached path in both packages, from encode_memory_kv entries via
    flatten_kv_bank and the tpos_k_delta table, per slot and with shared
    ages (every slot then holds the same ages)."""
    jcore, v, pcore = cores
    i = dict(inputs)
    if shared:
        i["tpos"] = np.broadcast_to(np.array([2, 0, 1]), (B, NM)).copy()
        i["valid"] = np.broadcast_to(np.array([True, True, False]), (B, NM)).copy()
    jk, jv = _banks(lambda m: _japply(jcore, v, jcore.encode_memory_kv, m), jnp.asarray(i["mem"]),
                    jtr.flatten_kv_bank)
    pk, pv = _banks(pcore.encode_memory_kv, _t(i["mem"]), ptr.flatten_kv_bank)
    assert_close(pk, jk)
    assert_close(pv, jv)
    jdelta = _japply(jcore, v, jcore.tpos_k_delta)
    pdelta = pcore.tpos_k_delta()
    assert_close(pdelta, jdelta)
    args = (i["tokens"], i["pos"])
    rest = (i["tpos"], i["valid"], i["ptrs"], i["tdiff"], i["pvalid"])
    want = jcore.apply(v, *args, jk, jv, *rest, jdelta, 4.0, shared_ages=shared,
                       method=jcore.condition_features_cached)
    got = pcore.condition_features_cached(*(_t(a) for a in args), pk, pv,
                                          *(_t(a) for a in rest), pdelta, 4.0,
                                          shared_ages=shared)
    # slot 2 has no valid key at all: the cached path's merge gives 0 there
    # (not the plain path's uniform average); compare the active slots
    assert_close(got[:2], want[:2])
    # and the cached path equals the plain path on them, as the JAX package pins
    plain = pcore.condition_features(*(_t(a) for a in _cond_args(i)), 4.0)
    assert_close(got[:2], plain[:2])


def test_quantized_bank_is_not_ported(cores, inputs):
    """The name dates from when quantize_bank raised in the port; it is
    ported now: the cached path over the int8 key bank runs and stays
    within the int8 noise floor of the exact cached path, as the JAX
    package pins it (tests/test_memory_kv_cache.py: < 2e-2 of the output's
    largest magnitude). tests/test_torch_pcs_modules.py holds it against the
    JAX package."""
    _, _, pcore = cores
    i = dict(inputs)
    i["tpos"] = np.broadcast_to(np.array([2, 0, 1]), (B, NM)).copy()
    i["valid"] = np.ones((B, NM), bool)
    pk, pv = _banks(pcore.encode_memory_kv, _t(i["mem"]), ptr.flatten_kv_bank)
    args = (_t(i["tokens"]), _t(i["pos"]), pk, pv, _t(i["tpos"]), _t(i["valid"]), _t(i["ptrs"]),
            _t(i["tdiff"]), _t(i["pvalid"]), pcore.tpos_k_delta(), 4.0)
    exact = pcore.condition_features_cached(*args, shared_ages=True)
    q8 = pcore.condition_features_cached(*args, shared_ages=True, quantize_bank=True)
    rel = ((q8 - exact).abs().max() / exact.abs().max()).item()
    assert 0 < rel < 2e-2, rel


@pytest.mark.parametrize("multimask", [True, False])
def test_forward_sam_heads(cores, inputs, multimask):
    jcore, v, pcore = cores
    i = inputs
    pix = i["tokens"].reshape(B, FS, FS, D)
    want = jcore.apply(v, jnp.asarray(pix), i["coords"], i["labels"], (i["s0"], i["s1"]),
                       multimask, method=jcore.forward_sam_heads)
    got = pcore.forward_sam_heads(_t(pix), _t(i["coords"]), _t(i["labels"]),
                                  (_t(i["s0"]), _t(i["s1"])), multimask)
    assert want.keys() == got.keys()
    for k in want:
        assert_close(got[k], want[k])


def test_use_mask_as_output(cores, inputs):
    """A binary mask adopted as the output; slot 2's mask is empty. Its
    4x-downsampled prompt (16x16) is resized up to the prompt encoder's
    32x32 with the antialiased bilinear of both packages."""
    jcore, v, pcore = cores
    i = inputs
    bm = i["bin_masks"].copy()
    bm[2] = 0.0
    pix = i["tokens"].reshape(B, FS, FS, D)
    want = jcore.apply(v, jnp.asarray(pix), (i["s0"], i["s1"]), jnp.asarray(bm),
                       method=jcore.use_mask_as_output)
    got = pcore.use_mask_as_output(_t(pix), (_t(i["s0"]), _t(i["s1"])), _t(bm))
    for k in want:
        assert_close(got[k], want[k])


@pytest.mark.parametrize("from_pts", [False, True])
def test_encode_memory(cores, inputs, from_pts):
    """Memory encoder (mask downsampler with its 64 -> 128 resize, the fuser's
    depthwise convs) and the no-object embedding (slot 1 scores below 0)."""
    jcore, v, pcore = cores
    i = inputs
    want = jcore.apply(v, i["tokens"], i["hi_masks"], i["score"], from_pts,
                       method=jcore.encode_memory)
    got = pcore.encode_memory(_t(i["tokens"]), _t(i["hi_masks"]), _t(i["score"]), from_pts)
    assert_close(got, want)
    assert_close(pcore.no_mem_features(_t(i["tokens"])),
                 _japply(jcore, v, jcore.no_mem_features, i["tokens"]))


def test_get_1d_sine_pe():
    pos = np.array([[0.0, 0.5, 1.0, 3.0]], np.float32)
    assert_close(ptr.get_1d_sine_pe(_t(pos), 32), jtr.get_1d_sine_pe(jnp.asarray(pos), 32))


def test_init_tracker_parameters_covers_every_parameter():
    """The seeded initialiser writes every parameter (none is left as
    torch.empty garbage) and is reproducible from the seed."""
    a = ptr.init_tracker_parameters(ptr.TrackerCore(**CFG), seed=3)
    b = ptr.init_tracker_parameters(ptr.TrackerCore(**CFG), seed=3)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.isfinite(p).all() and torch.equal(p, q), name
    assert torch.equal(a.memory_encoder.fuser[0].gamma, torch.full((32,), 1e-6))
    assert a.maskmem_tpos_enc.abs().max() <= 0.04
