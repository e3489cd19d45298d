"""The ported slice end to end against the JAX package, at the tiny config
(EfficientViT b0, embed_size 8, 64x64 images, MobileCLIP-S0 at context 16,
2 fusion and 2 decoder layers): encode_image, encode_text and ground with
a box and a point prompt, then Sam3Processor's postprocessed scores, boxes
and masks, and the weight conversion itself.

The JAX variables are drawn with numpy from a seed over the shapes
``jax.eval_shape`` reports and carried across by ``utils/convert.py``;
everything runs in fp32 on the CPU.
"""

import gzip

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.build import make_student_trunk
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu.processor import Sam3Processor as JProcessor
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.processor import Sam3Processor
from efficientsam3_tpu_torch.utils.convert import convert_variables, load_jax_variables

# fp32 through ~40 layers (trunk, neck, text tower, geometry, fusion,
# decoder, seg head) summed in other orders on XLA:CPU and ATen: errors
# grow to ~1e-5 relative; 1e-4 of each output's range leaves margin
TOL = 1e-4
CTX = 16
TOKENS = np.array([[49406, 320, 1125, 3309, 49407] + [0] * (CTX - 5)], np.int32)
BOX = [0.5, 0.45, 0.4, 0.3]
POINT = [0.3, 0.6]


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


def assert_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX model, its variables, JAX processor, port model, port processor)."""
    jm = JModel(trunk=make_student_trunk("efficientvit", "b0", embed_size=8),
                text_encoder_type="MobileCLIP-S0", text_context_length=CTX,
                fusion_layers=2, decoder_layers=2)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, 64, 64, 3)), jnp.asarray(TOKENS),
                            JPrompt.empty(1, 8, 8)),
        jax.random.PRNGKey(0))
    variables = random_variables(shapes)
    # the JAX processor builds its tokenizer eagerly; text goes in encoded,
    # so a minimal merge table stands in for the CLIP vocab
    bpe = tmp_path_factory.mktemp("bpe") / "vocab.txt.gz"
    with gzip.open(bpe, "wt") as f:
        f.write("#version\na b\n")
    jproc = JProcessor(jm, variables, resolution=64, confidence_threshold=0.0,
                       bpe_path=str(bpe), context_length=CTX)
    pm = build_efficientsam3_image_model(
        model_name="b0", embed_size=8, text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=CTX, device="cpu", fusion_layers=2, decoder_layers=2)
    load_jax_variables(pm, variables)
    pproc = Sam3Processor(pm, resolution=64, confidence_threshold=0.0, context_length=CTX)
    return jm, variables, jproc, pm, pproc


def test_slice_matches_jax(pair):
    jm, v, jproc, pm, pproc = pair
    image = np.random.default_rng(3).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    jimg = jproc.preprocess(image)
    img = pproc.preprocess(image)
    assert_close(img, jimg)

    jfeats = jproc._encode_image(v, jimg)
    jtext = jproc._encode_text(v, jnp.asarray(TOKENS))
    jprompt = (JPrompt.empty(1, 8, 8).with_box(0, 0, jnp.asarray(BOX))
               .with_point(0, 0, jnp.asarray(POINT)))
    want = jproc._ground(v, jfeats["fpn"], jfeats["pos"], *jtext, jprompt)

    prompt = Prompt.empty(1, 8, 8).with_box(0, 0, BOX).with_point(0, 0, POINT)
    with torch.no_grad():
        feats = pm.encode_image(img)
        text = pm.encode_text(torch.from_numpy(TOKENS).long())
        got = pm.ground(feats["fpn"], feats["pos"], *text, prompt)
    for g, w in zip(feats["fpn"] + feats["pos"], jfeats["fpn"] + jfeats["pos"]):
        assert_close(g, w)
    assert_close(text[0], jtext[0])
    for key in ("pred_logits", "pred_boxes", "presence_logit_dec", "pred_masks",
                "semantic_seg"):
        assert_close(got[key], want[key])


def test_processor_matches_jax(pair):
    """Threshold 0 keeps all 200 queries, so every box and mask is compared.
    Masks are compared as probabilities, and as booleans away from 0.5."""
    _, _, jproc, pm, pproc = pair
    image = np.random.default_rng(4).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    jstate = jproc.set_image(image)
    jstate["text"] = jproc._encode_text(jproc.variables, jnp.asarray(TOKENS))
    jstate = jproc.add_geometric_prompt(BOX, True, jstate)
    jstate = jproc.add_point_prompt([20, 30], 1, jstate)

    state = pproc.set_image(image)
    state["text"] = pproc.encode_tokens(TOKENS)
    state = pproc.add_geometric_prompt(BOX, True, state)
    state = pproc.add_point_prompt([20, 30], 1, state)

    assert state["masks"].shape == (200, 48, 80)
    assert_close(state["scores"], jstate["scores"])
    assert_close(state["boxes"], jstate["boxes"])
    assert_close(state["masks_logits"], jstate["masks_logits"])
    clear = np.abs(jstate["masks_logits"] - 0.5) > 1e-3
    assert np.array_equal(state["masks"][clear], jstate["masks"][clear])


def test_processor_batch_matches_single(pair):
    """set_image_batch: one encode over the batch, masks at each image's
    own size, image 0 as from set_image (the same ground on the same row)."""
    _, _, _, _, pproc = pair
    rs = np.random.default_rng(5)
    im_a = rs.integers(0, 256, (48, 80, 3), dtype=np.uint8)
    im_b = rs.integers(0, 256, (96, 40, 3), dtype=np.uint8)
    st = pproc.set_image_batch([im_a, im_b])
    st["text"] = pproc.encode_tokens(TOKENS)
    st = pproc.add_geometric_prompt(BOX, True, st)
    assert [m.shape for m in st["masks"]] == [(200, 48, 80), (200, 96, 40)]
    st1 = pproc.set_image(im_a)
    st1["text"] = pproc.encode_tokens(TOKENS)
    st1 = pproc.add_geometric_prompt(BOX, True, st1)
    assert_close(st["scores"][0], st1["scores"])
    assert_close(st["boxes"][0], st1["boxes"])


def test_convert_round_trip(pair):
    """convert -> load_state_dict(strict=True) -> state_dict gives back the
    converted arrays exactly; a missing, extra or misshapen key fails."""
    _, v, _, pm, _ = pair
    converted = convert_variables(v)
    sd = pm.state_dict()
    assert sd.keys() == converted.keys()
    for k, a in converted.items():
        assert np.array_equal(sd[k].numpy(), a), k

    flat = {c: dict(t) for c, t in v.items()}
    missing = dict(flat, params={k: t for k, t in flat["params"].items() if k != "scoring"})
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(pm, missing)
    extra = dict(flat, params=dict(flat["params"], stray={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_variables(pm, extra)
    scoring = dict(flat["params"]["scoring"])
    scoring["prompt_proj"] = {"kernel": np.zeros((3, 3)), "bias": np.zeros(3)}
    misshapen = dict(flat, params=dict(flat["params"], scoring=scoring))
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(pm, misshapen)
