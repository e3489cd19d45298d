"""The SAM3 teacher slice of the PyTorch port against the JAX package, on
the CPU in fp32: ``Sam3ImageModel`` over a tiny ViTDet trunk (112^2, width
128, 2 heads of 64, depth 4, window 4, global blocks 1 and 3, pretraining
grid 4) and a tiny CLIP text tower (width 64, 4 heads, 2 layers, context
16), 2 fusion and 2 decoder layers: encode_image, encode_text and ground
with a box and a point prompt, then Sam3Processor's postprocessed scores,
boxes and masks. And the full-size teacher's key map: the port's
``build_sam3_image_model`` module on the meta device against
``jax.eval_shape`` of the JAX builder's ``init``, every key and shape both
ways.

Two stand-ins on the JAX side, bound to the name the JAX Sam3ImageModel
instantiates for these tests only (no file of the JAX package changes):
its ``encode_text`` passes ``train=`` to ``VETextEncoder``, whose
``__call__`` takes no such argument, so the JAX teacher cannot even be
initialised as it stands; ``_TextEncoder`` is the same module taking (and
ignoring, as the tower has no dropout) that argument. And the JAX model
builds the tower at full width, so the tiny config binds the tiny widths.
Weights are drawn with numpy over ``jax.eval_shape`` shapes and carried
across by ``utils/convert.py``.
"""

import functools
import gzip

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientsam3_tpu import build as jbuild
from efficientsam3_tpu.models import sam3_image as jsam3
from efficientsam3_tpu.models import text_encoder as jte
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.vitdet import ViTTrunk as JViTTrunk
from efficientsam3_tpu.processor import Sam3Processor as JProcessor
from efficientsam3_tpu_torch.build import build_sam3_image_model
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.models.sam3_image import Sam3ImageModel
from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
from efficientsam3_tpu_torch.processor import Sam3Processor
from efficientsam3_tpu_torch.utils.convert import converted_shapes, load_jax_variables

# as tests/test_torch_slice.py: fp32 through the trunk, text tower, fusion,
# decoder and seg head summed in other orders on XLA:CPU and ATen
TOL = 1e-4
CTX = 16
RES = 112
TRUNK = dict(embed_dim=128, depth=4, num_heads=2, window_size=4, global_att_blocks=(1, 3),
             pretrain_grid=4)
TEXT = dict(width=64, heads=4, layers=2)
TOKENS = np.array([[49406, 320, 1125, 3309, 49407] + [0] * (CTX - 5)], np.int32)
BOX = [0.5, 0.45, 0.4, 0.3]
POINT = [0.3, 0.6]


class _TextEncoder(jte.VETextEncoder):
    """The JAX teacher tower, taking the ``train`` its caller passes."""

    def __call__(self, tokens, *, train=False):
        return super().__call__(tokens)


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
        elif leaf in ("embedding", "positional_embedding", "pos_embed"):
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
    """(JAX processor, port model, port processor) over the same weights."""
    with pytest.MonkeyPatch.context() as mp:  # flax runs setup on every apply
        mp.setattr(jsam3, "VETextEncoder", functools.partial(_TextEncoder, **TEXT))
        jm = jsam3.Sam3ImageModel(trunk=JViTTrunk(**TRUNK), text_encoder_type=None,
                                  text_context_length=CTX, fusion_layers=2, decoder_layers=2)
        shapes = jax.eval_shape(
            lambda key: jm.init(key, jnp.zeros((1, RES, RES, 3)), jnp.asarray(TOKENS),
                                JPrompt.empty(1, 8, 8)),
            jax.random.PRNGKey(0))
        variables = random_variables(shapes)
        bpe = tmp_path_factory.mktemp("bpe") / "vocab.txt.gz"
        with gzip.open(bpe, "wt") as f:  # text goes in encoded: a stand-in merge table
            f.write("#version\na b\n")
        jproc = JProcessor(jm, variables, resolution=RES, confidence_threshold=0.0,
                           bpe_path=str(bpe), context_length=CTX)
        pm = Sam3ImageModel(ViTTrunk(**TRUNK), text_encoder_type=None, text_context_length=CTX,
                            fusion_layers=2, decoder_layers=2, trunk_dim=TRUNK["embed_dim"],
                            text_tower=TEXT).eval()
        load_jax_variables(pm, variables)
        pproc = Sam3Processor(pm, resolution=RES, confidence_threshold=0.0, context_length=CTX)
        yield jproc, pm, pproc


def test_teacher_slice_matches_jax(pair):
    jproc, pm, pproc = pair
    image = np.random.default_rng(3).integers(0, 256, (70, 90, 3), dtype=np.uint8)
    jimg = jproc.preprocess(image)
    img = pproc.preprocess(image)
    assert_close(img, jimg)
    v = jproc.variables
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
    assert [tuple(f.shape) for f in feats["fpn"]] == [(1, 32, 32, 256), (1, 16, 16, 256),
                                                     (1, 8, 8, 256)]
    for g, w in zip(feats["fpn"] + feats["pos"], jfeats["fpn"] + jfeats["pos"]):
        assert_close(g, w)
    assert_close(text[0], jtext[0])
    assert np.array_equal(text[1].numpy(), np.asarray(jtext[1]))
    for key in ("pred_logits", "pred_boxes", "presence_logit_dec", "pred_masks",
                "semantic_seg"):
        assert_close(got[key], want[key])


def test_teacher_processor_matches_jax(pair):
    """Threshold 0 keeps all 200 queries, so every box and mask is compared;
    the port's processor runs on the CPU without JAX (its shapes here, its
    imports in tests/test_torch_guards.py)."""
    jproc, _, pproc = pair
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
    assert state["boxes"].shape == (200, 4) and state["scores"].shape == (200,)
    assert_close(state["scores"], jstate["scores"])
    assert_close(state["boxes"], jstate["boxes"])
    assert_close(state["masks_logits"], jstate["masks_logits"])
    clear = np.abs(jstate["masks_logits"] - 0.5) > 1e-3
    assert np.array_equal(state["masks"][clear], jstate["masks"][clear])


def test_teacher_key_map_matches_jax_at_full_size(monkeypatch):
    """The full teacher (ViT-H trunk, 24-layer CLIP tower, context 32)
    without allocating it: the port's module on the meta device against the
    converted keys and shapes of ``jax.eval_shape`` of the JAX init at 336^2
    (a 24x24 grid, one window; parameter shapes do not depend on the
    resolution)."""
    monkeypatch.setattr(jsam3, "VETextEncoder", _TextEncoder)
    jm = jbuild.build_sam3_image_model(text_encoder_context_length=32)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, 336, 336, 3)), jnp.zeros((1, 32), jnp.int32),
                            JPrompt.empty(1, 8, 8)),
        jax.random.PRNGKey(0))
    want = converted_shapes(shapes)
    pm = build_sam3_image_model(32, device="meta")
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert sorted(got.keys() - want.keys()) == [] and sorted(want.keys() - got.keys()) == []
    assert {k: s for k, s in got.items() if want[k] != s} == {}
    assert sum(np.prod(s) for s in got.values()) > 8e8  # ~840 M parameters
