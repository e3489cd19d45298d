"""The port's reference-checkpoint converters (utils/torch_convert.py,
convert_backbones.py, convert_model.py and utils/checkpoint.py's
``load_reference_checkpoint``) against the JAX package's, on a synthetic
reference state_dict.

No released checkpoint is in the repository, so the reference-layout
state_dict is made from seeded JAX variables by inverting the converter:
a pass of JAX's ``convert_image_model`` (or ``convert_tracker_core``) over
a state_dict whose every key returns a marker records, at each flax leaf,
the reference key it read and what it did to it (a transpose, the
ConvTranspose flip, a slice of a fused in_proj, a reshape); each seeded
leaf is then put back under its key by the inverse operation. Then:

  - the port's converters give arrays equal to JAX's (``np.array_equal``)
    for EfficientViT b0, RepViT m0.9 and TinyViT 5m trunks with the
    MobileCLIP-S0 tower, and the teacher's VE tower (24 layers at width
    64), and for the tracker core; and both equal the seeded variables;
  - ``load_reference_checkpoint`` loads the state_dict strictly into the
    tiny port model (b0, embed 8, 6 + 6 layers, MobileCLIP-S0 at context
    16) and into a tracker core, leaving them bit for bit as
    ``load_jax_variables`` of the seeded variables does, and the image
    model's forward is JAX's within 1e-4 of max(1, |largest|); a key left
    over or missing raises.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import efficientsam3_tpu.utils.convert_backbones as jcb
import efficientsam3_tpu.utils.convert_model as jcm
import efficientsam3_tpu.utils.torch_convert as jtc
from efficientsam3_tpu.build import make_student_trunk as jmake_trunk
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu.models.text_encoder import VETextEncoder as JVETextEncoder
from efficientsam3_tpu.video.tracker import TrackerCore as JCore
from efficientsam3_tpu.video.tracker import init_tracker_variables
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.utils import checkpoint as pckpt
from efficientsam3_tpu_torch.utils import convert_model as pcm
from efficientsam3_tpu_torch.utils.convert import load_jax_variables
from efficientsam3_tpu_torch.video.tracker import TrackerCore


CTX = 16
TRACKER_PREFIX = "inst_interactive_predictor.model"


def random_variables(shapes, seed):
    """Seeded numpy leaves over flax shapes (the parity tests' rule)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf, sh = path[-1].key, s.shape
        if leaf == "var":
            a = rng.uniform(0.5, 1.5, sh)
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(sh)
        elif len(sh) <= 1:
            a = 0.1 * rng.standard_normal(sh)
        elif leaf in ("embedding", "positional_embedding"):
            a = rng.standard_normal(sh) / np.sqrt(sh[-1])
        else:
            a = rng.standard_normal(sh) / np.sqrt(np.prod(sh[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# --------------------------------------------------------------------------
# the converter's inverse
# --------------------------------------------------------------------------


class _E:
    """The width ``e`` a fused in_proj is split by (``w.shape[1]``), as a
    multiple of itself."""

    def __init__(self, k=1):
        self.k = k

    def __rmul__(self, n):
        return _E(self.k * n)

    __mul__ = __rmul__


class _Ref:
    """A reference leaf as the JAX converter sees it: its key and the
    operations applied to it since."""

    shape = (_E(), _E())

    def __init__(self, key, ops=()):
        self.key, self.ops = key, ops

    def _then(self, op):
        return _Ref(self.key, self.ops + (op,))

    @property
    def T(self):
        return self._then(("transpose", (1, 0)))

    def transpose(self, *axes):
        return self._then(("transpose", axes))

    def reshape(self, *shape):
        return self._then(("reshape",))

    def copy(self):
        return self

    def __getitem__(self, index):
        return self._then(("item", index))


class _Recording(dict):
    """A state_dict holding every key: each read returns its marker."""

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        return _Ref(key)


def _chunk(index):
    """Which third of a fused in_proj ``w[:e]`` / ``w[e:2e]`` / ``w[2e:]`` reads."""
    start = index.start if isinstance(index, slice) else index[0].start
    return 0 if start is None else start.k


def _inverse(ref, value):
    """(key, chunk or None, the reference array) holding ``value`` where
    the converter made it from ``ref``."""
    chunk = None
    for op in reversed(ref.ops):
        if op[0] == "transpose":
            value = value.transpose(np.argsort(op[1]))
        elif op[0] == "item":
            if op[1] == 0:  # pos_embed[0]
                value = value[None]
            elif isinstance(op[1], tuple) and op[1][2:] == (slice(None, None, -1),) * 2:
                value = value[:, :, ::-1, ::-1]  # the ConvTranspose flip
            else:  # a third of a fused in_proj
                chunk = _chunk(op[1])
        # a reshape keeps the values in order: store them at the flax shape
    return ref.key, chunk, np.ascontiguousarray(value)


def reference_state_dict(convert, variables, **kw):
    """The reference-layout state_dict from which ``convert`` (a JAX
    converter returning (params, batch_stats)) gives ``variables``."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jtc, jcb, jcm):
            mp.setattr(mod, "_np", lambda t: t)
        params, stats = convert(_Recording(), **kw)
    marks = {"params": params, "batch_stats": stats}
    flat, parts = {}, {}
    for coll, tree in variables.items():
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        for path, value in leaves:
            node = marks[coll]
            for k in path:
                node = node[k.key]
            key, chunk, arr = _inverse(node, np.asarray(value))
            if chunk is None:
                flat[key] = arr
            else:
                parts.setdefault(key, {})[chunk] = arr
    for key, chunks in parts.items():
        flat[key] = np.concatenate([chunks[i] for i in range(3)])
    return flat


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------


def _image_shapes(trunk, text_encoder_type="MobileCLIP-S0", ve=None):
    """flax shapes of a full-depth image model: b0 + MobileCLIP-S0 built
    once, its trunk or text tower swapped for another's."""
    base = _base_shapes()
    out = jax.tree.map(lambda x: x, base)
    if trunk != ("efficientvit", "b0"):
        t = jmake_trunk(*trunk, embed_size=8)
        ts = jax.eval_shape(lambda k: t.init(k, jnp.zeros((1, 112, 112, 3))),
                            jax.random.PRNGKey(0))
        out["params"]["trunk"] = ts["params"]
        out["batch_stats"]["trunk"] = ts.get("batch_stats", {})
    if ve is not None:
        te = JVETextEncoder(context_length=CTX, **ve)
        out["params"]["text_encoder"] = jax.eval_shape(
            lambda k: te.init(k, jnp.zeros((1, CTX), jnp.int32)),
            jax.random.PRNGKey(0))["params"]
        out["batch_stats"].pop("text_encoder", None)
    return out


_BASE = {}


def _base_shapes():
    if not _BASE:
        jm = JModel(trunk=jmake_trunk("efficientvit", "b0", embed_size=8),
                    text_encoder_type="MobileCLIP-S0", text_context_length=CTX)
        _BASE["model"] = jm
        _BASE["shapes"] = jax.eval_shape(
            lambda k: jm.init(k, jnp.zeros((1, 112, 112, 3)), jnp.zeros((1, CTX), jnp.int32),
                              JPrompt.empty(1, 2, 2)), jax.random.PRNGKey(0))
    return _BASE["shapes"]


CASES = {
    "efficientvit_b0": dict(trunk=("efficientvit", "b0"),
                            kw=dict(backbone_type="efficientvit", model_name="b0",
                                    text_encoder_type="MobileCLIP-S0")),
    "repvit_m0.9": dict(trunk=("repvit", "m0.9"),
                        kw=dict(backbone_type="repvit", model_name="m0.9",
                                text_encoder_type="MobileCLIP-S0")),
    "tinyvit_5m": dict(trunk=("tinyvit", "5m"),
                       kw=dict(backbone_type="tinyvit", model_name="5m",
                               text_encoder_type="MobileCLIP-S0")),
    "ve_tower": dict(trunk=("efficientvit", "b0"), ve=dict(width=64, heads=2, layers=24),
                     kw=dict(backbone_type="efficientvit", model_name="b0",
                             text_encoder_type=None)),
}


def _equal_trees(got, want):
    g = dict(jax.tree_util.tree_leaves_with_path(got))
    w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert g.keys() == w.keys()
    for k, v in w.items():
        assert np.array_equal(np.asarray(g[k]), np.asarray(v)), jax.tree_util.keystr(k)


@pytest.fixture(scope="module")
def image_case_data():
    return {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_image_model_matches_jax(case, image_case_data):
    """The port's convert_image_model equals JAX's, leaf for leaf and bit
    for bit, and both give back the seeded variables the state_dict was
    made from."""
    c = CASES[case]
    shapes = _image_shapes(c["trunk"], ve=c.get("ve"))
    variables = random_variables(shapes, seed=len(case))
    variables = {k: v for k, v in variables.items() if v}
    sd = reference_state_dict(jcm.convert_image_model, variables, **c["kw"])
    want_p, want_s = jcm.convert_image_model(sd, **c["kw"])
    got_p, got_s = pcm.convert_image_model(sd, **c["kw"])
    _equal_trees(got_p, want_p)
    _equal_trees(got_s, want_s)
    _equal_trees(want_p, variables["params"])
    _equal_trees({k: v for k, v in want_s.items() if v},
                 {k: v for k, v in variables.get("batch_stats", {}).items() if v})
    image_case_data[case] = (variables, sd)


def _tracker():
    jcore = JCore(image_size=112, backbone_stride=14)
    shapes = jax.eval_shape(lambda k: init_tracker_variables(jcore, k), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=11)
    return variables, reference_state_dict(jcm.convert_tracker_core, variables,
                                           p=TRACKER_PREFIX)


def test_convert_tracker_core_matches_jax():
    """convert_tracker_core: the port's equals JAX's bit for bit, and both
    give back the seeded tracker variables."""
    variables, sd = _tracker()
    want_p, _ = jcm.convert_tracker_core(sd, p=TRACKER_PREFIX)
    got_p, _ = pcm.convert_tracker_core(sd, p=TRACKER_PREFIX)
    _equal_trees(got_p, want_p)
    _equal_trees(want_p, variables["params"])


def test_load_reference_checkpoint_into_tracker_core(tmp_path):
    """A tracker core (112^2 frames, 8^2 tokens) loaded strictly from a
    reference .pt file on disk through load_torch_state_dict's cleanup (a
    'detector.' prefix and a 'model' wrapper), bit for bit as from the
    seeded variables."""
    variables, sd = _tracker()
    path = tmp_path / "ref.pt"
    torch.save({"model": {f"detector.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    got = pckpt.load_reference_checkpoint(TrackerCore(image_size=112, backbone_stride=14),
                                          str(path), part="tracker", p=TRACKER_PREFIX)
    want = load_jax_variables(TrackerCore(image_size=112, backbone_stride=14), variables)
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


def test_load_reference_checkpoint_matches_jax_outputs(image_case_data):
    """The tiny image model (b0, embed 8, 6 + 6 layers, MobileCLIP-S0)
    loaded strictly from the reference state_dict holds the seeded
    variables bit for bit, and its forward is JAX's on them within 1e-4 of
    max(1, |largest|); a key left over or a key missing raises."""
    if "efficientvit_b0" not in image_case_data:
        test_convert_image_model_matches_jax("efficientvit_b0", image_case_data)
    variables, sd = image_case_data["efficientvit_b0"]
    kw = CASES["efficientvit_b0"]["kw"]

    def port():
        return build_efficientsam3_image_model(model_name="b0", embed_size=8,
                                               text_encoder_context_length=CTX, device="cpu")

    got = pckpt.load_reference_checkpoint(port(), sd, **kw)
    want = load_jax_variables(port(), variables).state_dict()
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k

    rng = np.random.default_rng(5)
    images = (0.5 * rng.standard_normal((1, 112, 112, 3))).astype(np.float32)
    tokens = np.zeros((1, CTX), np.int32)
    tokens[0, :4] = [49406, 320, 1125, 49407]
    jm = _BASE["model"]
    jout = jax.jit(lambda v, i, t: jm.apply(v, i, t, JPrompt.empty(1, 2, 2)))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images), jnp.asarray(tokens))
    with torch.no_grad():
        pout = got(torch.from_numpy(images), torch.from_numpy(tokens).long(),
                   Prompt.empty(1, 2, 2))
    for k in ("pred_logits", "pred_boxes", "pred_masks", "presence_logit_dec"):
        w = np.asarray(jout[k])
        err = np.abs(pout[k].numpy() - w).max()
        assert err <= 1e-4 * max(1.0, np.abs(w).max()), (k, err)

    missing = next(k for k in sd if k.startswith("segmentation_head."))
    with pytest.raises(KeyError):  # the converter reads every key it needs
        pckpt.load_reference_checkpoint(port(), {k: v for k, v in sd.items() if k != missing},
                                        **kw)
    shallow = build_efficientsam3_image_model(model_name="b0", embed_size=8, decoder_layers=5,
                                              text_encoder_context_length=CTX, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):  # decoder layer 5 left over
        pckpt.load_reference_checkpoint(shallow, sd, **kw)
