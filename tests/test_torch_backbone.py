"""Image and text encoders of the PyTorch port against the JAX modules:
EfficientViT b0, the student projection head, the dual FPN neck and the
MobileCLIP-S0 text tower.

Each JAX module's variables are drawn with numpy from a seed over the
shapes ``jax.eval_shape(module.init)`` reports, carried across by
``utils/convert.py``, and both modules run the same numpy inputs in fp32.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from efficientsam3_tpu.models import efficientvit as jev
from efficientsam3_tpu.models import mobile_clip as jmc
from efficientsam3_tpu.models import necks as jnk
from efficientsam3_tpu.models import student_encoder as jse
from efficientsam3_tpu_torch.models import efficientvit as ev
from efficientsam3_tpu_torch.models import mobile_clip as mc
from efficientsam3_tpu_torch.models import necks as nk
from efficientsam3_tpu_torch.models import student_encoder as se
from efficientsam3_tpu_torch.utils.convert import load_jax_variables

# fp32 on both sides; convolutions and products sum in other orders on
# XLA:CPU and ATen: ~1e-6 relative per layer, 2e-5 after a dozen layers
TOL = 2e-5


def random_variables(module, *args, seed=0, **kw):
    """Seeded numpy values over the module's variable shapes: fan-in
    scaled kernels, positive BatchNorm variances, scales near 1."""
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

    # static arguments (map sizes, flags) stay Python values: close over them
    shapes = jax.eval_shape(lambda key: module.init(key, *args, **kw), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _image(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_efficientvit_b0_trunk():
    x = _image(1, 1, 64, 64, 3)
    jm = jev.efficientvit_b0()
    v = random_variables(jm, jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = load_jax_variables(ev.efficientvit_b0().eval(), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert_close(got, want)


def test_student_encoder_head_and_resize():
    """b0 trunk + 1x1 conv/BN/GELU/3x3 conv head, resized 2x2 -> 8x8."""
    x = _image(2, 1, 64, 64, 3)
    jm = jse.ImageStudentEncoder(trunk=jev.efficientvit_b0(), embed_dim=64, embed_size=8)
    v = random_variables(jm, jnp.asarray(x), seed=1)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = se.ImageStudentEncoder(ev.efficientvit_b0(), 128, embed_dim=64, embed_size=8).eval()
    load_jax_variables(pm, v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert_close(got, want)


def test_dual_fpn_neck():
    """All four scales (convT x2, convT, identity, maxpool) and their sine
    position embeddings, plus the cloned SAM2 neck."""
    x = _image(3, 1, 6, 6, 64)
    jm = jnk.DualFPNNeck(d_model=32, add_sam2_neck=True)
    v = random_variables(jm, jnp.asarray(x), seed=2)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = load_jax_variables(nk.DualFPNNeck(64, 32, add_sam2_neck=True), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            assert_close(g, w)


def test_mobileclip_s0_text_tower():
    """RepMixer + 4 transformer layers + RepMixer + projector at context 16,
    with padded tokens; the pad mask is tokens == 0."""
    tokens = np.zeros((2, 16), np.int32)
    tokens[0, :5] = [49406, 320, 1125, 3309, 49407]
    tokens[1, :3] = [49406, 2368, 49407]
    jm = jmc.TextStudentEncoder("MobileCLIP-S0", context_length=16, output_dim=256)
    v = random_variables(jm, jnp.asarray(tokens), seed=3)
    want_mem, want_mask = jax.jit(jm.apply)(v, jnp.asarray(tokens))
    pm = load_jax_variables(mc.TextStudentEncoder("MobileCLIP-S0", 16, 256).eval(), v)
    with torch.no_grad():
        got_mem, got_mask = pm(torch.from_numpy(tokens).long())
    assert_close(got_mem, want_mem)
    assert np.array_equal(got_mask.numpy(), np.asarray(want_mask))
