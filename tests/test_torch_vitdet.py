"""The SAM3 teacher's towers of the PyTorch port against the JAX package,
on the CPU in fp32: the axial RoPE tables and their pair rotation, a tiny
ViTDet trunk (112^2, width 128, 2 heads of 64, depth 4, window 4, global
blocks 1 and 3, pretraining grid 4) and a tiny CLIP text tower (width 64,
4 heads, 2 layers, context 16, padded ids), and the trunk's training mode
(tests/test_torch_stage1_slice.py holds it against JAX).

Inputs and weights are drawn with numpy from a seed; the weights over the
shapes ``jax.eval_shape`` reports, carried across by ``utils/convert.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientsam3_tpu.models import text_encoder as jte
from efficientsam3_tpu.models import vitdet as jvit
from efficientsam3_tpu_torch.build import init_parameters
from efficientsam3_tpu_torch.models import text_encoder as pte
from efficientsam3_tpu_torch.models import vitdet as pvit
from efficientsam3_tpu_torch.models.common import apply_rope, compute_axial_rope_cos_sin
from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.utils.convert import load_jax_variables

TRUNK = dict(embed_dim=128, depth=4, num_heads=2, window_size=4, global_att_blocks=(1, 3),
             pretrain_grid=4)
TEXT = dict(d_model=256, context_length=16, width=64, heads=4, layers=2)
TOKENS = np.array([[49406, 320, 1125, 3309, 49407] + [0] * 11,
                   [49406, 518, 49407] + [0] * 13], np.int32)


def random_variables(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf, sh = path[-1].key, s.shape
        if leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(sh)
        elif len(sh) == 1:
            a = 0.1 * rng.standard_normal(sh)
        elif leaf in ("embedding", "positional_embedding", "pos_embed"):
            a = rng.standard_normal(sh) / np.sqrt(sh[-1])
        else:
            a = rng.standard_normal(sh) / np.sqrt(np.prod(sh[:-1]))
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("head_dim,grid,scale_pos",
                         [(64, 8, 3.0), (64, 4, 6.0), (64, 72, 1 / 3), (80, 24, 1.0)])
def test_rope_tables_and_rotation_match_jax(head_dim, grid, scale_pos):
    """The JAX ``axial_rope_cos_sin`` and ``apply_rope_pairs`` against the
    port's common ones, which ViTAttention uses: the tables of the tiny
    config's global (24 / 8) and windowed (24 / 4) blocks, of the full
    trunk's global blocks (24 / 72), and a d=80 grid; the adjacent-pair
    rotation of q in fp32 (1e-6)."""
    want_cos, want_sin = jvit.axial_rope_cos_sin(head_dim, grid, grid, 10000.0, scale_pos)
    cos, sin = compute_axial_rope_cos_sin(head_dim, grid, grid, 10000.0, scale_pos=scale_pos)
    assert_close(cos, want_cos, 1e-6)
    assert_close(sin, want_sin, 1e-6)
    q = np.random.default_rng(1).standard_normal((2, 3, grid * grid, head_dim))
    q = q.astype(np.float32)
    assert_close(apply_rope(torch.from_numpy(q), cos, sin),
                 jvit.apply_rope_pairs(jnp.asarray(q), want_cos, want_sin), 1e-6)


def test_vit_trunk_matches_jax():
    """Two windowed and two global blocks (windows of 4 on an 8x8 grid: the
    partition order; RoPE scales 24 / 4 and 24 / 8), the position embedding
    tiled 2x2, at 1e-4 of max(1, |largest|) (fp32 through 4 blocks summed
    in other orders)."""
    jm = jvit.ViTTrunk(**TRUNK)
    x = np.random.default_rng(2).standard_normal((1, 112, 112, 3)).astype(np.float32)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x))
    pm = pvit.ViTTrunk(**TRUNK).eval()
    load_jax_variables(pm, variables)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (1, 8, 8, 128)
    assert_close(got, want, 1e-4)


def test_text_encoder_matches_jax():
    """Causal attention (the additive finfo.min bias), padded ids, ln_final
    and the resizer; the pad mask (1e-5: two layers of fp32)."""
    jm = jte.VETextEncoder(**TEXT)
    variables = random_variables(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(TOKENS)), seed=1)
    want, want_mask = jm.apply(variables, jnp.asarray(TOKENS))
    pm = pte.VETextEncoder(**TEXT).eval()
    load_jax_variables(pm, variables)
    with torch.no_grad():
        got, mask = pm(torch.from_numpy(TOKENS).long())
    assert got.shape == (2, 16, 256)
    assert_close(got, want, 1e-5)
    assert np.array_equal(mask.numpy(), np.asarray(want_mask))


def test_trunk_and_d64_backward_refuse_training():
    """What used to refuse training now takes it: the trunk trains (at
    drop_path_rate 0 without a generator, checkpointed blocks, a finite
    gradient for every parameter), and the backward kernels' head-dim rule
    takes d=64 and d=80 beside 32 and 256, while it still refuses a head
    dim no kernel was built for (48)."""
    trunk = pvit.ViTTrunk(drop_path_rate=0.0, **TRUNK).train()
    init_parameters(trunk)
    trunk(torch.randn(1, 112, 112, 3)).square().mean().backward()
    assert all(torch.isfinite(p.grad).all() for p in trunk.parameters())
    for d in (32, 64, 80, 256):
        q = torch.zeros(1, 2, 4, d)
        assert fa._check_heads("flash_sdpa", fa._SUPPORTED_D, q) == torch.float32
        assert fa._check_heads("flash_sdpa backward", fa._BWD_D, q) == torch.float32
    with pytest.raises(ValueError, match="head dims"):
        fa._check_heads("flash_sdpa backward", fa._BWD_D, torch.zeros(1, 2, 4, 48))
