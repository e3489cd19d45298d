"""The SAM1 students' trunks of the PyTorch port against the JAX package,
on the CPU in fp32: RepViT and TinyViT at narrow custom configurations,
EfficientViT-b2 at its full widths on a 64^2 input, RepViT's deploy-time
fold (``fuse_repvit_state_dict``) against JAX's ``fuse_repvit_params`` and
against the unfused module, and the key maps of the full m1.1, 5m and b2
trunks under the image model's projection head (the port's modules on
``meta`` against ``jax.eval_shape`` of the JAX ``init``, every key and
shape both ways).

Variables are drawn with numpy over ``jax.eval_shape`` shapes (BatchNorm
running variances in [0.5, 1.5], means and biases around 0, so the
eval-mode normalisation is not the identity) and carried across by
``utils/convert.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientsam3_tpu import build as jbuild
from efficientsam3_tpu.models import efficientvit as jev
from efficientsam3_tpu.models import repvit as jrv
from efficientsam3_tpu.models import tiny_vit as jtv
from efficientsam3_tpu_torch.build import make_student_trunk, make_trunk
from efficientsam3_tpu_torch.models import repvit as prv
from efficientsam3_tpu_torch.models import tiny_vit as ptv
from efficientsam3_tpu_torch.utils.convert import (
    convert_variables,
    converted_shapes,
    load_jax_variables,
)

# fp32 through a few conv / attention blocks summed in other orders on
# XLA:CPU and ATen, of max(1, |largest|)
TOL = 1e-4
# RepViT: stride-2 blocks with and without SE, RepVGG blocks with and without SE
REPVIT_CFGS = ((16, 1, 1), (16, 0, 1), (32, 0, 2), (32, 1, 1), (32, 0, 1), (48, 0, 2),
               (48, 1, 1))
# TinyViT at 112^2: stage 1 at 14x14 (2x2 windows of 7), stage 2 at 7x7 (one
# whole window), stage 3 at 4x4 (padded to one window of 7)
TINYVIT = dict(embed_dims=(16, 32, 48, 64), depths=(1, 2, 1, 1), num_heads=(1, 2, 3, 4),
               window_sizes=(7, 7, 7, 7))


def random_variables(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf, sh = path[-1].key, s.shape
        if leaf == "var":
            a = rng.uniform(0.5, 1.5, sh)
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(sh)
        elif len(sh) == 1 or leaf == "attention_biases":
            a = 0.1 * rng.standard_normal(sh)
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


def _image(size, seed=1):
    return np.random.default_rng(seed).standard_normal((1, size, size, 3)).astype(np.float32)


def _run_pair(jm, pm, size, seed=0):
    x = _image(size)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                                jnp.asarray(x)), seed)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))  # one compile, not one an op
    load_jax_variables(pm.eval(), variables)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    return got, want, variables, x


@pytest.mark.parametrize("name", ["repvit", "tinyvit", "efficientvit_b2"])
def test_trunk_matches_jax(name):
    """Each trunk's final map: RepViT at 64^2 (stride 32: 2x2), the TinyViT
    configuration above at 112^2 (4x4), b2 at 64^2 (2x2x384: its head
    dim 32 LiteMLA)."""
    if name == "repvit":
        jm, pm, size = jrv.RepViT(cfgs=REPVIT_CFGS), prv.RepViT(REPVIT_CFGS), 64
    elif name == "tinyvit":
        jm, pm, size = jtv.TinyViT(**TINYVIT), ptv.TinyViT(**TINYVIT), 112
    else:
        jm = jbuild.BACKBONE_REGISTRY["efficientvit"]["b2"]()
        pm, size = make_trunk("efficientvit", "l"), 64
    got, want, _, _ = _run_pair(jm, pm, size)
    assert got.shape[-1] == pm.out_channels
    assert_close(got, want)


def test_repvit_fold_matches_jax_and_the_unfused_module():
    """``fuse_repvit_state_dict`` against the JAX fold of the same
    variables, key by key (1e-5 of each tensor's largest magnitude), and
    the deploy-form module it loads into against the train-form module in
    eval mode (1e-4: the folded kernels round once more)."""
    jm, pm = jrv.RepViT(cfgs=REPVIT_CFGS), prv.RepViT(REPVIT_CFGS)
    unfused, _, variables, x = _run_pair(jm, pm, 64, seed=3)
    fused = prv.fuse_repvit_state_dict(pm.state_dict(), REPVIT_CFGS)
    want = convert_variables({"params": jrv.fuse_repvit_params(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]), REPVIT_CFGS)})
    assert fused.keys() == want.keys()
    for k, v in want.items():
        assert_close(fused[k], v, 1e-5)
    deploy = prv.RepViT(REPVIT_CFGS, deploy=True).eval()
    deploy.load_state_dict(fused, strict=True)
    with torch.no_grad():
        got = deploy(torch.from_numpy(x))
    assert_close(got, unfused)
    jdeploy = jrv.RepViT(cfgs=REPVIT_CFGS, deploy=True)
    assert_close(got, jax.jit(jdeploy.apply)({"params": jrv.fuse_repvit_params(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]), REPVIT_CFGS)},
        jnp.asarray(x)))


@pytest.mark.parametrize("backbone,name", [("repvit", "m1.1"), ("tinyvit", "5m"),
                                           ("efficientvit", "b2")])
def test_full_trunk_key_map_matches_jax(backbone, name):
    """The full-size trunk under the image model's student projection head
    (``build.make_student_trunk``, which took only EfficientViT b0 / b1
    before these trunks were ported): the state_dict keys and shapes on
    ``meta`` against the converted ``jax.eval_shape`` of the JAX
    ``make_student_trunk``'s ``init``, both ways, and the trunk's output
    width against the JAX tables."""
    jm = jbuild.make_student_trunk(backbone, name)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = converted_shapes(shapes)
    with torch.device("meta"):
        pm = make_student_trunk(backbone, name)
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert sorted(got.keys() - want.keys()) == [] and sorted(want.keys() - got.keys()) == []
    assert got == want
    tables = {"repvit": jrv.REPVIT_OUT_CHANNELS, "tinyvit": jtv.TINYVIT_OUT_CHANNELS,
              "efficientvit": jev.EFFICIENTVIT_OUT_CHANNELS}
    assert pm.trunk.out_channels == tables[backbone][name]
