"""Sampling ops of the PyTorch port against the JAX package: bilinear
resize (torch semantics), the processor's antialiased resize
(jax.image.resize), grid_sample and roi_align on the JAX sample grid.

Inputs are made with numpy from a seed and handed to both packages; all
in fp32.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from efficientsam3_tpu.ops.interpolate import resize_bilinear as jax_resize_bilinear
from efficientsam3_tpu.ops.roi_align import roi_align as jax_roi_align
from efficientsam3_tpu.utils.tokenizer import ClipTokenizer as JaxTokenizer
from efficientsam3_tpu_torch.ops.grid_sample import grid_sample
from efficientsam3_tpu_torch.ops.interpolate import resize_antialiased, resize_bilinear
from efficientsam3_tpu_torch.ops.roi_align import roi_align
from efficientsam3_tpu_torch.utils.tokenizer import ClipTokenizer

RNG = np.random.default_rng(5)


def _assert_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("size", [(29, 47), (8, 5), (13, 40)])
def test_resize_bilinear(size):
    """Up, down and mixed. fp32 products of two-tap weights: 1e-5 relative
    covers the summation order."""
    x = RNG.standard_normal((2, 3, 13, 17)).astype(np.float32)
    want = jax_resize_bilinear(jnp.asarray(x), size)
    got = resize_bilinear(torch.from_numpy(x), size)
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("hw,res", [((48, 80), 64), ((200, 300), 112), ((30, 20), 64)])
def test_resize_antialiased_matches_jax_image_resize(hw, res):
    """Down and up, non-square inputs, the processor's resize. JAX runs the
    weights as one fp32 einsum in another order: 1e-4 of the [0, 1] range."""
    img = RNG.random(hw + (3,)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (res, res, 3), "linear", antialias=True)
    got = resize_antialiased(torch.from_numpy(img), (res, res))
    _assert_close(got, want, 1e-4)


@pytest.mark.parametrize("spread", [0.8, 1.2])
def test_grid_sample(spread):
    """Points inside and (spread 1.2) outside [-1, 1], zero padding; same
    gathers on both sides, so fp32 bilinear blends agree to rounding."""
    x = RNG.standard_normal((2, 4, 9, 11)).astype(np.float32)
    grid = RNG.uniform(-spread, spread, (2, 5, 3, 2)).astype(np.float32)
    want = jax_grid_sample(jnp.asarray(x), jnp.asarray(grid))
    got = grid_sample(torch.from_numpy(x), torch.from_numpy(grid))
    _assert_close(got, want, 1e-6)


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_roi_align(scale):
    """The geometry encoder's settings (adaptive grid, aligned=False) on
    boxes partly outside the map, small and (scale 3) large enough to need
    many samples per bin. Two fp32 products per ROI: 1e-5 relative."""
    feats = RNG.standard_normal((2, 3, 36, 48)).astype(np.float32)
    boxes = scale * np.array([[1.0, 2.0, 9.5, 10.0], [-2.0, 0.5, 6.0, 4.0],
                              [3.0, 3.0, 15.9, 11.9], [5.0, 5.0, 5.5, 5.2]], np.float32)
    bidx = np.array([0, 1, 1, 0], np.int32)
    want = jax_roi_align(jnp.asarray(feats), jnp.asarray(boxes), jnp.asarray(bidx), (7, 7),
                         sampling_ratio=-1, aligned=False)
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(boxes),
                    torch.from_numpy(bidx).long(), (7, 7))
    _assert_close(got, want, 1e-5)


def test_tokenizer_copy_matches(tmp_path):
    """The port's copy of the CLIP tokenizer encodes like the JAX package's,
    on a small merge table (the CLIP vocab is not in the repository)."""
    import gzip

    bpe = tmp_path / "vocab.txt.gz"
    with gzip.open(bpe, "wt") as f:
        f.write("#version\nt h\nth e</w>\nc a\nca t</w>\n")
    texts = ["the cat", "A red   ball &amp; the CAT!", "x" * 40]
    want = JaxTokenizer(str(bpe))(texts, 16)
    got = ClipTokenizer(str(bpe))(texts, 16)
    assert np.array_equal(got, want)
