"""The tensor-core probe's chain in the PyTorch port against the JAX probe,
on the CPU.

``scripts/probe_int8_mxu.py`` is loaded by path (it is a script, not a
module of the package) and its Pallas body ``_kernel`` runs through
``pl.pallas_call(..., interpret=True)``. The same numpy operands, made from
a seed, go through it and through the port's ``dot_chain`` on CPU tensors
(its plain version ``dot_chain_plain``, which the CUDA kernel
``csrc/mma_probe.cu`` is held against on the card). int8 operands give
int32 products and an fp32 chain of integers below 2^24: the same values
exactly. bf16 operands give fp32 products whose sums over k run in other
orders: within 1e-5 of the largest magnitude.
"""

import functools
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from efficientsam3_tpu_torch.ops import mma_probe

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "probe_int8_mxu.py"


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe script as a module; the environment it sets defaults
    in is put back as it was."""
    env = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location("probe_int8_mxu", SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return mod


def _operands(dtype, m, k, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        x = rng.integers(-127, 127, (m, k)).astype(np.int8)
        y = rng.integers(-127, 127, (k, n)).astype(np.int8)
        return (jnp.asarray(x), jnp.asarray(y)), (torch.from_numpy(x), torch.from_numpy(y))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)  # bf16 values: exact both ways
    jy = jnp.asarray(y.float().numpy(), jnp.bfloat16)
    return (jx, jy), (x, y)


@pytest.mark.parametrize("m,k,n,n_iter", [(48, 64, 40, 4), (16, 32, 8, 3)])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_dot_chain_matches_jax_probe_kernel(jax_probe, dtype, m, k, n, n_iter):
    (jx, jy), (tx, ty) = _operands(dtype, m, k, n, seed=m + n_iter)
    jdt = jnp.int8 if dtype == "int8" else jnp.bfloat16
    call = pl.pallas_call(
        functools.partial(jax_probe._kernel, n_iter=n_iter, dtype=jdt),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32), interpret=True)
    want = np.asarray(call(jx, jy))
    before = mma_probe.dot_chain.launches
    got = mma_probe.dot_chain(tx, ty, n_iter)
    assert mma_probe.dot_chain.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (m, n)
    got = got.numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mma_probe.dot_chain_plain(tx, ty, n_iter).numpy(), want)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
