"""Which attentions the port sends to its flash kernels (``models/common.
flash_eligible``, decided from shapes and dtypes alone), and that one the
kernels do not take runs on the matmul path with JAX's numerics.

JAX's rule sends every large attention (Lq * Lk >= 2^22, no full bias, at
most a key-padding mask) to its Pallas kernel, which takes any head dim and
dtype. The port's kernels take head dims 32, 64, 80 and 256 (the bank
kernels (dk, dv) = (256, 64)) in bf16 or fp32, all operands of one dtype;
the rule adds those sets, and the rest takes the matmul path, which is
JAX's own fallback. A CPU tensor takes the matmul path whatever the rule
says, as in JAX off the TPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

from efficientsam3_tpu.models import common as jcommon
from efficientsam3_tpu_torch.models import common

BF16, F32, F16, F64 = torch.bfloat16, torch.float32, torch.float16, torch.float64


def _mask(b, lk):
    return (b, 1, 1, lk)


# (q, k, v shapes, float dtypes, keyword arguments, whether a kernel takes it)
CASES = [
    # the shipped shapes: the fusion encoder, the teacher's and vit_h's
    # global blocks, the tracker's memory attention (self, the plain path's
    # cross-attention, the cached bank with exact and int8 keys)
    ("fusion", (1, 8, 5184, 32), (1, 8, 5184, 32), (1, 8, 5184, 32), (BF16,) * 3, {},
     True),
    ("fusion-fp32-step", (4, 8, 5184, 32), (4, 8, 5184, 32), (4, 8, 5184, 32), (F32,) * 3, {},
     True),
    ("teacher", (1, 16, 5184, 64), (1, 16, 5184, 64), (1, 16, 5184, 64), (F32,) * 3, {},
     True),
    ("vit_h", (1, 16, 4900, 80), (1, 16, 4900, 80), (1, 16, 4900, 80), (BF16,) * 3, {},
     True),
    ("memattn-self", (8, 1, 5184, 256), (8, 1, 5184, 256), (8, 1, 5184, 256), (BF16,) * 3,
     {"mask_shape": _mask(8, 5184)}, True),
    ("memattn-cross", (8, 1, 5184, 256), (8, 1, 36352, 256), (8, 1, 36352, 256), (F32,) * 3,
     {"mask_shape": _mask(8, 36352)}, True),
    ("bank", (8, 1, 5184, 256), (8, 1, 36864, 256), (8, 1, 36864, 64), (BF16,) * 3,
     {"mask_shape": _mask(8, 36864), "rawv": True}, True),
    ("bank-q8", (8, 1, 5184, 256), (8, 1, 36864, 256), (8, 1, 36864, 64), (F32,) * 2,
     {"mask_shape": _mask(8, 36864), "rawv": True}, True),
    # what the kernels do not take: the matmul path, where JAX's kernel runs
    ("d128", (1, 4, 4096, 128), (1, 4, 4096, 128), (1, 4, 4096, 128), (BF16,) * 3, {}, False),
    ("d128-fp32", (1, 1, 2048, 128), (1, 1, 2048, 128), (1, 1, 2048, 128), (F32,) * 3, {},
     False),
    ("fp16", (1, 8, 5184, 32), (1, 8, 5184, 32), (1, 8, 5184, 32), (F16,) * 3, {}, False),
    ("fp64", (8, 1, 5184, 256), (8, 1, 5184, 256), (8, 1, 5184, 256), (F64,) * 3, {}, False),
    ("mixed", (1, 16, 5184, 64), (1, 16, 5184, 64), (1, 16, 5184, 64), (BF16, F32, BF16), {},
     False),
    ("v-wider", (1, 8, 5184, 32), (1, 8, 5184, 32), (1, 8, 5184, 64), (BF16,) * 3, {}, False),
    ("bank-dv32", (8, 1, 5184, 256), (8, 1, 36864, 256), (8, 1, 36864, 32), (BF16,) * 3,
     {"rawv": True}, False),
    ("bank-fp16", (8, 1, 5184, 256), (8, 1, 36864, 256), (8, 1, 36864, 64), (F16,) * 3,
     {"rawv": True}, False),
    # JAX's own rule: small, a full bias, a mask that is not a key mask
    ("small", (1, 8, 200, 32), (1, 8, 5184, 32), (1, 8, 5184, 32), (BF16,) * 3, {}, False),
    ("bias", (1, 8, 5184, 32), (1, 8, 5184, 32), (1, 8, 5184, 32), (BF16,) * 3,
     {"bias": True}, False),
    ("query-mask", (1, 8, 5184, 32), (1, 8, 5184, 32), (1, 8, 5184, 32), (BF16,) * 3,
     {"mask_shape": (1, 1, 5184, 5184)}, False),
]


@pytest.mark.parametrize("name,q,k,v,dtypes,kw,expect", CASES, ids=[c[0] for c in CASES])
def test_flash_eligible(name, q, k, v, dtypes, kw, expect):
    assert common.flash_eligible(q, k, v, dtypes, **kw) is expect


def test_cpu_tensors_take_the_matmul_path():
    """The shipped fusion-encoder shape is routed to the kernel by shape and
    dtype, but tensors off CUDA (here on ``meta``, no storage) take the
    matmul path."""
    q = torch.empty((1, 8, 5184, 32), dtype=BF16, device="meta")
    assert common.flash_eligible(q.shape, q.shape, q.shape, (q.dtype,) * 3)
    assert not common._use_flash(q, q, q, None, None)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), ("bfloat16", 1e-2)],
                         ids=["fp32", "bf16"])
def test_sdpa_at_head_dim_128_matches_jax(dtype, tol):
    """A large attention at d = 128 (2048 x 2048 scores, at the threshold,
    no kernel takes it) with a key-padding mask: the port's ``sdpa`` and
    JAX's on the same seeded inputs, fp32 within 1e-5 and bf16 within 1e-2
    of the largest magnitude (one bf16 ulp after sums in other orders)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 2048, 128)).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 1, 1, 2048), bool)
    mask[0, ..., 1500:] = False
    mask[1, ..., :64] = False
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    assert not common.flash_eligible(q.shape, k.shape, v.shape, (tdt,) * 3, mask_shape=mask.shape)
    want = jcommon.sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), mask=jnp.asarray(mask))
    got = common.sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                      mask=torch.from_numpy(mask))
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err
