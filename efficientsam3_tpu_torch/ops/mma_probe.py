"""Tensor-core rate probe: int8 -> int32 against bf16 -> f32 products.

Counterpart of scripts/probe_int8_mxu.py (``bench_dot`` / ``_kernel``, the
Pallas probe that decided whether the int8 key bank was worth building for
the TPU): ``dot_chain`` computes, in one kernel launch
(``csrc/mma_probe.cu``, on ``wgmma``: m64n64k32.s32.s8.s8 and
m64n64k16.f32.bf16.bf16, the bank kernels' instructions), n_iter products d
= x @ y over x (m, k) held in registers and y (k, n) in shared memory,
accumulated as acc += d * (1 + i) in fp32 into an (m, n) f32 output;
``bench_dot`` times it with CUDA events and prints ms per call and
T(FL)OPS, as the JAX script does, and ``chain_clocks`` reads the kernel's
clock64 sections (staging, waiting on the tensor cores, converting each
product). Run it on the card:

    python3 -m efficientsam3_tpu_torch.ops.mma_probe

``dot_chain_plain`` is the same chain with PyTorch matmuls (the CPU path and
the kernel's check). The kernel launches are counted in
``dot_chain.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from efficientsam3_tpu_torch.ops import _build

_DTYPES = (torch.int8, torch.bfloat16)
_MAX_ROW_BYTES = 992  # a row of x or y at most (mma_probe.cu KMAX_BYTES)
_TILE = 64  # output rows and columns a block (mma_probe.cu BM, BN)


def _lib():
    """``mma_probe_dot_chain`` of csrc/mma_probe.cu: x, y, out; m, k, n,
    n_iter, int8; the clocks (or null); the stream."""
    fn = _build.load("mma_probe").mma_probe_dot_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def _lib_attrs():
    fn = _build.load("mma_probe").mma_probe_attrs
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kernel_resources(dtype):
    """Registers and spilled bytes a thread, shared memory a block and
    resident blocks an SM of the chain's kernel at k = 256, on the current
    device."""
    out = (ctypes.c_int * 4)()
    _build.check(_lib_attrs()(int(dtype == torch.int8), out), "mma_probe attributes")
    return dict(zip(("registers", "spill_bytes", "smem_bytes", "blocks_per_sm"), out))


def dot_chain_plain(x, y, n_iter: int = 64):
    """sum_i (x @ y) * (1 + i) in fp32, one product per step as the kernel
    does. int8 operands multiply in fp32, which is exact while 127 * 127 * k
    < 2^24 (k <= 1040)."""
    acc = torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32, device=x.device)
    xf, yf = x.float(), y.float()
    for i in range(n_iter):
        acc = acc + torch.matmul(xf, yf) * (1.0 + i)
    return acc


def _launch(x, y, n_iter, clocks):
    """One launch of the chain's kernel (uncounted)."""
    (m, k), n = x.shape, y.shape[1]
    row_bytes = k * x.element_size()
    if row_bytes % 32 != 0 or row_bytes > _MAX_ROW_BYTES:
        raise ValueError(f"mma_probe kernel takes k with k * itemsize a multiple of 32 and at most "
                         f"{_MAX_ROW_BYTES} bytes, got k = {k} ({x.dtype})")
    x, y = x.contiguous(), y.contiguous()
    if x.data_ptr() % 4:  # the kernel reads x's rows by 32-bit words
        x = x.clone()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        status = _lib()(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, k, n, n_iter,
                        int(x.dtype == torch.int8), None if clocks is None else clocks.data_ptr(),
                        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "mma_probe launch")
    return out


def _check(x, y):
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"dot_chain takes int8 or bfloat16 operands, got {x.dtype}, {y.dtype}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"dot_chain shapes: x {tuple(x.shape)} y {tuple(y.shape)}")


def dot_chain(x, y, n_iter: int = 64):
    """The chained product on the tensor cores: x (m, k), y (k, n), both int8
    (int32 products) or both bf16 (f32 products) -> (m, n) f32. One kernel
    launch on CUDA; CPU tensors take the plain version."""
    _check(x, y)
    if not x.is_cuda:
        return dot_chain_plain(x, y, n_iter)
    _build.refuse_grad("mma_probe", x, y)
    if n_iter < 1:  # no product: the plain version's zeros, no launch
        return torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32, device=x.device)
    out = _launch(x, y, n_iter, None)
    dot_chain.launches += 1
    return out


dot_chain.launches = 0


def chain_clocks(x, y, n_iter: int = 64):
    """One launch of the chain on CUDA operands with the kernel's clock64
    sections (uncounted): the mean over blocks of the clocks a block spent
    staging y and its A fragments, waiting on the tensor cores, converting
    products into acc, and in all; and the output."""
    _check(x, y)
    if not x.is_cuda:
        raise ValueError("chain_clocks reads the kernel's clocks: CUDA operands only")
    blocks = -(-x.shape[0] // _TILE) * -(-y.shape[1] // _TILE)
    clocks = torch.zeros((blocks, 4), dtype=torch.int64, device=x.device)
    out = _launch(x, y, n_iter, clocks)
    means = clocks.double().mean(0).tolist()
    return dict(zip(("staging", "waiting", "converting", "block"), means)), out


def probe_operands(dtype, m: int = 768, k: int = 256, n: int = 2048, seed: int = 0, device=None):
    """Seeded operands as the JAX probe draws them: integers in [-127, 127)
    for int8, unit normals for bf16."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        x, y = rng.integers(-127, 127, (m, k)), rng.integers(-127, 127, (k, n))
    else:
        x, y = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    return (torch.as_tensor(x, device=device).to(dtype), torch.as_tensor(y, device=device).to(dtype))


def bench_dot(dtype, m: int = 768, k: int = 256, n: int = 2048, n_iter: int = 64, reps: int = 20,
              device="cuda"):
    """Milliseconds per n_iter-product call of ``dot_chain`` on the card
    (reps calls between two CUDA events, after one warm-up call); prints the
    time and the achieved T(FL)OPS."""
    x, y = probe_operands(dtype, m, k, n, device=device)
    dot_chain(x, y, n_iter)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dot_chain(x, y, n_iter)
    end.record()
    end.synchronize()
    ms_per_call = start.elapsed_time(end) / reps
    rate = 2.0 * m * k * n * n_iter / (ms_per_call * 1e-3) / 1e12
    name = str(dtype).replace("torch.", "")
    print(f"{name}: {ms_per_call:.4f} ms / {n_iter}-dot call -> {rate:.1f} T(FL)OPS", flush=True)
    return ms_per_call


if __name__ == "__main__":
    print("device:", torch.cuda.get_device_name(0))
    bf16 = bench_dot(torch.bfloat16)
    i8 = bench_dot(torch.int8)
    print(f"int8 speedup vs bf16: {bf16 / i8:.2f}x")
    for dt in (torch.bfloat16, torch.int8):
        sections, _ = chain_clocks(*probe_operands(dt, device="cuda"))
        print(f"{str(dt).replace('torch.', '')} clocks a block: "
              + ", ".join(f"{k} {v:.0f}" for k, v in sections.items()))
