"""Exact Hungarian assignment on the host, for many cost matrices at once.

Counterpart of efficientsam3_tpu/ops/hungarian.py: the same e-maxx
shortest-augmenting-path algorithm (rows are added one at a time; each
grows an alternating path over the columns with potentials u, v until it
reaches a free column), in float32 with the same first-index tie-breaking
of ``argmin``, so it returns the JAX package's assignments and not merely
an equally cheap one. Given cost (T, Q) with T <= Q it assigns each row a
distinct column at the least total cost.

The JAX package runs it on the device with a vmap over the matrices; here
it runs on the host, over the stacked cost the matcher copies off the card
once per step (``train/matcher.py``), in one of two forms with the same
results bit for bit:

  - ``solve_assignment_batched``, NumPy: the matrices stacked on a leading
    axis and stepped in lockstep (a matrix whose path has reached a free
    column waits for the others), so the Python loop runs per row and path
    step, not per matrix. The CPU path and the tests' reference.
  - ``solve_assignment_native``: the same arithmetic in host C++
    (``csrc/hungarian.cu``, built with the CUDA kernels), the matrices
    split over threads. The matcher takes it when the predictions are on
    the card: a step's 44 padded 40 x 200 matrices take ~170 ms in NumPy
    (~700 lockstep path steps at ~0.2 ms of call overhead each), a few ms
    natively.
"""

from __future__ import annotations

import ctypes

import numpy as np

from efficientsam3_tpu_torch.ops import _build

INF = np.float32(1e18)


def solve_assignment_batched(cost: np.ndarray) -> np.ndarray:
    """cost (P, T, Q) float, T <= Q -> (P, T) int32 column per row."""
    cost = np.asarray(cost, np.float32)
    n, t, q = cost.shape
    if t > q:
        raise ValueError(f"more rows than columns: {t} > {q}")
    ar = np.arange(n)
    # e-maxx with a virtual column 0; columns 1..Q, rows 1..T in p
    u = np.zeros((n, t + 1), np.float32)
    v = np.zeros((n, q + 1), np.float32)
    p = np.zeros((n, q + 1), np.int64)
    for i in range(t):
        minv = np.full((n, q + 1), INF, np.float32)
        used = np.zeros((n, q + 1), bool)
        way = np.zeros((n, q + 1), np.int64)
        p[:, 0] = i + 1
        j0 = np.zeros(n, np.int64)
        active = ar
        while active.size:
            a, ja = active, j0[active]
            used[a, ja] = True
            i0 = p[a, ja]
            cur = cost[a, i0 - 1] - u[a, i0][:, None] - v[a, 1:]
            used_a = used[a]
            better = (cur < minv[a, 1:]) & ~used_a[:, 1:]
            minv[a, 1:] = np.where(better, cur, minv[a, 1:])
            way[a, 1:] = np.where(better, ja[:, None], way[a, 1:])
            masked = np.where(used_a[:, 1:], INF, minv[a, 1:])
            j1 = np.argmin(masked, axis=1) + 1
            delta = masked[np.arange(a.size), j1 - 1]
            # u[p[j]] += delta and v[j] -= delta for used j (the rows p[j]
            # of used columns are distinct); minv[j] -= delta for unused j
            rows, cols = np.nonzero(used_a)
            u[a[rows], p[a[rows], cols]] += delta[rows]
            d = delta[:, None]
            v[a] = np.where(used_a, v[a] - d, v[a])
            minv[a] = np.where(used_a, minv[a], minv[a] - d)
            j0[a] = j1
            active = a[p[a, j1] != 0]
        # augment along `way` back to the virtual column
        active = ar
        while active.size:
            j1 = way[active, j0[active]]
            p[active, j0[active]] = p[active, j1]
            j0[active] = j1
            active = active[j1 != 0]
    out = np.zeros((n, t + 1), np.int64)
    rows = p[:, 1:]
    cols = np.broadcast_to(np.arange(1, q + 1), rows.shape)
    hit = rows != 0
    out[np.nonzero(hit)[0], rows[hit]] = cols[hit]
    return (out[:, 1:] - 1).astype(np.int32)


def _lib():
    fn = _build.load("hungarian").hungarian_solve
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def solve_assignment_native(cost: np.ndarray) -> np.ndarray:
    """``solve_assignment_batched`` in host C++ (``csrc/hungarian.cu``),
    threads over the matrices; built with the CUDA kernels on first use."""
    cost = np.ascontiguousarray(cost, np.float32)
    n, t, q = cost.shape
    if t > q:
        raise ValueError(f"more rows than columns: {t} > {q}")
    fn = _lib()
    out = np.empty((n, t), np.int32)
    if fn(cost.ctypes.data, n, t, q, out.ctypes.data) != 0:
        raise RuntimeError("hungarian_solve refused its input")
    return out
