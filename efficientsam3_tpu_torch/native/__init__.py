"""ctypes bindings of the port's host kernels (``csrc/hostkernels.cu``).

Counterpart of efficientsam3_tpu/native/__init__.py, same function names:
``cc_label``, ``fill_holes``, ``nms_greedy``, ``edt`` and ``RecordStore``
over the port's own copy of the host C++ library. The library is built at
first use by ``ops/_build.load_host`` (nvcc with the CUDA kernels, or g++
where there is no nvcc) into the git-ignored ``_build/``.

Unlike the JAX binding, nothing gives way silently: ``lib()`` returns the
loaded library or raises with the compiler's output. Callers choose the
native path themselves (the card's path takes it; the CPU tests ask for the
scipy versions).
"""

from __future__ import annotations

import ctypes

import numpy as np

from efficientsam3_tpu_torch.ops import _build

_I32, _I64, _F32, _P = ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
_SIGNATURES = {
    "cc_label": ([_P, _I32, _I32, _P], _I32),
    "fill_holes_sprinkles": ([_P, _I32, _I32, _I32, _F32, _F32, _I32, _F32], None),
    "nms_greedy": ([_P, _P, _I32, _F32, _P], None),
    "edt": ([_P, _I32, _I32, _P], None),
    "record_store_item_size": ([ctypes.c_char_p], _I64),
    "record_store_count": ([ctypes.c_char_p], _I64),
    "record_store_read": ([ctypes.c_char_p, _I64, _P, _I64], _I32),
}


def lib() -> ctypes.CDLL:
    """The host library, built on first use; raises when it cannot be built."""
    l = _build.load_host("hostkernels")
    if l.cc_label.argtypes is None:
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(l, name)
            fn.argtypes, fn.restype = argtypes, restype
    return l


def cc_label(mask: np.ndarray):
    """(H, W) bool -> (labels int32 (H, W) numbered 1..K in scan order, K);
    8-connectivity, 0 = background."""
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if m.ndim != 2:
        raise ValueError(f"cc_label takes one (H, W) mask, got {m.shape}")
    out = np.zeros(m.shape, np.int32)
    n = lib().cc_label(m.ctypes.data, m.shape[0], m.shape[1], out.ctypes.data)
    return out, int(n)


def fill_holes(scores: np.ndarray, max_area: float, fill_value: float = 0.1,
               remove_sprinkles: bool = False, sprinkle_value: float = -0.1):
    """(..., H, W) float32 score maps, patched IN PLACE: background
    components (score <= 0, 8-connectivity) of area <= max_area are set to
    fill_value; with remove_sprinkles, foreground components of the patched
    map of area <= min(total foreground // 2, max_area) are then set to
    sprinkle_value. scores must be contiguous float32; leading axes are the
    batch, split over threads."""
    if scores.dtype != np.float32 or not scores.flags.c_contiguous or scores.ndim < 2:
        raise ValueError("fill_holes takes a contiguous float32 (..., H, W) array")
    h, w = scores.shape[-2:]
    b = int(np.prod(scores.shape[:-2], dtype=np.int64))
    lib().fill_holes_sprinkles(scores.ctypes.data, b, h, w, float(max_area), float(fill_value),
                               1 if remove_sprinkles else 0, float(sprinkle_value))
    return scores


def nms_greedy(iou: np.ndarray, scores: np.ndarray, thresh: float):
    """Greedy NMS over a full (N, N) IoU matrix in descending score order:
    keep (N,) bool."""
    iou = np.ascontiguousarray(iou, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = scores.shape[0]
    if iou.shape != (n, n):
        raise ValueError(f"nms_greedy: iou {iou.shape} for {n} scores")
    keep = np.zeros(n, np.uint8)
    lib().nms_greedy(iou.ctypes.data, scores.ctypes.data, n, float(thresh), keep.ctypes.data)
    return keep.astype(bool)


def edt(mask: np.ndarray):
    """(H, W) mask -> float32 distance of each nonzero pixel to the nearest
    zero pixel (scipy.ndimage.distance_transform_edt semantics)."""
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if m.ndim != 2:
        raise ValueError(f"edt takes one (H, W) mask, got {m.shape}")
    out = np.zeros(m.shape, np.float32)
    lib().edt(m.ctypes.data, m.shape[0], m.shape[1], out.ctypes.data)
    return out


class RecordStore:
    """Fixed-item-size keyed binary store (stage-1 teacher embeddings).

    Layout: [count int64][item_size int64][items...]."""

    def __init__(self, path: str):
        self.path = path
        self.item_size = int(lib().record_store_item_size(path.encode()))
        self.count = int(lib().record_store_count(path.encode()))
        if self.item_size < 0 or self.count < 0:
            raise IOError(f"invalid record store: {path}")

    def read(self, index: int) -> bytes:
        out = np.zeros(self.item_size, np.uint8)
        rc = lib().record_store_read(self.path.encode(), int(index), out.ctypes.data,
                                     self.item_size)
        if rc != 0:
            raise IOError(f"record_store_read failed rc={rc}")
        return out.tobytes()

    @staticmethod
    def write(path: str, items: list[bytes]):
        if not items or any(len(i) != len(items[0]) for i in items):
            raise ValueError("RecordStore.write takes a non-empty list of equal-length items")
        with open(path, "wb") as f:
            np.asarray([len(items), len(items[0])], np.int64).tofile(f)
            for it in items:
                f.write(it)
