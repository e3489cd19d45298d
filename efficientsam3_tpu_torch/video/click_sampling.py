"""Correction-click sampling from mask error regions.

Mirrors reference sam3/sam3/model/sam3_tracker_utils.py: `sample_box_points`
(:33), `sample_random_points_from_errors` (:108) and the center-click
variant that places the click at the point FARTHEST from the error-region
boundary (the reason the EDT kernel exists, SURVEY §2.6).

Counterpart of efficientsam3_tpu/video/click_sampling.py. Host-side numpy
(training-time interactivity); the EDT runs through the host C++ kernel
(``native.edt``, which raises when it cannot be built), or through the
tensor version ``ops/edt`` on the CPU when the caller passes native=False.
"""

from __future__ import annotations

import numpy as np


def _edt(mask: np.ndarray, native: bool) -> np.ndarray:
    if native:
        from efficientsam3_tpu_torch import native as host

        return host.edt(mask)
    import torch

    from efficientsam3_tpu_torch.ops.edt import edt

    return edt(torch.from_numpy(np.ascontiguousarray(mask))).numpy()


def sample_box_points(gt_mask: np.ndarray, noise_std: float = 0.1, rng=None):
    """GT mask -> (possibly jittered) box corner points labeled 2/3
    (reference :33)."""
    rng = rng or np.random.default_rng()
    ys, xs = np.nonzero(gt_mask)
    if len(ys) == 0:
        return np.zeros((2, 2), np.float32), np.asarray([-1, -1], np.int32)
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    w, h = x1 - x0 + 1, y1 - y0 + 1
    jitter = rng.normal(0, noise_std, 4) * np.asarray([w, h, w, h])
    box = np.asarray([x0, y0, x1, y1], np.float32) + jitter
    pts = np.asarray([[box[0], box[1]], [box[2], box[3]]], np.float32)
    return pts, np.asarray([2, 3], np.int32)


def sample_random_points_from_errors(gt_mask, pred_mask, num_points: int = 1,
                                     rng=None):
    """Uniform clicks from the error region: positive where FN, negative
    where FP (reference :108)."""
    rng = rng or np.random.default_rng()
    fn = gt_mask & ~pred_mask
    fp = pred_mask & ~gt_mask
    errors = fn | fp
    ys, xs = np.nonzero(errors)
    if len(ys) == 0:
        return np.zeros((num_points, 2), np.float32), -np.ones(num_points, np.int32)
    idx = rng.integers(0, len(ys), num_points)
    pts = np.stack([xs[idx], ys[idx]], -1).astype(np.float32)
    labels = fn[ys[idx], xs[idx]].astype(np.int32)  # 1 on FN (positive click)
    return pts, labels


def sample_center_point_from_errors(gt_mask, pred_mask, native: bool = True):
    """The click farthest from the error-region boundary (EDT argmax),
    the deterministic variant used at eval (reference get_next_point :284)."""
    fn = gt_mask & ~pred_mask
    fp = pred_mask & ~gt_mask
    errors = fn | fp
    if not errors.any():
        return np.zeros((1, 2), np.float32), -np.ones(1, np.int32)
    dist = _edt(errors, native)
    y, x = np.unravel_index(np.argmax(dist), dist.shape)
    label = int(fn[y, x])
    return np.asarray([[x, y]], np.float32), np.asarray([label], np.int32)
