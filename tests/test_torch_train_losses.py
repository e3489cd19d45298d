"""The port's Stage-3 losses and matcher against the JAX package on the
same numpy inputs, fp32 on the CPU: the batched host Hungarian solver
(and scipy as an independent check of optimality), ``hungarian_match``,
BCE and the focal loss with its custom gradient, the box IoU helpers,
and ``sam3_detection_loss`` (total, every part, and the gradients with
respect to every model output, masks included)."""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from efficientsam3_tpu.ops import focal_loss as jfocal
from efficientsam3_tpu.ops import masks as jmasks
from efficientsam3_tpu.ops.hungarian import solve_assignment_batched as jsolve
from efficientsam3_tpu.train import losses as jlosses
from efficientsam3_tpu.train.matcher import hungarian_match as jmatch
from efficientsam3_tpu_torch.ops import focal_loss as pfocal
from efficientsam3_tpu_torch.ops import masks as pmasks
from efficientsam3_tpu_torch.ops.hungarian import solve_assignment_batched
from efficientsam3_tpu_torch.train import losses as plosses
from efficientsam3_tpu_torch.train.matcher import hungarian_match

# fp32 elementwise chains and sums of a few thousand terms in other
# orders: 1e-5 relative
TOL = 1e-5


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), err


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("p,rows,cols,ties", [(7, 5, 12, False), (3, 40, 200, False),
                                              (4, 6, 6, True)])
def test_hungarian_matches_jax_and_is_optimal(p, rows, cols, ties):
    """The same assignments as the JAX solver (ties broken the same way:
    integer costs make many), and the least total cost (scipy)."""
    rng = np.random.default_rng(rows)
    cost = rng.standard_normal((p, rows, cols)).astype(np.float32)
    if ties:
        cost = np.round(cost * 2).astype(np.float32)
    got = solve_assignment_batched(cost)
    want = np.asarray(jsolve(jnp.asarray(cost)))
    assert np.array_equal(got, want)
    for c, a in zip(cost, got):
        assert len(set(a.tolist())) == rows
        r, s = linear_sum_assignment(c)
        assert np.isclose(c[np.arange(rows), a].sum(), c[r, s].sum(), rtol=1e-5)


def _boxes(rng, shape):
    xy = rng.uniform(0.15, 0.85, shape + (2,))
    wh = rng.uniform(0.05, 0.5, shape + (2,))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def test_hungarian_match_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 30, 1)).astype(np.float32)
    boxes = _boxes(rng, (3, 30))
    tgt = _boxes(rng, (3, 8))
    valid = np.zeros((3, 8), bool)
    valid[0, :5] = valid[1, :1] = True  # sample 2 has no target
    got, _ = hungarian_match(t(logits), t(boxes), t(tgt), t(valid))
    want, _ = jmatch(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(tgt),
                     jnp.asarray(valid))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (0.5, 0.0), (-1.0, 1.5)])
def test_focal_loss_and_its_gradient_match_jax(alpha, gamma):
    """Values and the custom gradient, saturated logits included (gamma 0
    is the presence loss, whose modulating term has no gradient)."""
    rng = np.random.default_rng(2)
    x = (4 * rng.standard_normal((5, 64))).astype(np.float32)
    x[0, :4] = [30.0, -30.0, 60.0, -60.0]
    y = (rng.random((5, 64)) > 0.5).astype(np.float32)
    y[1] = rng.random(64)  # soft targets
    xt = t(x).requires_grad_()
    got = pfocal.sigmoid_focal_loss(xt, t(y), alpha, gamma)
    g = rng.standard_normal(x.shape).astype(np.float32)
    (dx,) = torch.autograd.grad(got, xt, t(g))
    want, vjp = jax.vjp(lambda a: jfocal.sigmoid_focal_loss(a, jnp.asarray(y), alpha, gamma),
                        jnp.asarray(x))
    close(got, want)
    close(dx, vjp(jnp.asarray(g))[0])
    assert torch.isfinite(dx).all()
    close(pfocal.optax_bce(t(x), t(y)), jfocal.optax_bce(jnp.asarray(x), jnp.asarray(y)))


def test_box_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = _boxes(rng, (2, 9))
    b = _boxes(rng, (2, 4))
    ax, bx = (np.asarray(jlosses.box_cxcywh_to_xyxy(jnp.asarray(v))) for v in (a, b))
    close(pmasks.box_iou_xyxy(t(ax), t(bx)), jax.vmap(jmasks.box_iou_xyxy)(ax, bx))
    close(pmasks.generalized_box_iou(t(ax), t(bx)), jax.vmap(jmasks.generalized_box_iou)(ax, bx))
    close(plosses.diag_box_iou(t(ax[:, :4]), t(bx)), jlosses.diag_box_iou(ax[:, :4], bx))
    close(plosses.diag_generalized_box_iou(t(ax[:, :4]), t(bx)),
          jlosses.diag_generalized_box_iou(ax[:, :4], bx))


B, Q, T, A, HW = 2, 24, 6, 2, 16


def _outputs(seed):
    """Model outputs of a training forward: 2Q DAC queries in aux, final
    o2o and o2m, masks at HW x HW. A few o2m queries sit on a target so
    the one-to-many matcher finds pairs."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((A + 1, B, 2 * Q, 1)).astype(np.float32)
    boxes = _boxes(rng, (A + 1, B, 2 * Q))
    tgt = _boxes(rng, (B, T))
    valid = np.zeros((B, T), bool)
    valid[0, :4] = valid[1, :2] = True
    boxes[-1, :, Q:Q + 3] = tgt[:, :1] + rng.uniform(-0.01, 0.01, (B, 3, 4))
    logits[-1, :, Q:Q + 3] = 3.0
    masks = rng.standard_normal((B, 2 * Q, HW, HW)).astype(np.float32)
    presence = rng.standard_normal((A + 1, B)).astype(np.float32)
    outs = {
        "pred_logits": logits[-1][:, :Q], "pred_boxes": boxes[-1][:, :Q],
        "pred_masks": masks[:, :Q], "presence_logit_dec": presence[-1],
        "aux": {"pred_logits": logits[:-1], "pred_boxes": boxes[:-1],
                "presence_logits": presence[:-1]},
        "pred_logits_o2m": logits[-1][:, Q:], "pred_boxes_o2m": boxes[-1][:, Q:],
        "pred_masks_o2m": masks[:, Q:],
    }
    targets = {"boxes": tgt, "valid": valid,
               "masks": (rng.random((B, T, HW, HW)) > 0.5).astype(np.float32)}
    return outs, targets


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_and_gradients_match_jax(seed):
    outs, targets = _outputs(seed)
    leaves, tree = jax.tree_util.tree_flatten(outs)

    def jloss(*xs):
        o = jax.tree_util.tree_unflatten(tree, xs)
        return jlosses.sam3_detection_loss(o, jax.tree_util.tree_map(jnp.asarray, targets))

    (want, want_parts), want_grads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(leaves))), has_aux=True)(*map(jnp.asarray, leaves))

    pleaves = [t(x).requires_grad_() for x in leaves]
    got, parts = plosses.sam3_detection_loss(jax.tree_util.tree_unflatten(tree, pleaves),
                                             {k: t(v) for k, v in targets.items()})
    got_grads = torch.autograd.grad(got, pleaves)
    assert sorted(parts) == sorted(want_parts)
    assert float(want_parts["loss_mask_o2m"]) > 0 and float(want_parts["loss_bbox_o2m"]) > 0
    close(got, want)
    for k, v in want_parts.items():
        close(parts[k], v)
    for g, w in zip(got_grads, want_grads):
        close(g, w)
