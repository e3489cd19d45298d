"""The rest of the port's training losses against the JAX package's, in
fp32 on the CPU: ``semantic_seg_loss`` in both layouts, presence modes and
focal modes, ``det2trk_assoc_loss`` under each flag, ``_point_sample``,
PointRend's point selection on coordinates JAX drew, the sampled mask
loss, and ``sam3_detection_loss`` with semantic weights and with sampled
mask losses. Values and gradients are held at 1e-5 (fp32, other
summation orders). Inputs are continuous draws, so top-k meets no ties.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientsam3_tpu.train import losses as jl
from efficientsam3_tpu_torch.train import losses as pl

TOL = 1e-5
RNG_KEY = jax.random.PRNGKey(7)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


def seg_inputs(seed=0, b=3, tn=4, h=12, w=10, hh=24, ww=20):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal((b, h, w))).astype(np.float32)
    masks = (rng.random((b, tn, hh, ww)) > 0.6).astype(np.float32)
    valid = np.array([[1, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0]], bool)[:b, :tn]
    presence = rng.standard_normal((b,)).astype(np.float32)
    return logits, masks, valid, presence


@pytest.mark.parametrize("layout", ["bhw", "b1hw"])
@pytest.mark.parametrize("presence_head", [False, True])
@pytest.mark.parametrize("focal", [False, True])
def test_semantic_seg_loss_matches_jax(layout, presence_head, focal):
    """Every part, and the gradient of their sum w.r.t. the map and the
    presence logit (sample 2 has no target: the presence mode's mask)."""
    logits, masks, valid, presence = seg_inputs()
    x = logits[:, None] if layout == "b1hw" else logits
    kw = dict(focal=focal, presence_head=presence_head)

    def jfn(x_, p_):
        out = jl.semantic_seg_loss(x_, jnp.asarray(masks), jnp.asarray(valid),
                                   presence_logit=p_, **kw)
        return sum(out.values()), out

    (jtot, want), (jgx, jgp) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(presence))
    xt = t(x).requires_grad_()
    pt = t(presence).requires_grad_()
    got = pl.semantic_seg_loss(xt, t(masks), t(valid), presence_logit=pt, **kw)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])
    sum(got.values()).backward()
    close(xt.grad, jgx)
    if presence_head:
        close(pt.grad, jgp)


def det_outputs(seed=0, b=2, q=6, tn=3, a=1, hm=8, wm=6):
    """A small model output dict in training mode (one aux layer, o2m
    queries, NHWC semantic map) and its targets."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sig = lambda z: 1 / (1 + np.exp(-z))  # noqa: E731
    out = {
        "pred_logits": f(b, q, 1), "pred_boxes": sig(f(b, q, 4)) * 0.5 + 0.1,
        "pred_masks": 2 * f(b, q, hm, wm), "presence_logit_dec": f(b),
        "aux": {"pred_logits": f(a, b, 2 * q, 1),
                "pred_boxes": sig(f(a, b, 2 * q, 4)) * 0.5 + 0.1,
                "presence_logits": f(a, b)},
        "pred_logits_o2m": f(b, q, 1), "pred_boxes_o2m": sig(f(b, q, 4)) * 0.5 + 0.1,
        "pred_masks_o2m": 2 * f(b, q, hm, wm),
        "semantic_seg": 2 * f(b, hm, wm, 1),
    }
    boxes = np.zeros((b, tn, 4), np.float32)
    valid = np.zeros((b, tn), bool)
    for i, n in enumerate((2, 1)[:b]):
        boxes[i, :n] = np.concatenate([rng.uniform(0.3, 0.7, (n, 2)),
                                       rng.uniform(0.1, 0.4, (n, 2))], -1)
        valid[i, :n] = True
    masks = (rng.random((b, tn, 2 * hm, 2 * wm)) > 0.5).astype(np.float32)
    return out, {"boxes": boxes, "valid": valid, "masks": masks}


def to_torch(tree, grad_keys=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = to_torch(v)
        else:
            out[k] = t(v).requires_grad_() if k in grad_keys else t(v)
    return out


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_jax_semantic_call_reads_the_first_row():
    """JAX's sam3_detection_loss hands the NHWC (B, Hm, Wm, 1) map to
    semantic_seg_loss as it is, which reads a 4-D map as (B, 1, h, w): its
    semantic parts equal the function on the map's first row alone, a
    (Wm, 1) image. The port's equal the function on the whole (B, Hm, Wm)
    map."""
    out, tgt = det_outputs()
    w = {"loss_semantic_seg": 1.0, "loss_semantic_dice": 1.0}
    _, jparts = jl.sam3_detection_loss(to_jax(out), to_jax(tgt), weights=w)
    sem = out["semantic_seg"]
    first_row = jl.semantic_seg_loss(jnp.asarray(sem[:, 0]), jnp.asarray(tgt["masks"]),
                                     jnp.asarray(tgt["valid"]))
    whole = jl.semantic_seg_loss(jnp.asarray(sem[..., 0]), jnp.asarray(tgt["masks"]),
                                 jnp.asarray(tgt["valid"]))
    _, parts = pl.sam3_detection_loss(to_torch(out), to_torch(tgt), weights=w)
    for k in ("loss_semantic_seg", "loss_semantic_dice"):
        close(jparts[k], first_row[k])
        close(parts[k], whole[k])
        assert abs(float(whole[k]) - float(first_row[k])) > 1e-3


def test_sam3_detection_loss_with_semantic_weights():
    """Nonzero semantic weights: every other part as JAX's, the semantic
    parts as JAX's function on the (B, Hm, Wm) map, and the total as
    JAX's total with its semantic parts replaced by those."""
    out, tgt = det_outputs(seed=1)
    w = {"loss_semantic_seg": 3.0, "loss_semantic_dice": 2.0}
    jtotal, jparts = jl.sam3_detection_loss(to_jax(out), to_jax(tgt), weights=w)
    whole = jl.semantic_seg_loss(jnp.asarray(out["semantic_seg"][..., 0]),
                                 jnp.asarray(tgt["masks"]), jnp.asarray(tgt["valid"]))
    total, parts = pl.sam3_detection_loss(to_torch(out), to_torch(tgt), weights=w)
    assert parts.keys() == jparts.keys()
    for k in parts:
        close(parts[k], whole[k] if k in whole else jparts[k])
    want_total = float(jtotal) + sum(w[k] * (float(whole[k]) - float(jparts[k])) for k in w)
    close(total, want_total)
    _, no_sem = pl.sam3_detection_loss(to_torch(out), to_torch(tgt))
    assert "loss_semantic_seg" not in no_sem


def jax_draws(key, n, num_points, oversample_ratio=3.0, importance_sample_ratio=0.75):
    """The uniform draws of JAX's sample_uncertain_points under ``key``."""
    r1, r2 = jax.random.split(key)
    s = int(num_points * oversample_ratio)
    r = num_points - int(importance_sample_ratio * num_points)
    return (np.asarray(jax.random.uniform(r1, (n, s, 2))),
            np.asarray(jax.random.uniform(r2, (n, r, 2))))


def test_point_sample_matches_jax():
    rng = np.random.default_rng(2)
    maps = rng.standard_normal((4, 9, 13)).astype(np.float32)
    coords = rng.uniform(-0.05, 1.05, (4, 50, 2)).astype(np.float32)
    close(pl._point_sample(t(maps), t(coords)), jl._point_sample(jnp.asarray(maps),
                                                                 jnp.asarray(coords)))


@pytest.mark.parametrize("num_points,ratio", [(16, 0.75), (20, 1.0), (12, 0.5)])
def test_uncertain_points_on_jax_draws(num_points, ratio):
    """The port's selection fed JAX's draws picks JAX's points, in JAX's
    order (the most uncertain first, then the fresh ones)."""
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((5, 16, 16))).astype(np.float32)
    want = jl.sample_uncertain_points(RNG_KEY, jnp.asarray(logits), num_points, 3.0, ratio)
    coords, fresh = jax_draws(RNG_KEY, 5, num_points, 3.0, ratio)
    got = pl.select_uncertain_points(t(logits), t(coords), t(fresh), int(ratio * num_points))
    assert got.shape == (5, num_points, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(0)
    drawn = pl.sample_uncertain_points(gen, t(logits), num_points, 3.0, ratio)
    assert drawn.shape == (5, num_points, 2) and (drawn >= 0).all() and (drawn < 1).all()


def test_sampled_mask_loss_matches_jax(monkeypatch):
    """mask_focal_dice_loss at 24 PointRend points a mask, the port's draw
    replaced by JAX's: both losses and the gradient w.r.t. the logits."""
    rng = np.random.default_rng(4)
    pred = (2 * rng.standard_normal((2, 3, 12, 12))).astype(np.float32)
    tgt = (rng.random((2, 3, 24, 24)) > 0.5).astype(np.float32)
    valid = np.array([[1, 1, 0], [1, 0, 0]], bool)
    draws = jax_draws(RNG_KEY, 6, 24)
    monkeypatch.setattr(pl, "draw_point_coords", lambda *a, **k: tuple(map(t, draws)))

    def jfn(p):
        lm, ld = jl.mask_focal_dice_loss(p, jnp.asarray(tgt), jnp.asarray(valid), 3.0,
                                         num_sample_points=24, rng=RNG_KEY)
        return lm + ld, (lm, ld)

    (_, (jlm, jld)), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(pred))
    pt = t(pred).requires_grad_()
    lm, ld = pl.mask_focal_dice_loss(pt, t(tgt), t(valid), 3.0, num_sample_points=24,
                                     rng=torch.Generator())
    close(lm, jlm)
    close(ld, jld)
    (lm + ld).backward()
    close(pt.grad, jg)
    with pytest.raises(ValueError, match="rng"):
        pl.mask_focal_dice_loss(pt, t(tgt), t(valid), 3.0, num_sample_points=24)


def test_sam3_detection_loss_sampled_masks(monkeypatch):
    """num_sample_points through sam3_detection_loss: the final o2o layer's
    draw, then the o2m layer's (JAX folds its key with the layer index and
    with 999); every part and the gradient w.r.t. the mask logits."""
    out, tgt = det_outputs(seed=5)
    key = RNG_KEY
    n_o2o = out["pred_masks"].shape[0] * tgt["valid"].shape[1]
    seq = [jax_draws(jax.random.fold_in(key, 1), n_o2o, 16),  # aux layer 0, final 1
           jax_draws(jax.random.fold_in(key, 999), n_o2o * 6, 16)]  # k = topk + 2 = 6
    monkeypatch.setattr(pl, "draw_point_coords", lambda *a, **k: tuple(map(t, seq.pop(0))))

    def jfn(masks, masks_o2m):
        o = dict(to_jax(out), pred_masks=masks, pred_masks_o2m=masks_o2m)
        return jl.sam3_detection_loss(o, to_jax(tgt), num_sample_points=16, rng=key)

    (jtotal, jparts), jgrads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(out["pred_masks"]), jnp.asarray(out["pred_masks_o2m"]))
    po = to_torch(out, grad_keys=("pred_masks", "pred_masks_o2m"))
    total, parts = pl.sam3_detection_loss(po, to_torch(tgt), num_sample_points=16,
                                          rng=torch.Generator(), mask_aux=True)
    assert not seq and parts.keys() == jparts.keys()
    for k in parts:
        close(parts[k], jparts[k])
    close(total, jtotal)
    total.backward()
    close(po["pred_masks"].grad, jgrads[0])
    close(po["pred_masks_o2m"].grad, jgrads[1])


def assoc_inputs(seed=0, b=3, q_det=7, q_trk=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (b, q_det, q_trk + 2)).astype(np.float32)
    ids = -np.ones((b, q_det + q_trk), np.int64)
    ids[0, 0], ids[0, q_det + 1] = 5, 5  # the same object, detected and tracked
    ids[0, 2] = 9  # a new object
    ids[0, 4], ids[0, q_det + 3] = 2, 2
    ids[1, 1], ids[1, q_det + 0] = 3, 3
    ids[1, 3], ids[1, q_det + 2] = 4, 4
    ids[2, q_det + 3] = 7  # tracked only (occluded)
    pred_logits = rng.normal(0, 2, (b, q_det, 1)).astype(np.float32)
    is_exh = np.array([True, False, True])
    return logits, ids, pred_logits, is_exh


@pytest.mark.parametrize("use_fp,treat_new,exh_only,with_exh", [
    (False, False, True, True), (True, False, True, True), (True, True, True, True),
    (True, False, False, True), (True, False, True, False)])
def test_det2trk_assoc_loss_matches_jax(use_fp, treat_new, exh_only, with_exh):
    """Every flag combination: the loss and its gradient w.r.t. the
    association logits."""
    logits, ids, pred_logits, is_exh = assoc_inputs()
    kw = dict(use_fp_loss=use_fp, treat_fp_as_new_obj=treat_new,
              fp_loss_on_exhaustive_only=exh_only)
    want, jg = jax.value_and_grad(lambda x: jl.det2trk_assoc_loss(
        x, jnp.asarray(ids), 4.0, pred_logits=jnp.asarray(pred_logits),
        is_exhaustive=jnp.asarray(is_exh) if with_exh else None, **kw))(jnp.asarray(logits))
    xt = t(logits).requires_grad_()
    got = pl.det2trk_assoc_loss(xt, t(ids), 4.0, pred_logits=t(pred_logits),
                                is_exhaustive=t(is_exh) if with_exh else None, **kw)
    close(got, want)
    got.backward()
    close(xt.grad, jg)
