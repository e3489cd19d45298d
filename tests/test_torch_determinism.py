"""The port's training backward adds without atomics, on the CPU.

On CUDA, ``F.interpolate``'s bilinear backward and ``torch.gather``'s
backward add by atomics, so two runs of one training step give other bits.
The port replaces them where autograd records a gradient:

- ``ops.interpolate.resize_bilinear``: the forward is ``F.interpolate``
  (bit for bit), the backward the JAX package's form g -> W_h^T g W_w;
- ``ops.gather.take_columns`` / ``take_rows`` (``grid_sample``'s corner
  gathers, ``roi_align``'s ROI maps): the backward sums each source
  element's gradients in index order (a stable sort and a segment sum).

Held here against the JAX package's ``resize_bilinear``, ``grid_sample``
and ``roi_align`` and their ``jax.vjp`` (fp32, 1e-5 of the largest
magnitude), by ``gradcheck`` in fp64, and by walking the autograd graphs of
a tiny Stage-3 loss and a tiny tracker training clip for the nodes that add
by atomics on CUDA. The same bits twice on the card:
``tests/test_torch_cuda.py`` (``-k deterministic``) and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from efficientsam3_tpu.ops.grid_sample import grid_sample as jgrid_sample
from efficientsam3_tpu.ops.interpolate import resize_bilinear as jresize_bilinear
from efficientsam3_tpu.ops.roi_align import roi_align as jroi_align
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model, init_parameters
from efficientsam3_tpu_torch.ops import interpolate
from efficientsam3_tpu_torch.ops.gather import index_sum, take_columns, take_rows
from efficientsam3_tpu_torch.ops.grid_sample import grid_sample
from efficientsam3_tpu_torch.ops.interpolate import resize_bilinear
from efficientsam3_tpu_torch.ops.roi_align import roi_align
from efficientsam3_tpu_torch.train import stage3
from efficientsam3_tpu_torch.video import tracker as ptr

from test_torch_tracker_modules import CFG
from test_torch_tracker_train_slice import PortApi, clip_inputs, run_clip

# fp32 on both sides, the same products summed in other orders: ~1e-7 of
# the largest magnitude; 1e-5 of it leaves room
TOL = 1e-5
# the port's resizes in the three regimes it trains through, at small
# sizes: the student head's upscale (4x4 -> 9x9, as 63 -> 72 at the
# trunk's stride 16 of 1008), the mask loss's upsample (36 -> 126, as 288
# -> 1008), the memory encoder's upscale (63 -> 72, as 1008 -> 1152); a
# downscale (the tracker's 1008 -> 288) and a 3-d input
RESIZES = {
    "student-head": ((2, 8, 4, 4), (9, 9)),
    "mask-loss": ((3, 1, 36, 36), (126, 126)),
    "memory-encoder": ((2, 1, 63, 63), (72, 72)),
    "downscale": ((2, 1, 35, 35), (10, 10)),
    "3d": ((3, 36, 36), (126, 126)),
}
# CUDA autograd nodes that add by atomics (the resize and gather backward)
ATOMIC_NODES = {"UpsampleBilinear2DBackward0", "UpsampleBilinear2DAaBackward0",
                "GatherBackward0", "IndexSelectBackward0", "ScatterAddBackward0",
                "GridSampler2DBackward0", "IndexAddBackward0"}


def _rng(seed):
    return np.random.default_rng(seed)


def _assert_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


@pytest.mark.parametrize("case", sorted(RESIZES))
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_backward_matches_jax_vjp(case, align_corners):
    shape, size = RESIZES[case]
    x = _rng(1).standard_normal(shape).astype(np.float32)
    g = _rng(2).standard_normal((*shape[:-2], *size)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jresize_bilinear(a, size, align_corners), jnp.asarray(x))
    want_grad, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = resize_bilinear(xt, size, align_corners)
    got.backward(torch.from_numpy(g))
    _assert_close(got, want)
    _assert_close(xt.grad, want_grad)


@pytest.mark.parametrize("case,antialias", [(c, a) for c in sorted(RESIZES) for a in (False, True)
                                             if not (a and len(RESIZES[c][0]) != 4)])
def test_resize_forward_is_f_interpolate(case, antialias):
    """Under autograd and without, the values are F.interpolate's bits (the
    antialiased form takes (N, C, H, W) only)."""
    shape, size = RESIZES[case]
    x = torch.from_numpy(_rng(3).standard_normal(shape).astype(np.float32))
    flat = x.reshape(-1, *shape[-3:]) if len(shape) == 4 else x.reshape(-1, 1, *shape[-2:])
    want = F.interpolate(flat, size=size, mode="bilinear", align_corners=False,
                         antialias=antialias).reshape(*shape[:-2], *size)
    got = resize_bilinear(x.clone().requires_grad_(), size, antialias=antialias)
    assert "_BilinearResizeBackward" in _node_names(got)
    assert torch.equal(got.detach(), want)
    with torch.no_grad():
        assert torch.equal(resize_bilinear(x, size, antialias=antialias), want)


@pytest.mark.parametrize("shape,size,antialias", [
    ((1, 2, 4, 4), (9, 9), False), ((1, 1, 6, 7), (3, 11), False),
    ((2, 1, 9, 9), (4, 4), True), ((1, 1, 5, 5), (12, 7), True)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_gradcheck(shape, size, antialias, align_corners):
    x = torch.from_numpy(_rng(4).standard_normal(shape)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a: interpolate._BilinearResize.apply(a, size, align_corners, antialias), (x,))


def test_antialiased_resize_backward_matches_f_interpolate():
    """The antialiased downscale (the tracker's mask prompt) against
    F.interpolate's own backward, in fp64."""
    x = torch.from_numpy(_rng(5).standard_normal((2, 1, 40, 40))).requires_grad_()
    g = torch.from_numpy(_rng(6).standard_normal((2, 1, 12, 12)))
    interpolate._BilinearResize.apply(x, (12, 12), False, True).backward(g)
    y = x.detach().clone().requires_grad_()
    F.interpolate(y, size=(12, 12), mode="bilinear", antialias=True).backward(g)
    torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=1e-12)


def _grid_points(n, p, seed):
    """xy in [-1, 1]: inside the map, on its edges and corners, outside it,
    and several in one cell (their gradients meet in one source element)."""
    r = _rng(seed)
    inside = r.uniform(-0.9, 0.9, (n, p, 2))
    edges = np.array([[-1.0, 0.3], [1.0, -0.2], [0.1, -1.0], [-0.4, 1.0], [-1.0, -1.0],
                      [1.0, 1.0]])
    outside = np.array([[-1.3, 0.0], [0.2, 1.4], [1.05, 1.05], [-2.0, -2.0]])
    same = np.array([[0.21, 0.33], [0.215, 0.331], [0.212, 0.335]])
    pts = np.concatenate([inside, np.broadcast_to(np.concatenate([edges, outside, same]),
                                                  (n, 13, 2))], axis=1)
    return pts.astype(np.float32)[:, :, None, :]  # (N, P, 1, 2)


@pytest.mark.parametrize("size", [(9, 9), (12, 7)])
def test_grid_sample_backward_matches_jax_vjp(size):
    x = _rng(7).standard_normal((2, 5, *size)).astype(np.float32)
    grid = _grid_points(2, 20, 8)
    g = _rng(9).standard_normal((2, 5, grid.shape[1], 1)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jgrid_sample(a, jnp.asarray(grid)), jnp.asarray(x))
    want_grad, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = grid_sample(xt, torch.from_numpy(grid))
    got.backward(torch.from_numpy(g))
    assert "_TakeColumnsBackward" in _node_names(got)
    _assert_close(got, want)
    _assert_close(xt.grad, want_grad)


def test_roi_align_backward_matches_jax_vjp():
    """ROIs of one image gathered several times: their gradients meet in
    that image's map."""
    x = _rng(10).standard_normal((3, 4, 16, 16)).astype(np.float32)
    boxes = np.array([[1.0, 2.0, 9.0, 12.0], [0.0, 0.0, 16.0, 16.0], [4.5, 3.2, 7.1, 5.9],
                      [2.0, 2.0, 3.0, 3.0], [10.0, 1.0, 15.5, 14.0]], np.float32)
    bidx = np.array([0, 0, 2, 0, 2])
    g = _rng(11).standard_normal((5, 4, 7, 7)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jroi_align(a, jnp.asarray(boxes), jnp.asarray(bidx), (7, 7),
                                             sampling_ratio=-1, aligned=False), jnp.asarray(x))
    want_grad, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = roi_align(xt, torch.from_numpy(boxes), torch.from_numpy(bidx), (7, 7))
    got.backward(torch.from_numpy(g))
    assert "_TakeRowsBackward" in _node_names(got)
    _assert_close(got, want)
    _assert_close(xt.grad, want_grad)
    assert not xt.grad[1].any()  # no ROI reads image 1


def test_index_sum_adds_in_index_order():
    """Each row's sum is the running fp32 sum over its indices in order,
    bit for bit; the gathers' backward equals torch's own."""
    v = torch.from_numpy(_rng(12).standard_normal((500, 3)).astype(np.float32))
    idx = torch.from_numpy(_rng(13).integers(0, 40, 500))
    want = torch.zeros(41, 3)
    for i in range(500):
        want[idx[i]] = want[idx[i]] + v[i]
    assert torch.equal(index_sum(41, idx, v), want)
    assert not index_sum(41, idx[:0], v[:0]).any()
    x = torch.randn(3, 6, 30, requires_grad=True)
    cols = torch.from_numpy(_rng(14).integers(0, 30, (3, 50)))
    g = torch.randn(3, 6, 50)
    take_columns(x, cols).backward(g)
    y = x.detach().clone().requires_grad_()
    torch.gather(y, 2, cols[:, None].expand(-1, 6, -1)).backward(g)
    torch.testing.assert_close(x.grad, y.grad)
    rows = torch.tensor([2, 0, 2, 2, 1])
    take_rows(x, rows).backward(torch.ones(5, 6, 30))
    torch.testing.assert_close(x.grad - y.grad, torch.tensor([1.0, 1.0, 3.0])[:, None, None]
                               .expand(3, 6, 30))


def _node_names(out):
    seen, stack, names = set(), [out.grad_fn], set()
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        names.add(type(n).__name__)
        stack.extend(f for f, _ in n.next_functions)
    return names


def test_stage3_graph_adds_without_atomics():
    """A tiny Stage-3 loss's graph: the trunk's upsample, the geometry
    encoder's point sampling and ROI pooling take the new backward, and no
    node that adds by atomics on CUDA is left."""
    import chip_smoke as cs

    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b0", embed_size=8,
        text_encoder_context_length=16, fusion_layers=2, decoder_layers=2, seed=1, device="cpu")
    batch = cs.stage3_batch(2, 16, "cpu", seed=12)
    batch["images"] = F.interpolate(batch["images"].permute(0, 3, 1, 2), size=(64, 64),
                                    mode="area").permute(0, 2, 3, 1)
    batch["targets"]["masks"] = F.interpolate(batch["targets"]["masks"], size=(32, 32),
                                              mode="area").round()
    stage3.make_stage3_optimizer(stage3.Stage3Config(), model)
    model.train()
    outs = model(batch["images"], batch["tokens"], batch["prompt"])
    total, _ = stage3.sam3_detection_loss(outs, batch["targets"])
    names = _node_names(total)
    assert {"_BilinearResizeBackward", "_TakeColumnsBackward", "_TakeRowsBackward"} <= names
    assert not names & ATOMIC_NODES, names & ATOMIC_NODES


def test_tracker_clip_graph_adds_without_atomics():
    """A tiny tracker training clip (3 frames): the mask resizes of the
    heads and the memory encoder take the new backward, and no node that
    adds by atomics on CUDA is left."""
    core = init_parameters(ptr.TrackerCore(**CFG, dropout=0.0), seed=0).train()
    inp = clip_inputs()
    tokens = torch.from_numpy(inp["tokens"]).requires_grad_()
    rest = [torch.from_numpy(inp[k]) for k in ("pos", "fpn0", "fpn1")]
    loss = run_clip(PortApi(core), tokens, *rest, inp["coords"], inp["labels"],
                    torch.from_numpy(inp["proj"]))
    names = _node_names(loss)
    assert "_BilinearResizeBackward" in names
    assert not names & ATOMIC_NODES, names & ATOMIC_NODES
