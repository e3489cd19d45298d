"""The tracker's training path in the PyTorch port against the JAX package,
at the tiny tracker config of tests/test_torch_tracker_modules.py (64x64
images, 8x8 tokens, d_model 32, mem_dim 8, 3 memories, 4 pointers), in
fp32 on the CPU.

A 3-frame clip in training mode, composed the same way from each package's
TrackerCore methods (``train=True`` in JAX, ``.train()`` in the port):
frame 0 is prompted (no_mem_features -> forward_sam_heads without
multimask, so the decoder's training flag decides the mask ->
encode_memory); frames 1-2 are tracked (condition_features over a
fixed-width bank of stacked memories and pointers with validity masks, as
the predictor lays it out -> forward_sam_heads -> encode_memory). The
loss is a fixed seeded projection of every frame's low-res masks. Loss and
the gradients of every parameter (memory attention, memory encoder, SAM
heads and the raw embeddings) and of the input tokens are compared. Dropout
is off on both sides (the frameworks draw different bits): the port builds
its core with dropout 0, and only flax's ``nn.Dropout`` is replaced by the
identity here. Separate tests hold the decoder's training flag against the
JAX decoder's and show dropout live and seeded in the port.
"""

import re

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401

import flax.linen as nn
import jax
import jax.numpy as jnp

from efficientsam3_tpu.models.sam import MaskDecoder as JMaskDecoder
from efficientsam3_tpu.video import tracker as jtr
from efficientsam3_tpu_torch.models.sam import MaskDecoder
from efficientsam3_tpu_torch.utils.convert import convert_variables, load_jax_variables
from efficientsam3_tpu_torch.video import tracker as ptr

from test_torch_tracker_modules import CFG, random_variables

B, T, FS, D, MD, NM, NP = 3, 3, 8, 32, 8, 3, 4
# fp32 on both sides, a backward through 3 frames of memory attention, SAM
# heads and memory encoder summed in other orders: ~1e-6 of each
# gradient's range, 1e-4 leaves room for the products of 4 layers
TOL = 1e-4
# the mask decoder's key biases (no rotary encoding there): softmax is
# invariant to a shift shared by all keys, so their gradient is 0
ZERO_GRAD = re.compile(r"sam_mask_decoder\..*\.k_proj\.bias")


def _bank(t):
    """The predictor's fixed-width bank at frame t of a forward clip whose
    frame 0 is the prompted frame: memory columns (source frame, tpos) with
    the prompted frame first (tpos 0) and then the recent frames oldest
    first (tpos num_maskmem - distance), and pointer sources (frame, frame
    distance): the prompted frame, then the recent frames newest first."""
    recent = list(range(max(1, t - (NM - 1)), t))
    cols = [(0, 0)] + [(s, NM - (t - s)) for s in recent]
    ptrs = [(0, t)] + [(s, t - s) for s in range(t - 1, 0, -1)][:NP - 1]
    return cols, ptrs


def clip_inputs(seed=4):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    coords = np.array([[[10, 12], [40, 50], [0, 0]], [[5, 60], [0, 0], [0, 0]],
                       [[30, 30], [20, 21], [0, 0]]], np.float32)
    labels = np.array([[2, 3, -1], [1, -1, -1], [1, 0, -1]])
    return dict(tokens=f(T, B, FS * FS, D, sc=0.5), pos=f(FS * FS, D, sc=0.2),
                fpn0=f(T, B, 4 * FS, 4 * FS, D, sc=0.3), fpn1=f(T, B, 2 * FS, 2 * FS, D, sc=0.3),
                coords=coords, labels=labels, proj=f(T, B, 1, 4 * FS, 4 * FS))


def run_clip(api, tokens, pos, fpn0, fpn1, coords, labels, proj):
    """The clip's loss through one package; ``api`` adapts the calls."""
    s0, s1 = api.high_res(fpn0[0], fpn1[0])
    pix = api.no_mem(tokens[0]).reshape(B, FS, FS, D)
    heads = api.heads(pix, coords, labels, (s0, s1), False)
    mems = {0: api.encode(tokens[0], heads["high_res_masks"], heads["object_score_logits"], True)}
    ptrs = {0: heads["obj_ptr"]}
    loss = (heads["low_res_masks"] * proj[0]).sum()
    for t in range(1, T):
        cols, psrc = _bank(t)
        mem = api.stack([mems[s] for s, _ in cols]
                        + [api.zeros(mems[0].shape)] * (NM - len(cols)))
        tpos = np.zeros((B, NM), np.int64)
        tpos[:, :len(cols)] = [tp for _, tp in cols]
        valid = np.arange(NM)[None].repeat(B, 0) < len(cols)
        obj_ptrs = api.stack([ptrs[s] for s, _ in psrc]
                             + [api.zeros(ptrs[0].shape)] * (NP - len(psrc)))
        tdiff = np.zeros((B, NP), np.float32)
        tdiff[:, :len(psrc)] = [d for _, d in psrc]
        pvalid = np.arange(NP)[None].repeat(B, 0) < len(psrc)
        cond = api.cond(tokens[t], pos, mem, tpos, valid, obj_ptrs, tdiff, pvalid,
                        float(min(T, NP)))
        s0, s1 = api.high_res(fpn0[t], fpn1[t])
        heads = api.heads(cond.reshape(B, FS, FS, D), np.zeros((B, 1, 2), np.float32),
                          -np.ones((B, 1), np.int64), (s0, s1), True)
        mems[t] = api.encode(tokens[t], heads["high_res_masks"], heads["object_score_logits"],
                             False)
        ptrs[t] = heads["obj_ptr"]
        loss = loss + (heads["low_res_masks"] * proj[t]).sum()
    return loss


class JaxApi:
    """The bound JAX TrackerCore inside one ``apply``, train=True."""

    def __init__(self, m):
        self.m = m

    def high_res(self, a, b):
        return self.m.sam_mask_decoder.high_res_convs(a, b)

    def no_mem(self, x):
        return self.m.no_mem_features(x)

    def heads(self, pix, coords, labels, hr, multimask):
        return self.m.forward_sam_heads(pix, jnp.asarray(coords), jnp.asarray(labels), hr,
                                        multimask, train=True)

    def encode(self, x, masks, scores, from_pts):
        return self.m.encode_memory(x, masks, scores, from_pts)

    def cond(self, x, pos, mem, tpos, valid, ptrs, tdiff, pvalid, max_td):
        return self.m.condition_features(x, pos, mem, jnp.asarray(tpos), jnp.asarray(valid), ptrs,
                                         jnp.asarray(tdiff), jnp.asarray(pvalid), max_td,
                                         train=True)

    @staticmethod
    def stack(xs):
        return jnp.stack(xs, axis=1)

    @staticmethod
    def zeros(shape):
        return jnp.zeros(shape, jnp.float32)


class PortApi(JaxApi):
    """The port's TrackerCore in training mode."""

    def heads(self, pix, coords, labels, hr, multimask):
        return self.m.forward_sam_heads(pix, torch.from_numpy(coords), torch.from_numpy(labels),
                                        hr, multimask)

    def cond(self, x, pos, mem, tpos, valid, ptrs, tdiff, pvalid, max_td):
        return self.m.condition_features(x, pos, mem, torch.from_numpy(tpos),
                                         torch.from_numpy(valid), ptrs, torch.from_numpy(tdiff),
                                         torch.from_numpy(pvalid), max_td)

    @staticmethod
    def stack(xs):
        return torch.stack(xs, dim=1)

    @staticmethod
    def zeros(shape):
        return torch.zeros(shape)


@pytest.fixture(scope="module")
def jax_clip():
    """(variables, inputs, loss, parameter gradients, token gradients)."""
    jcore = jtr.TrackerCore(**CFG)
    shapes = jax.eval_shape(lambda key: jtr.init_tracker_variables(jcore, key),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes)
    inp = clip_inputs()
    rest = {k: jnp.asarray(inp[k]) for k in ("pos", "fpn0", "fpn1", "proj")}

    def loss_fn(params, tokens):
        return jcore.apply({"params": params}, tokens, rest["pos"], rest["fpn0"], rest["fpn1"],
                           inp["coords"], inp["labels"], rest["proj"],
                           method=lambda m, *a: run_clip(JaxApi(m), *a))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        loss, (g_params, g_tokens) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
            variables["params"], jnp.asarray(inp["tokens"]))
    return variables, inp, float(loss), g_params, np.asarray(g_tokens)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * max(scale, 1e-12), (what, err, scale)  # relative to its own range


def test_training_clip_matches_jax(jax_clip):
    """Loss and every gradient of the 3-frame training clip, against
    jax.value_and_grad of the same composition of the JAX methods."""
    variables, inp, want_loss, g_params, g_tokens = jax_clip
    pcore = load_jax_variables(ptr.TrackerCore(**CFG, dropout=0.0), variables).train()
    tokens = torch.from_numpy(inp["tokens"]).requires_grad_()
    rest = [torch.from_numpy(inp[k]) for k in ("pos", "fpn0", "fpn1")]
    loss = run_clip(PortApi(pcore), tokens, *rest, inp["coords"], inp["labels"],
                    torch.from_numpy(inp["proj"]))
    loss.backward()
    assert abs(loss.item() - want_loss) <= TOL * max(1.0, abs(want_loss))
    _close(tokens.grad, g_tokens, what="tokens")
    want = convert_variables({"params": g_params})
    got = dict(pcore.named_parameters())
    assert got.keys() == want.keys()
    moved = {"memory_attention": 0, "memory_encoder": 0, "sam_mask_decoder": 0,
             "sam_prompt_encoder": 0}
    for name, p in got.items():
        if p.grad is None:  # not on the clip's path: JAX's gradient is zero there
            assert not np.any(want[name]), name
            continue
        if ZERO_GRAD.fullmatch(name):
            # 0 in exact arithmetic: what both frameworks give is float noise
            assert max(p.grad.abs().max().item(), np.abs(want[name]).max()) <= 1e-6, name
            continue
        _close(p.grad, want[name], what=name)
        top = name.split(".")[0]
        if top in moved and p.grad.abs().max() > 0:
            moved[top] += 1
    assert all(moved.values()), moved  # every module group took part


def test_mask_decoder_training_flag_matches_jax():
    """Without multimask output, eval mode takes the dynamic choice by
    stability and training mode takes mask 0, in both packages; here mask
    0 is unstable, so the two modes give different masks."""
    rng = np.random.default_rng(3)
    d = D
    jm = JMaskDecoder(transformer_dim=d)
    img = rng.standard_normal((2, 4, 4, d)).astype(np.float32)
    pe = rng.standard_normal((4, 4, d)).astype(np.float32)
    sparse = rng.standard_normal((2, 3, d)).astype(np.float32)
    dense = rng.standard_normal((2, 4, 4, d)).astype(np.float32)
    hr = (rng.standard_normal((2, 16, 16, d // 8)).astype(np.float32),
          rng.standard_normal((2, 8, 8, d // 4)).astype(np.float32))
    args = tuple(jnp.asarray(a) for a in (img, pe, sparse, dense))
    jhr = tuple(jnp.asarray(a) for a in hr)
    # the decoder's subtree of the tiny tracker's variables (high_res_convs included)
    jcore = jtr.TrackerCore(**CFG)
    shapes = jax.eval_shape(lambda key: jtr.init_tracker_variables(jcore, key),
                            jax.random.PRNGKey(0))
    v = {"params": random_variables(shapes, seed=2)["params"]["sam_mask_decoder"]}
    pm = load_jax_variables(MaskDecoder(transformer_dim=d), v)
    targs = tuple(torch.from_numpy(a) for a in (img, pe, sparse, dense))
    thr = tuple(torch.from_numpy(a) for a in hr)
    for train in (False, True):
        want = jm.apply(v, *args, False, jhr, train=train)
        got = pm.train(train)(*targs, False, thr)
        for g, w in zip(got, want):
            _close(g, w, 2e-5)
    train_masks = pm.train()(*targs, False, thr)[0]
    assert torch.equal(train_masks, pm.predict_masks(*targs, thr)[0][:, 0:1])
    assert not torch.equal(pm.eval()(*targs, False, thr)[0], train_masks)


def test_memory_attention_dropout_is_live_and_seeded():
    """In training mode the memory attention's dropout draws torch's bits:
    the same seed gives the same output, another seed another; eval mode is
    the identity (the output of a dropout-0 core in training mode)."""
    rng = np.random.default_rng(6)
    core = ptr.init_tracker_parameters(ptr.TrackerCore(**CFG), seed=1)
    same = ptr.init_tracker_parameters(ptr.TrackerCore(**CFG, dropout=0.0), seed=1)
    args = (torch.from_numpy(rng.standard_normal((B, FS * FS, D)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((FS * FS, D)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((B, NM, FS, FS, MD)).astype(np.float32)),
            torch.zeros((B, NM), dtype=torch.long), torch.ones((B, NM), dtype=torch.bool),
            torch.from_numpy(rng.standard_normal((B, NP, D)).astype(np.float32)),
            torch.zeros((B, NP)), torch.ones((B, NP), dtype=torch.bool))
    outs = []
    for seed in (0, 0, 1):
        torch.manual_seed(seed)
        outs.append(core.train().condition_features(*args))
    assert torch.equal(outs[0], outs[1]) and not torch.allclose(outs[0], outs[2])
    with torch.no_grad():
        evaluated = core.eval().condition_features(*args)
        assert torch.equal(evaluated, same.train().condition_features(*args))
        assert not torch.allclose(evaluated, outs[0])
