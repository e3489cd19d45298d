"""Stage-1 distillation and the ViT trunks' training mode of the PyTorch
port against the JAX package, on the CPU in fp32:

  - the plain d=64 and d=80 attention backward (``flash_sdpa_bwd_dq_plain``
    / ``_dkv_plain``, the arithmetic of csrc/flash_sdpa_bwd_dq_h.cu and
    csrc/flash_sdpa_bwd_h.cu) against the
    Pallas ``_flash_bwd`` in interpret mode, and ``flash_sdpa`` under
    autograd against ``jax.grad`` of the JAX ``flash_sdpa``;
  - ``DropPath`` (identity, per-sample masks from a generator, the refusal
    without one beside flax's);
  - a tiny ``ViTTrunk`` in training mode (112^2, width 128, 2 heads of 64,
    depth 2, window 4, block 1 global) against ``ViTTrunk.apply(train=True)``
    under ``jax.grad``, checkpointed and not, with and without drop path;
  - the Stage-1 step on JAX's own tiny configuration (EfficientViT b0,
    embed 32 at 4x4, 32^2 images): loss parts, 3 optimizer steps, the
    updated parameters and BatchNorm statistics, the cosine schedule;
  - TinyViT-11M's drop path, and the Stage-1 step's refusal of it;
  - ``data/sa1b.py``: the teacher export round trip, the replayed
    augmentation and the batches.

Inputs and weights are drawn with numpy from seeds, the weights over the
shapes ``jax.eval_shape`` reports, carried across by ``utils/convert.py``.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import _torch_threads  # noqa: F401

import flax
import jax
import jax.numpy as jnp

from efficientsam3_tpu.data import sa1b as jsa1b
from efficientsam3_tpu.models import common as jcommon
from efficientsam3_tpu.models import vitdet as jvit
from efficientsam3_tpu.ops.pallas import flash_attention as jfa
from efficientsam3_tpu.train import stage1 as jstage1
from efficientsam3_tpu_torch.build import init_parameters, make_student_trunk
from efficientsam3_tpu_torch.data import sa1b
from efficientsam3_tpu_torch.models import vitdet as pvit
from efficientsam3_tpu_torch.models.common import DropPath
from efficientsam3_tpu_torch.ops import flash_attention as fa
from efficientsam3_tpu_torch.train import stage1
from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig
from efficientsam3_tpu_torch.utils.convert import convert_variables, load_jax_variables

NEG_INF = fa.NEG_INF
TRUNK = dict(embed_dim=128, depth=2, num_heads=2, window_size=4, global_att_blocks=(1,),
             pretrain_grid=4)
TINY = dict(backbone_type="efficientvit", model_name="b0", embed_dim=32, embed_size=4,
            image_size=64)


def random_variables(shapes, seed=0):
    """Seeded numpy values over flax variable shapes: fan-in scaled kernels,
    positive BatchNorm variances, scales near 1."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf, sh = path[-1].key, s.shape
        if leaf == "var":
            a = rng.uniform(0.5, 1.5, sh)
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(sh)
        elif len(sh) == 1:
            a = 0.1 * rng.standard_normal(sh)
        elif leaf == "pos_embed":
            a = rng.standard_normal(sh) / np.sqrt(sh[-1])
        else:
            a = rng.standard_normal(sh) / np.sqrt(np.prod(sh[:-1]))
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------------- the backward at d=64 / d=80


def attention_inputs(b, h, lq, lk, d, seed):
    """q/k/v/dO (fp32), a key bias masking a 64-key tile and the ragged tail
    of row 0 and every key of the last row."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for n in (lq, lk, lk))
    do = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    bias = np.zeros((b, lk), np.float32)
    bias[0, 64:128] = NEG_INF
    bias[0, lk - 13:] = NEG_INF
    bias[-1] = NEG_INF
    return q, k, v, bias, do


BWD_SHAPES = [pytest.param((2, 2, 160, 200, 64), id="d64"),
              pytest.param((2, 2, 96, 150, 80), id="d80")]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bwd_plain_matches_pallas_bwd(shape):
    """dq (with Delta) and dk/dv of the plain versions against ``_flash_bwd``
    in interpret mode on the same saved output and lse: ragged Lq and Lk
    against 32-query and 64-key blocks, masked keys, a fully masked batch
    row (zero gradients). fp32 sums over ~200 keys in other orders: 1e-5
    of each gradient's largest magnitude."""
    q, k, v, bias, do = attention_inputs(*shape, seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tb = torch.from_numpy(bias)
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_sdpa_plain(tq, tk, tv, tb, scale, return_lse=True)
    dq, delta = fa.flash_sdpa_bwd_dq_plain(tq, tk, tv, tb, o, lse, tdo, scale)
    dk, dv = fa.flash_sdpa_bwd_dkv_plain(tq, tk, tv, tb, tdo, lse, delta, scale)
    want = jfa._flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                          jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(do),
                          scale, 32, 64, True)
    close(delta, (do * o.numpy()).sum(-1), 1e-5)
    for got, w in zip((dq, dk, dv), want):
        close(got, w, 1e-5)
        assert (got[-1] == 0).all()


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_sdpa_cpu_autograd_matches_jax_grad(shape):
    """On CPU tensors ``flash_sdpa`` is its plain version under autograd;
    ``jax.grad`` through the JAX ``flash_sdpa`` (custom VJP, Pallas kernels
    in interpret mode) gives the same gradients (1e-5)."""
    q, k, v, bias, do = attention_inputs(*shape, seed=4)

    def jloss(q_, k_, v_):
        out = jfa.flash_sdpa(q_, k_, v_, jnp.asarray(bias), block_q=32, block_k=64,
                             interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (fa.flash_sdpa(*leaves, torch.from_numpy(bias)) * torch.from_numpy(do)).sum().backward()
    for leaf, w in zip(leaves, want):
        close(leaf.grad, w, 1e-5)


# ---------------------------------------------------------------- DropPath


def test_drop_path_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 3, 3, 8)
    assert DropPath(0.3).eval()(x) is x
    assert DropPath(0.0).train()(x) is x


def test_drop_path_masks_samples_from_a_seeded_generator():
    """At rate 0.5 in training mode every sample is either 0 or x / 0.5, and
    the same seed gives the same masks."""
    x = torch.randn(64, 2, 2, 4) + 3.0
    dp = DropPath(0.5).train()
    a = dp(x, torch.Generator().manual_seed(7))
    b = dp(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    kept = (a != 0).flatten(1).all(1)
    dropped = (a == 0).flatten(1).all(1)
    assert (kept | dropped).all() and kept.any() and dropped.any()
    assert torch.equal(a[kept], x[kept] / 0.5)


def test_drop_path_without_a_generator_raises_as_flax_does():
    """Both refuse to draw a mask without a random stream: the port without
    a generator (ValueError), flax without a 'dropout' rng."""
    with pytest.raises(ValueError, match="Generator"):
        DropPath(0.1).train()(torch.ones(2, 3))
    x = jnp.ones((2, 3))
    with pytest.raises(flax.errors.InvalidRngError):
        jcommon.DropPath(0.1).apply({}, x, train=True)


# ---------------------------------------------------------------- ViTTrunk in training


@pytest.fixture(scope="module")
def vit():
    """The tiny trunk's JAX module and variables, a seeded input and
    projection, and the loss and parameter gradients of sum(out * w) under
    jax.grad with the trunk in training mode (remat on)."""
    jm = jvit.ViTTrunk(drop_path_rate=0.0, **TRUNK)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 112, 112, 3)).astype(np.float32)
    w = rng.standard_normal((2, 8, 8, 128)).astype(np.float32)
    variables = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                                jnp.asarray(x)), seed=6)

    @jax.jit
    def loss_grad(params):
        def loss(p):
            out = jm.apply({"params": p}, jnp.asarray(x), train=True)
            return jnp.sum(out * jnp.asarray(w)), out
        return jax.value_and_grad(loss, has_aux=True)(params)

    (loss, out), grads = loss_grad(variables["params"])
    return dict(jm=jm, variables=variables, x=x, w=w, loss=loss, out=out,
                grads=convert_variables({"params": grads}))


def port_vit(variables, rate=0.0):
    pm = pvit.ViTTrunk(drop_path_rate=rate, **TRUNK).train()
    return load_jax_variables(pm, variables)


def no_checkpoint(fn, *args, **kw):
    """torch.utils.checkpoint's place when a run keeps every activation."""
    return fn(*args)


def vit_grads(pm, x, w, generator=None):
    pm.zero_grad()
    out = pm(torch.from_numpy(x), generator=generator)
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    return loss, out, {k: p.grad.clone() for k, p in pm.named_parameters()}


def test_vit_trunk_training_matches_jax_grad(vit):
    """Output (1e-5 of max(1, |largest|)), the loss (a sum of 16384
    products: 1e-5 of the sum of their magnitudes) and every parameter's
    gradient (1e-4 of max(1, its largest magnitude): fp32 through two
    blocks and their backward, summed in other orders) of the trunk in
    training mode, block 1's attention on the plain flash_sdpa, against
    jax.grad."""
    pm = port_vit(vit["variables"])
    loss, out, grads = vit_grads(pm, vit["x"], vit["w"])
    close(out, vit["out"], 1e-5)
    assert abs(loss.item() - float(vit["loss"])) <= 1e-5 * np.abs(vit["out"] * vit["w"]).sum()
    assert grads.keys() == vit["grads"].keys()
    for name, g in grads.items():
        close(g, vit["grads"][name], 1e-4)


def test_vit_checkpointing_gives_the_same_gradients(vit, monkeypatch):
    """Per-block checkpointing recomputes each block's activations in the
    backward: the gradients equal those of a run that keeps them (the
    checkpoint call replaced by a plain call), bit for bit."""
    pm = port_vit(vit["variables"])
    _, _, with_remat = vit_grads(pm, vit["x"], vit["w"])
    monkeypatch.setattr(pvit, "checkpoint", no_checkpoint)
    _, _, without = vit_grads(pm, vit["x"], vit["w"])
    for name, g in with_remat.items():
        assert torch.equal(g, without[name]), name


def test_vit_drop_path_trains_with_a_generator(vit, monkeypatch):
    """At rate 0.1 (block 1's rate at depth 2) the trunk trains with a
    generator: the masks are drawn before each checkpointed block, so the
    recompute drops the same samples and the same seed gives the same
    gradients, with and without remat; seed 3 drops a sample of the batch
    of 8, so they differ from the gradients at rate 0."""
    x = np.concatenate([vit["x"]] * 4)
    w = np.concatenate([vit["w"]] * 4)
    pm = port_vit(vit["variables"], rate=0.1)
    runs = [vit_grads(pm, x, w, torch.Generator().manual_seed(3)) for _ in range(2)]
    with monkeypatch.context() as mp:
        mp.setattr(pvit, "checkpoint", no_checkpoint)
        runs.append(vit_grads(pm, x, w, torch.Generator().manual_seed(3)))
    for name, g in runs[0][2].items():
        assert torch.isfinite(g).all()
        assert torch.equal(g, runs[1][2][name]) and torch.equal(g, runs[2][2][name]), name
    _, _, undropped = vit_grads(port_vit(vit["variables"]), x, w)
    assert any(not torch.allclose(g, undropped[n]) for n, g in runs[0][2].items())


def test_stage1_step_refuses_drop_path_without_rng_in_both_packages(vit):
    """At drop_path_rate 0.1 the Stage-1 step passes no random stream:
    flax raises InvalidRngError, the port ValueError."""
    jm = jvit.ViTTrunk(drop_path_rate=0.1, **TRUNK)
    batch = {"image": vit["x"], "teacher": np.zeros((2, 8, 8, 128), np.float32),
             "valid": np.ones((2, 8, 8), np.float32)}
    tx = optax.adamw(1e-3)
    with pytest.raises(flax.errors.InvalidRngError):
        jax.eval_shape(functools.partial(jstage1.stage1_train_step, jm, tx), vit["variables"],
                       tx.init(vit["variables"]["params"]), *(jnp.asarray(batch[k]) for k in
                                                              ("image", "teacher", "valid")))
    pm = port_vit(vit["variables"], rate=0.1)
    opt = stage1.make_optimizer(stage1.Stage1ImageConfig(), 10, pm)
    with pytest.raises(ValueError, match="Generator"):
        stage1.stage1_train_step(pm, opt, batch)


# ---------------------------------------------------------------- the Stage-1 step


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's tiny Stage-1 configuration (64^2 images, so the last stage's
    BatchNorm sees 8 values a channel): seeded variables, a seeded batch
    of 2 with a partial valid mask, 3 jitted steps of stage1_train_step
    under make_optimizer (steps_per_epoch 2, so the schedule moves), its
    optimizer tapped for the gradients it is given; the loss at the start,
    and each step's metrics, gradients and variables after it."""
    cfg = jstage1.Stage1ImageConfig(**TINY)
    model = jstage1.make_student(cfg)
    rng = np.random.default_rng(8)
    batch = {"image": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
             "teacher": rng.standard_normal((2, 4, 4, 32)).astype(np.float32),
             "valid": np.ones((2, 4, 4), np.float32)}
    batch["valid"][1, 3:] = 0.0
    shapes = jax.eval_shape(lambda key: model.init(key, jnp.asarray(batch["image"]), train=True),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=9)
    tx = jstage1.make_optimizer(cfg, steps_per_epoch=2)

    def tap_update(grads, state, params):  # hands the gradients out with the state
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    tap = optax.GradientTransformation(
        lambda p: (tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)), tap_update)
    opt_state = tap.init(variables["params"])
    step = jax.jit(functools.partial(jstage1.stage1_train_step, model, tap))
    jbatch = [jnp.asarray(batch[k]) for k in ("image", "teacher", "valid")]
    out = dict(batch=batch, variables=[variables], metrics=[], grads=[], tx=tx,
               loss0=jstage1.stage1_loss(model, variables, *jbatch))
    for _ in range(3):
        variables, opt_state, m = step(variables, opt_state, *jbatch)
        out["variables"].append(variables)
        out["grads"].append(opt_state[1])
        out["metrics"].append({k: float(v) for k, v in m.items()})
    return out


def port_student(variables):
    cfg = stage1.Stage1ImageConfig(**TINY)
    return load_jax_variables(stage1.make_student(cfg), variables), cfg


def test_stage1_loss_matches_jax(jax_steps):
    """The masked MSE, the masked cosine loss and their sum on the student
    in training mode (batch statistics), 1e-5."""
    pm, cfg = port_student(jax_steps["variables"][0])
    b = jax_steps["batch"]
    total, mse, cos = stage1.stage1_loss(pm, *(torch.from_numpy(b[k]) for k in
                                              ("image", "teacher", "valid")), cfg)
    want_total, (want_mse, want_cos, _) = jax_steps["loss0"]
    for got, want in ((total, want_total), (mse, want_mse), (cos, want_cos)):
        close(got, want, 1e-5)


LR = 1e-3 * 64 / 512  # the tiny configuration's peak learning rate


def test_stage1_steps_match_jax(jax_steps):
    """Three steps of stage1_train_step under make_optimizer through
    Trainer from the same variables. The first step's loss, mse and cosine
    within 1e-5 and its BatchNorm statistics within 1e-5 of max(1, the
    tensor's largest magnitude). AdamW moves every parameter by about the
    learning rate a step whatever its gradient's size, so an entry whose
    gradient is at rounding noise (BatchNorm biases followed by another
    BatchNorm, whose exact gradient is 0) may move the other way: after
    step i every parameter within 2 i lr (+ 1e-5 of max(1, |largest|)) of
    JAX's, every step's metrics within 1e-4 and the statistics of steps 2
    and 3 within 1e-3 of max(1, |largest|)."""
    pm, cfg = port_student(jax_steps["variables"][0])
    opt = stage1.make_optimizer(cfg, 2, pm)
    params = {k for k, _ in pm.named_parameters()}
    seen = []

    def step(model, optimizer, batch):
        metrics = stage1.stage1_train_step(model, optimizer, batch)
        seen.append(({k: float(v) for k, v in metrics.items()},
                     {k: v.detach().clone() for k, v in model.state_dict().items()}))
        return metrics

    cfg_t = TrainerConfig(max_steps=3, log_every=1, handle_preemption_signals=False)
    assert Trainer(step, cfg_t).run(pm, opt, iter([jax_steps["batch"]] * 3)) == 3
    assert opt.count == 3
    for i, ((metrics, state), want_m, want_v) in enumerate(zip(
            seen, jax_steps["metrics"], jax_steps["variables"][1:]), 1):
        for key in ("loss", "mse", "cosine"):
            close(metrics[key], want_m[key], 1e-5 if i == 1 else 1e-4)
        want = convert_variables(want_v)
        assert want.keys() == state.keys()
        for name, value in want.items():
            got = state[name].numpy()
            if name in params:
                bound = 2 * i * LR + 1e-5 * max(1.0, np.abs(value).max())
                assert np.abs(got - value).max() <= bound, (i, name)
            else:
                close(got, value, 1e-5 if i == 1 else 1e-3)


def test_stage1_optimizer_matches_optax(jax_steps):
    """The optimizer alone over the 3 steps: given the gradients the JAX
    step handed its optax chain (x40, so the global norm passes the clip
    of 5 and the clip branch runs), clip + AdamW + the cosine schedule
    give the parameters optax gives, within two fp32 ulps of the parameter
    plus 1e-3 of the learning rate."""
    tx = jax_steps["tx"]
    params = jax_steps["variables"][0]["params"]
    pm, cfg = port_student(jax_steps["variables"][0])
    opt = stage1.make_optimizer(cfg, 2, pm)
    state = tx.init(params)

    @jax.jit
    def update(grads, state, params):
        grads = jax.tree_util.tree_map(lambda g: 40.0 * g, grads)
        updates, state = tx.update(grads, state, params)
        return grads, optax.global_norm(grads), state, optax.apply_updates(params, updates)

    clipped = 0
    for grads in jax_steps["grads"]:
        grads, norm, state, params = update(grads, state, params)
        clipped += float(norm) > cfg.grad_clip
        flat = convert_variables({"params": grads})
        for k, p in pm.named_parameters():
            p.grad = torch.tensor(flat[k])
        opt.step()
        want = convert_variables({"params": params})
        for k, p in pm.named_parameters():
            tol = 2 * np.spacing(np.abs(want[k]).astype(np.float32)) + 1e-3 * LR
            assert (np.abs(p.detach().numpy() - want[k]) <= tol).all(), k
    assert clipped == 3


@pytest.mark.parametrize("steps_per_epoch,counts", [(2, (0, 1, 5, 99, 100, 150)),
                                                    (7, (0, 3, 349, 350))])
def test_cosine_schedule_matches_optax(steps_per_epoch, counts):
    """The learning rate a step reads: optax's cosine_decay_schedule of
    the JAX optimizer at the same counts, clipped past the horizon."""
    cfg = stage1.Stage1ImageConfig()
    lr = cfg.base_lr * cfg.global_batch / 512.0
    want = optax.cosine_decay_schedule(lr, cfg.epochs * steps_per_epoch, alpha=1e-2)
    got = stage1.cosine_decay_schedule(lr, cfg.epochs * steps_per_epoch, alpha=1e-2)
    for c in counts:
        assert abs(got(c) - float(want(c))) <= 1e-7 * lr, c


def test_tiny_vit_11m_drop_path_trains_with_a_generator():
    """TinyViT-11M (drop path 0.1) trains with a generator; the Stage-1
    step, which passes none, refuses it (as JAX's does: flax raises
    InvalidRngError there, shown for the ViT trunk above)."""
    model = init_parameters(make_student_trunk("tinyvit", "11m", embed_dim=32, embed_size=2))
    model.train()
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((4, 64, 64, 3))
                         .astype(np.float32))
    out = model.head(model.trunk(x, generator=torch.Generator().manual_seed(0)))
    out.square().mean().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    opt = stage1.make_optimizer(stage1.Stage1ImageConfig(), 10, model)
    batch = {"image": x.numpy(), "teacher": np.zeros((4, 2, 2, 32), np.float32),
             "valid": np.ones((4, 2, 2), np.float32)}
    with pytest.raises(ValueError, match="Generator"):
        stage1.stage1_train_step(model, opt, batch)


# ---------------------------------------------------------------- data/sa1b.py


@pytest.fixture
def image_files(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray((rng.random((40 + i * 5, 60, 3)) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def test_export_and_dataset_roundtrip(image_files, tmp_path):
    """tests/test_data_stage1.py's round trip on the port's copy: the
    student sees exactly the image the teacher saw, the fp16 record comes
    back, the valid mask and the batches; the record file equals the one
    the JAX package writes from the same teacher, byte for byte."""
    E, C, S = 4, 8, 32
    captured = []

    def fake_teacher(imgs):
        captured.append(imgs.copy())
        out = np.zeros((imgs.shape[0], E, E, C), np.float32)
        out[..., 0] = imgs.mean(axis=(1, 2, 3))[:, None, None]
        return out

    store = str(tmp_path / "store.bin")
    sa1b.export_teacher_embeddings(fake_teacher, image_files, store, image_size=S,
                                   batch_size=2, seed=1)
    jstore = str(tmp_path / "jstore.bin")
    jsa1b.export_teacher_embeddings(fake_teacher, image_files, jstore, image_size=S,
                                    batch_size=2, seed=1)
    assert open(store, "rb").read() == open(jstore, "rb").read()

    ds = sa1b.SA1BDistillationDataset(image_files, store, image_size=S, embed_dim=C,
                                      embed_size=E)
    assert len(ds) == 4
    s0 = ds[0]
    assert s0["image"].shape == (S, S, 3) and s0["teacher"].shape == (E, E, C)
    np.testing.assert_allclose(s0["image"], captured[0][0], atol=1e-6)
    np.testing.assert_allclose(s0["teacher"][0, 0, 0], captured[0][0].mean(), atol=1e-3)
    assert 0 < s0["valid"].sum() <= E * E
    jds = jsa1b.SA1BDistillationDataset(image_files, jstore, image_size=S, embed_dim=C,
                                        embed_size=E)
    for i in range(4):
        got, want = ds[i], jds[i]
        for key in ("image", "teacher", "valid"):
            assert np.array_equal(got[key], want[key]), (i, key)
    batches = list(sa1b.batch_iterator(ds, batch_size=2, epochs=1, shuffle=False))
    assert len(batches) == 2 and batches[0]["image"].shape == (2, S, S, 3)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2**32 - 2])
def test_replayed_augment_matches_jax(seed):
    """Flip, crop and resize replayed from the seed: the same pixels."""
    img = (np.random.default_rng(seed % 1000).random((37, 53, 3)) * 255).astype(np.uint8)
    assert np.array_equal(sa1b.replayed_augment(img, seed, 24),
                          jsa1b.replayed_augment(img, seed, 24))
    assert np.array_equal(sa1b.pad_to_square(img), jsa1b.pad_to_square(img))


def test_batch_iterator_matches_jax():
    """The shuffled batches of two epochs for the same seed, key by key."""

    class Items:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return {"x": np.full((2, 3), i, np.float32), "i": np.int64(i)}

    got = list(sa1b.batch_iterator(Items(), batch_size=3, seed=5, epochs=2))
    want = list(jsa1b.batch_iterator(Items(), batch_size=3, seed=5, epochs=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            assert np.array_equal(g[key], w[key])
