"""The port's multi-GPU layer (efficientsam3_tpu_torch/parallel) against the
JAX package's, on the CPU.

One launch of two gloo ranks (a file:// rendezvous, no TCP port) runs every
strategy; the main process meanwhile computes the references, and the
parametrised cases compare:

  - data-parallel Stage 1 through ``Trainer(mesh=dp 2)`` (the dryrun's
    config: EfficientViT b0, embed 64 at 4x4, 32^2 images, AdamW 1e-3;
    the last BatchNorm sees one value a channel per image, so a rank's
    local statistics are far from the global batch's) against JAX's
    single-device ``stage1_train_step`` on the global batch of 4; rank 1
    starts from other weights, which the broadcast replaces;
  - ``sam3_detection_loss`` on random predictions split over the ranks,
    with the world's box count (``stage3._world_num_boxes``), against the
    single-process loss and gradient;
  - the tiny detector (b0, embed 9, 72^2, 2 + 2 layers, 200 queries;
    weights drawn over the port's state_dict, which the ranks draw again,
    carried to JAX by the inverse of utils/convert.py) sharded over tp = 2: its forward against JAX's unsharded forward, its
    fp64 gradients against the port's unsharded ones (a sharded
    parameter's against its slice);
  - ``frame_parallel`` over 4 frames of that detector against 4 single
    grounds, and through ``VideoPCSPredictor``'s chunked detection
    (``detector_batch`` + ``frame_chunk``);
  - object-parallel tracking with the dryrun's toy tracker (4 slots over 2
    ranks, 3 frames, two objects) against JAX's ``TrackerPredictor``
    without a mesh on the same plain path (the mesh turns the cached bank
    off, as in JAX);
  - a mesh accepted by ``Trainer`` and ``TrackerPredictor``, and their
    refusals (a mesh without the batch axis; obj_slots that do not divide);
  - a preemption flag set on one rank only: the Trainer stops both ranks on
    the same step.

Without a launch: ``initialize_distributed``'s env wiring with
``dist.init_process_group`` monkeypatched, ``tp_param_spec`` against JAX's
on JAX's fake tree and on the full-depth detector (246 leaves, each
sharding JAX's dim transposed).
"""

import datetime
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from efficientsam3_tpu.build import make_student_trunk as jmake_trunk
from efficientsam3_tpu.models.geometry import Prompt as JPrompt
from efficientsam3_tpu.models.sam3_image import Sam3ImageModel as JModel
from efficientsam3_tpu.parallel import count_sharded as jcount_sharded
from efficientsam3_tpu.parallel import tp_param_spec as jtp_param_spec
from efficientsam3_tpu.train import stage1 as jstage1
from efficientsam3_tpu.video.predictor import TrackerPredictor as JPredictor
from efficientsam3_tpu.video.tracker import TrackerCore as JCore
from efficientsam3_tpu.video.tracker import init_tracker_variables
from efficientsam3_tpu_torch import parallel
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.train import losses
from efficientsam3_tpu_torch.utils.convert import _flatten, _walk, convert_variables

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 180  # the two ranks together; a hang fails here, not at the suite's limit

STAGE1 = dict(backbone_type="efficientvit", model_name="b0", embed_dim=64, embed_size=4,
              image_size=32)
DET = dict(model_name="b0", embed_size=9, text_encoder_type="MobileCLIP-S0",
           text_encoder_context_length=16, fusion_layers=2, decoder_layers=2)
TOY_CORE = dict(image_size=64, backbone_stride=8, d_model=32, mem_dim=8, num_maskmem=3,
                max_obj_ptrs=4)
OUT_KEYS = ("pred_logits", "pred_boxes", "pred_masks", "presence_logit_dec")
LR = 1e-3


def random_variables(shapes, seed):
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
        elif leaf in ("embedding", "positional_embedding"):
            a = rng.standard_normal(sh) / np.sqrt(sh[-1])
        else:
            a = rng.standard_normal(sh) / np.sqrt(np.prod(sh[:-1]))
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def state_dict_of(variables):
    return {k: torch.tensor(v) for k, v in convert_variables(variables).items()}


# shared with the ranks, which draw the detector's weights themselves
_SEEDED = r"""
def seeded_state_dict(model, seed):
    # seeded numpy values over a port model's state_dict by the rule of
    # random_variables over flax leaves: fan-in scaled weights (embeddings
    # by their width), norm weights near 1, positive running variances
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        sh = tuple(v.shape)
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, sh)
        elif len(sh) == 1 and k.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(sh)
        elif len(sh) <= 1:
            a = 0.1 * rng.standard_normal(sh)
        else:
            a = rng.standard_normal(sh) / np.sqrt(np.prod(sh[1:]))
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out
"""
exec(_SEEDED)


def flax_variables(shapes, state_dict):
    """The inverse of utils/convert.py's walk: flax variables of ``shapes``
    (``jax.eval_shape`` of an init) holding a port model's state_dict."""
    paths = [(c, path) for c, tree in shapes.items() for path, _ in _flatten(tree)]
    out = {}
    for (c, path), (key, _, axes) in zip(paths, _walk(shapes)):
        a = state_dict[key].numpy()
        node = out.setdefault(c, {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = jnp.asarray(a if axes is None else a.transpose(np.argsort(axes)))
    return out


def _boxes(rng, shape):
    xy = rng.uniform(0.15, 0.85, shape + (2,))
    wh = rng.uniform(0.05, 0.5, shape + (2,))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def loss_inputs(b=4, q=12, t=5, a=2, hw=16, seed=3):
    """Training-forward outputs of a batch of b (aux layers first: their
    batch is axis 1), o2m queries placed on targets so the one-to-many
    matcher finds pairs, and padded targets with an uneven count a sample."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((a + 1, b, 2 * q, 1)).astype(np.float32)
    boxes = _boxes(rng, (a + 1, b, 2 * q))
    tgt = _boxes(rng, (b, t))
    valid = np.zeros((b, t), bool)
    for i, n in enumerate((4, 2, 1, 3)[:b]):
        valid[i, :n] = True
    boxes[-1, :, q:q + 3] = tgt[:, :1] + rng.uniform(-0.01, 0.01, (b, 3, 4))
    logits[-1, :, q:q + 3] = 3.0
    masks = rng.standard_normal((b, 2 * q, hw, hw)).astype(np.float32)
    presence = rng.standard_normal((a + 1, b)).astype(np.float32)
    outs = {
        "pred_logits": logits[-1][:, :q], "pred_boxes": boxes[-1][:, :q],
        "pred_masks": masks[:, :q], "presence_logit_dec": presence[-1],
        "aux.pred_logits": logits[:-1], "aux.pred_boxes": boxes[:-1],
        "aux.presence_logits": presence[:-1],
        "pred_logits_o2m": logits[-1][:, q:], "pred_boxes_o2m": boxes[-1][:, q:],
        "pred_masks_o2m": masks[:, q:],
    }
    targets = {"boxes": tgt, "valid": valid,
               "masks": (rng.random((b, t, hw, hw)) > 0.5).astype(np.float32)}
    return outs, targets


def nest(flat):
    """{'aux.x': ...} -> {'aux': {'x': ...}}."""
    out = {}
    for k, v in flat.items():
        if k.startswith("aux."):
            out.setdefault("aux", {})[k[4:]] = v
        else:
            out[k] = v
    return out


def detection_loss(outs_flat, targets, **kw):
    return losses.sam3_detection_loss(nest(outs_flat), targets, **kw)


_RANK = r"""
import itertools
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, rdzv, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + rdzv, rank=rank, world_size=2)
from efficientsam3_tpu_torch import parallel
from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
from efficientsam3_tpu_torch.models.common import MultiheadAttention
from efficientsam3_tpu_torch.parallel.tensor_parallel import TensorParallelAttention
from efficientsam3_tpu_torch.models.geometry import Prompt
from efficientsam3_tpu_torch.parallel.sharding import data_parallel
from efficientsam3_tpu_torch.train import stage1, stage3
from efficientsam3_tpu_torch.train.losses import sam3_detection_loss
from efficientsam3_tpu_torch.train.trainer import Trainer, TrainerConfig
from efficientsam3_tpu_torch.video.pipeline import VideoPCSPredictor
from efficientsam3_tpu_torch.video.predictor import TrackerPredictor
from efficientsam3_tpu_torch.video.tracker import TrackerCore

inp = torch.load(work + "/inputs.pt", weights_only=False)
res = {}
OUT_KEYS = inp["out_keys"]


def local(x, axis=0):
    k = x.shape[axis] // 2
    return np.take(x, np.arange(rank * k, (rank + 1) * k), axis=axis)


try:
    # -- data-parallel Stage 1 through the Trainer
    dp = parallel.make_mesh({"dp": 2})
    model = stage1.make_student(stage1.Stage1ImageConfig(**inp["stage1_cfg"]))
    sd = inp["stage1_sd"]
    model.load_state_dict(sd if rank == 0 else {k: v + 1.0 for k, v in sd.items()})
    opt = torch.optim.AdamW(model.parameters(), lr=inp["lr"], eps=1e-8, weight_decay=1e-4)
    grads, seen = {}, {}
    adamw_step = opt.step

    def tapped_step(*a, **k):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return adamw_step(*a, **k)

    opt.step = tapped_step

    def step(m, o, batch):
        seen["local_batch"] = batch["image"].shape[0]
        metrics = stage1.stage1_train_step(m, o, batch)
        seen["metrics"] = {k: float(v) for k, v in metrics.items()}
        return metrics

    trainer = Trainer(step, TrainerConfig(max_steps=1, log_every=1, mesh=dp,
                                          handle_preemption_signals=False))
    assert trainer.run(model, opt, iter([inp["stage1_batch"]])) == 1
    res["dp"] = dict(grads=grads, state={k: v.clone() for k, v in model.state_dict().items()},
                     **seen)
    try:
        Trainer(step, TrainerConfig(max_steps=1, mesh=dp, batch_axis="data",
                                    handle_preemption_signals=False))
    except ValueError as e:
        res["trainer_refusal"] = str(e)

    # -- a preemption seen by rank 1 only, after its first step
    lin = torch.nn.Linear(3, 2)
    lin_opt = torch.optim.SGD(lin.parameters(), lr=0.1)
    calls = []

    def flagging_step(m, o, batch):
        calls.append(batch["x"].shape[0])
        o.zero_grad()
        m(batch["x"]).square().sum().backward()
        o.step()
        if rank == 1:
            preempting.preempted = True
        return {"loss": torch.zeros(())}

    preempting = Trainer(flagging_step, TrainerConfig(max_steps=3, log_every=1, mesh=dp,
                                                      handle_preemption_signals=False))
    reached = preempting.run(lin, lin_opt, itertools.repeat({"x": torch.ones(4, 3)}))
    res["preempt"] = dict(step=reached, calls=calls, preempted=preempting.preempted)

    # -- the Stage-3 loss over the ranks' halves, the world's box count
    outs_all, targets_all = inp["loss_outs"], inp["loss_targets"]
    outs = {k: torch.from_numpy(local(v, 1 if k.startswith("aux.") else 0)).requires_grad_()
            for k, v in outs_all.items()}
    targets = {k: torch.from_numpy(local(v)) for k, v in targets_all.items()}
    nested = {k: v for k, v in outs.items() if not k.startswith("aux.")}
    nested["aux"] = {k[4:]: v for k, v in outs.items() if k.startswith("aux.")}
    with data_parallel(dp.get_group("dp")):
        num_boxes = stage3._world_num_boxes(targets["valid"])
    total, parts = sam3_detection_loss(nested, targets, num_boxes=num_boxes)
    total.backward()
    res["loss"] = dict(total=float(total), num_boxes=float(num_boxes),
                       grads={k: v.grad for k, v in outs.items()})

    # -- tensor-parallel detector
    exec(inp["seeded"])

    def detector():  # the weights the main process gave JAX
        m = build_efficientsam3_image_model(device="cpu", **inp["det_cfg"])
        m.load_state_dict(seeded_state_dict(m, 2))
        return m

    tp = parallel.make_mesh({"tp": 2})
    images = torch.from_numpy(inp["det_images"])
    tokens = torch.from_numpy(inp["det_tokens"]).long()
    det = detector()
    spec = parallel.tp_param_spec(det)
    parallel.shard_params(det, tp, spec)
    with torch.no_grad():
        out = det(images, tokens, Prompt.empty(images.shape[0], 2, 2))

    def grads64(m):
        out = m(images.double(), tokens, Prompt.empty(images.shape[0], 2, 2))
        sum((out[k] ** 2).mean() for k in ("pred_logits", "pred_boxes", "pred_masks")
            ).backward()
        return {n: p.grad for n, p in m.named_parameters() if p.grad is not None}

    want = grads64(detector().double().requires_grad_(True))
    got = grads64(parallel.shard_params(detector().double().requires_grad_(True), tp))
    grad_err = {}
    for n, g in got.items():  # against the unsharded gradient's slice
        w = want[n]
        for dim, axis in enumerate(spec[n]):
            if axis is not None:
                k = w.shape[dim] // 2
                w = w.narrow(dim, rank * k, k)
        grad_err[n] = (tuple(g.shape) == tuple(w.shape) and (g - w).abs().max().item(),
                       w.abs().max().item())
    scoped = list(det.fusion_encoder.modules()) + list(det.decoder.modules())
    res["tp"] = dict(count=parallel.count_sharded(spec),
                     out={k: out[k] for k in OUT_KEYS}, grad_err=grad_err,
                     grad_names=(sorted(got), sorted(want)),
                     heads=sorted({m.num_heads for m in scoped if isinstance(m, MultiheadAttention)}),
                     offsets=sorted({m.head_offset for m in scoped
                                     if isinstance(m, TensorParallelAttention)}),
                     swapped=all(isinstance(m, TensorParallelAttention) for m in scoped
                                 if isinstance(m, MultiheadAttention)))

    # -- object-parallel tracking
    core = TrackerCore(**inp["toy_core"])
    core.load_state_dict(inp["toy_sd"])
    core.eval()
    fpn = [torch.from_numpy(a) for a in inp["toy_fpn"]]
    objects = parallel.make_mesh({"objects": 2})
    pred = TrackerPredictor(core, lambda img: {"sam2_fpn": fpn}, obj_slots=4,
                            max_point_prompts=4, mesh=objects)
    state = pred.init_state(np.zeros((3, 4, 4, 3), np.float32))
    for obj_id, pts in inp["toy_clicks"]:
        pred.add_new_points_or_box(state, 0, obj_id=obj_id, points=pts, labels=[1] * len(pts))
    res["objects"] = {t: m.clone() for t, _, m in pred.propagate_in_video(state)}
    res["objects_cache_kv"] = pred.cache_kv
    try:
        TrackerPredictor(core, None, obj_slots=3, mesh=objects)
    except ValueError as e:
        res["tracker_refusal"] = str(e)

    # -- frame-parallel detection, alone and as the pipeline's detector_batch
    det = detector()
    frames = torch.from_numpy(inp["frames"])

    def detect_batch(frames, tokens):
        b = frames.shape[0]
        return det(frames, tokens.expand(b, -1), Prompt.empty(b, 2, 2))

    frames_mesh = parallel.make_mesh({"frames": 2})
    fp = parallel.frame_parallel(detect_batch, frames_mesh)

    def per_frame(out):
        return [{"scores": torch.sigmoid(out["pred_logits"][i, :, 0]),
                 "boxes": out["pred_boxes_xyxy"][i], "masks": out["pred_masks"][i] > 0}
                for i in range(out["pred_logits"].shape[0])]

    with torch.no_grad():
        gathered = fp(frames, tokens[:1])
        singles = [detect_batch(frames[i:i + 1], tokens[:1]) for i in range(len(frames))]
        pipe = VideoPCSPredictor(
            None, pred, frame_chunk=len(frames),
            detector_batch=lambda f, ts: per_frame(fp(torch.as_tensor(f), ts)))
        session = {"frames": inp["frames"], "text_state": tokens[:1],
                   "state": {"num_frames": len(frames)}}
        chunked = [pipe._detect(session, t) for t in range(len(frames))]
    res["frames"] = dict(
        gathered={k: gathered[k] for k in OUT_KEYS},
        singles={k: torch.cat([s[k] for s in singles]) for k in OUT_KEYS},
        chunked=chunked, direct=[d for s in singles for d in per_frame(s)])
finally:
    torch.save(res, f"{work}/rank{rank}.pt")
    dist.destroy_process_group()
"""


def _inputs():
    """Seeded inputs and port weights for the ranks, and the JAX models and
    variables they came from."""
    rng = np.random.default_rng(0)
    cfg = jstage1.Stage1ImageConfig(**STAGE1)
    smodel = jstage1.make_student(cfg)
    sbatch = {"image": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
              "teacher": rng.standard_normal((4, 4, 4, 64)).astype(np.float32),
              "valid": np.ones((4, 4, 4), np.float32)}
    sshapes = jax.eval_shape(lambda k: smodel.init(k, jnp.asarray(sbatch["image"]), train=True),
                             jax.random.PRNGKey(0))
    svars = random_variables(sshapes, 1)

    jdet = JModel(trunk=jmake_trunk("efficientvit", "b0", embed_size=9),
                  text_encoder_type="MobileCLIP-S0", text_context_length=16,
                  fusion_layers=2, decoder_layers=2)
    images = (0.5 * rng.standard_normal((2, 72, 72, 3))).astype(np.float32)
    tokens = np.zeros((2, 16), np.int32)
    tokens[:, :4] = [49406, 320, 1125, 49407]
    tokens[1, 2] = 3309
    dshapes = jax.eval_shape(
        lambda k: jdet.init(k, jnp.asarray(images[:1]), jnp.asarray(tokens[:1]),
                            JPrompt.empty(1, 2, 2)), jax.random.PRNGKey(0))
    dvars = flax_variables(dshapes, seeded_state_dict(
        build_efficientsam3_image_model(device="meta", **DET), 2))

    jcore = JCore(**TOY_CORE)
    tshapes = jax.eval_shape(lambda k: init_tracker_variables(jcore, k), jax.random.PRNGKey(0))
    tvars = random_variables(tshapes, 3)
    fs = jcore.feat_size
    fpn = [(0.1 * rng.standard_normal((1, s * fs, s * fs, 32))).astype(np.float32)
           for s in (4, 2, 1)]
    outs, targets = loss_inputs()
    inp = dict(
        lr=LR, out_keys=OUT_KEYS, stage1_cfg=STAGE1, stage1_sd=state_dict_of(svars),
        stage1_batch=sbatch, loss_outs=outs, loss_targets=targets, det_cfg=DET,
        seeded=_SEEDED, det_images=images, det_tokens=tokens,
        frames=(0.5 * rng.standard_normal((4, 72, 72, 3))).astype(np.float32),
        toy_core=TOY_CORE, toy_sd=state_dict_of(tvars), toy_fpn=fpn,
        toy_clicks=[(1, [[20.0, 20.0]]), (2, [[44.0, 40.0], [30.0, 12.0]])])
    return inp, dict(smodel=smodel, svars=svars, jdet=jdet, dvars=dvars, jcore=jcore,
                     tvars=tvars)


def _jax_references(inp, j):
    """JAX's single-device Stage-1 step on the global batch (optax.adamw,
    its gradients tapped), JAX's unsharded detector forward, JAX's
    predictor without a mesh on the plain path."""
    tx = optax.adamw(LR)

    def tap_update(grads, state, params):  # hands the gradients out with the state
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    tap = optax.GradientTransformation(
        lambda p: (tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)), tap_update)
    step = jax.jit(functools.partial(jstage1.stage1_train_step, j["smodel"], tap))
    b = inp["stage1_batch"]
    new_vars, (_, grads), metrics = step(j["svars"], tap.init(j["svars"]["params"]),
                                         *(jnp.asarray(b[k]) for k in ("image", "teacher",
                                                                       "valid")))
    dp = dict(vars=convert_variables(new_vars), grads=convert_variables({"params": grads}),
              loss=float(metrics["loss"]))

    fwd = jax.jit(lambda v, i, t: j["jdet"].apply(v, i, t, JPrompt.empty(i.shape[0], 2, 2)))
    out = fwd(j["dvars"], jnp.asarray(inp["det_images"]), jnp.asarray(inp["det_tokens"]))
    det = {k: np.asarray(out[k]) for k in OUT_KEYS}

    fpn = [jnp.asarray(a) for a in inp["toy_fpn"]]
    pred = JPredictor(j["jcore"], j["tvars"], lambda img: {"sam2_fpn": fpn}, obj_slots=4,
                      max_point_prompts=4, cache_memory_kv=False)
    state = pred.init_state(list(np.zeros((3, 4, 4, 3), np.float32)))
    for obj_id, pts in inp["toy_clicks"]:
        pred.add_new_points_or_box(state, 0, obj_id=obj_id, points=np.array(pts),
                                   labels=[1] * len(pts))
    masks = {t: np.asarray(m) for t, _, m in pred.propagate_in_video(state)}
    return dict(dp=dp, det=det, masks=masks)


def _port_loss(inp):
    """The port's loss and gradient on the whole batch in one process."""
    outs = {k: torch.from_numpy(v).requires_grad_() for k, v in inp["loss_outs"].items()}
    targets = {k: torch.from_numpy(v) for k, v in inp["loss_targets"].items()}
    total, _ = detection_loss(outs, targets)
    total.backward()
    loss = dict(total=total.item(), grads={k: v.grad for k, v in outs.items()},
                num_boxes=float(targets["valid"].sum()))

    return loss


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    inp, jax_models = _inputs()
    torch.save(inp, work / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(work / "rdzv"),
                               str(work)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:  # the references while the ranks run
        jref = _jax_references(inp, jax_models)
        pref = _port_loss(inp)
        errs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(e[-3000:] for e in errs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return inp, jref, pref, ranks


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


# --------------------------------------------------------------------------
# the two-rank launch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_stage1_gradients_match_jax_global_batch(run, rank):
    """Each rank saw 2 of the 4 images; the gradients the optimizer got are
    the world's mean, per tensor within 1e-3 of JAX's global-batch gradient's
    norm + 1e-5 of the norm of all of them (fp32 in other summation orders;
    BatchNorm biases followed by a BatchNorm have an exact gradient of 0,
    where both sides hold rounding noise), and the same bits on both ranks;
    the mean of the ranks' losses is JAX's global loss within 1e-5."""
    _, jref, _, ranks = run
    got, want = ranks[rank]["dp"], jref["dp"]
    assert got["local_batch"] == 2
    total = np.sqrt(sum(np.square(w, dtype=np.float64).sum() for w in want["grads"].values()))
    assert want["grads"].keys() == got["grads"].keys()
    for k, w in want["grads"].items():
        g = got["grads"][k].numpy()
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w) + 1e-5 * total, k
        assert torch.equal(got["grads"][k], ranks[1 - rank]["dp"]["grads"][k]), k
    mean_loss = np.mean([r["dp"]["metrics"]["loss"] for r in ranks])
    assert abs(mean_loss - want["loss"]) <= 1e-5 * max(1.0, abs(want["loss"]))


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_stage1_update_and_statistics_match_jax(run, rank):
    """After the step: the BatchNorm running statistics (from the global
    batch's statistics, reduced over the ranks) within 1e-4 of max(1,
    |largest|) of JAX's; every parameter within 2 lr + 1e-4 of max(1,
    |largest|) (AdamW's first step moves an entry by about lr whatever its
    gradient's size, so an entry whose gradient is rounding noise may move
    the other way); both ranks hold the same bits."""
    _, jref, _, ranks = run
    state, want = ranks[rank]["dp"]["state"], jref["dp"]["vars"]
    assert state.keys() == want.keys()
    params = ranks[rank]["dp"]["grads"].keys()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k, w in want.items():
        bound = 1e-4 * max(1.0, np.abs(w).max()) + (2 * LR if k in params else 0.0)
        assert np.abs(state[k].numpy() - w).max() <= bound, k
        assert torch.equal(state[k], ranks[1 - rank]["dp"]["state"][k]), k


@pytest.mark.parametrize("rank", [0, 1])
def test_loss_over_ranks_matches_the_single_process_gradient(run, rank):
    """With num_boxes the world's total over the world size, each rank's
    loss is 2x the global loss's share of its half: its gradient is 2x the
    single-process gradient's rows (1e-5), so the ranks' mean gradient is
    the global batch's; the mean of the two losses is the global loss."""
    inp, _, pref, ranks = run
    got, want = ranks[rank]["loss"], pref
    assert got["num_boxes"] == want["num_boxes"] / 2
    assert abs(np.mean([r["loss"]["total"] for r in ranks]) - want["total"]) <= 1e-5 * max(
        1.0, abs(want["total"]))
    for k, g in got["grads"].items():
        axis = 1 if k.startswith("aux.") else 0
        w = want["grads"][k].numpy()
        half = np.take(w, np.arange(rank * (w.shape[axis] // 2),
                                    (rank + 1) * (w.shape[axis] // 2)), axis=axis)
        _close(g / 2, half, 1e-5)


@pytest.mark.parametrize("rank", [0, 1])
def test_tp_detector_forward_matches_jax(run, rank):
    """Each rank of tp = 2 holds 4 of each in-scope attention's 8 heads,
    from head 4 x rank (every one a TensorParallelAttention), and the 2 + 2 layers shard 2 x 17 + 2 x 24 = 82
    leaves; its forward (scores, boxes, masks, presence) is JAX's unsharded
    forward within 1e-4 of max(1, |largest|)."""
    _, jref, _, ranks = run
    tp = ranks[rank]["tp"]
    assert tp["count"] == 2 * 17 + 2 * 24
    assert tp["heads"] == [4] and tp["offsets"] == [4 * rank] and tp["swapped"]
    for k in OUT_KEYS:
        _close(tp["out"][k], jref["det"][k], 1e-4)


@pytest.mark.parametrize("rank", [0, 1])
def test_tp_detector_gradients_match_unsharded(run, rank):
    """Every parameter's gradient on a tp rank against the unsharded port
    model's in the same process (a column layer's slice of dim 0 and of its
    bias, a row layer's slice of dim 1; the rest whole, the boxRPB tables'
    and the reference points' included, whose gradient each rank takes
    through its heads only), both in fp64: within 1e-5 of the tensor's
    largest magnitude + 1e-8 of the largest over all. The attention logits,
    the norms' statistics and the trunk's linear attention stay fp32 in an
    fp64 model, so an fp64 product that the sharded layers sum in another
    order can round to the neighbouring fp32 value there (up to ~1.2e-6 of
    a tensor's largest magnitude seen); a rank missing the other's share is
    off by O(1); entries whose exact gradient is 0 (key biases) hold
    ~1e-7 of such noise. (All in fp32, entries downstream of a ReLU at
    rounding distance from 0 move by up to ~6e-4.)"""
    tp = run[3][rank]["tp"]
    got_names, want_names = tp["grad_names"]
    assert got_names == want_names and len(got_names) > 300
    top = max(w for _, w in tp["grad_err"].values())
    for k, (err, wmax) in tp["grad_err"].items():
        assert err is not False, (k, "shape")
        assert err <= 1e-5 * wmax + 1e-8 * top, (k, err, wmax)


@pytest.mark.parametrize("rank", [0, 1])
def test_object_parallel_tracking_matches_jax(run, rank):
    """4 slots over 2 ranks, two objects prompted on frame 0, 3 frames: the
    gathered masks on every rank equal JAX's unmeshed predictor's on the
    same plain path within 1e-4 of max(1, |largest|)."""
    _, jref, _, ranks = run
    got = ranks[rank]["objects"]
    assert not ranks[rank]["objects_cache_kv"]
    assert sorted(got) == sorted(jref["masks"]) == [0, 1, 2]
    for t, m in got.items():
        assert m.shape == (2, 1, 32, 32)
        _close(m, jref["masks"][t], 1e-4)


@pytest.mark.parametrize("rank", [0, 1])
def test_frame_parallel_matches_single_grounds(run, rank):
    """4 frames over 2 ranks: the gathered outputs on every rank equal 4
    single-frame grounds (1e-5), and so do the per-frame detections of
    VideoPCSPredictor's chunked path over a frame_parallel detector_batch."""
    _, _, _, ranks = run
    fr = ranks[rank]["frames"]
    for k in OUT_KEYS:
        assert fr["gathered"][k].shape[0] == 4
        _close(fr["gathered"][k], fr["singles"][k], 1e-5)
    assert len(fr["chunked"]) == len(fr["direct"]) == 4
    for got, want in zip(fr["chunked"], fr["direct"]):
        _close(got["scores"], want["scores"], 1e-5)
        _close(got["boxes"], want["boxes"], 1e-5)
        assert (got["masks"] != want["masks"]).float().mean() < 1e-3


@pytest.mark.parametrize("rank", [0, 1])
def test_preemption_stops_every_rank_on_one_step(run, rank):
    """Rank 1 alone sets its preemption flag during step 1 of 3: both ranks
    stop after that step (each ran it on its half of the batch) and both
    hold the flag, so that no rank enters a step whose collectives the
    other would not join."""
    got = run[3][rank]["preempt"]
    assert got == dict(step=1, calls=[2], preempted=True)


@pytest.mark.parametrize("which", ["trainer", "tracker"])
def test_mesh_refusals(run, which):
    """Trainer(mesh=...) without its batch axis and TrackerPredictor(mesh=...)
    with obj_slots that do not divide raise ValueError (JAX's message)."""
    ranks = run[3]
    want = {"trainer": "batch axis 'data' not in the mesh's axes",
            "tracker": "obj_slots=3 not divisible by mesh axis objects=2"}[which]
    for r in ranks:
        assert want in r[f"{which}_refusal"]


# --------------------------------------------------------------------------
# without a launch
# --------------------------------------------------------------------------

_ENV = ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "NUM_PROCESSES", "SLURM_NTASKS",
        "WORLD_SIZE", "PROCESS_ID", "SLURM_PROCID", "RANK", "LOCAL_RANK",
        "SAM3_COLLECTIVE_OP_TIMEOUT_SEC")


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"WORLD_SIZE": "1", "MASTER_ADDR": "10.0.0.1"}, None),
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "4321", "WORLD_SIZE": "4", "RANK": "2",
      "SAM3_COLLECTIVE_OP_TIMEOUT_SEC": "77"},
     dict(init_method="tcp://10.0.0.1:4321", world_size=4, rank=2, timeout_s=77)),
    ({"COORDINATOR_ADDRESS": "h:9", "SLURM_NTASKS": "2", "SLURM_PROCID": "1"},
     dict(init_method="tcp://h:9", world_size=2, rank=1, timeout_s=300)),
], ids=["single", "world_of_one", "torchrun", "slurm"])
def test_initialize_distributed_env_wiring(monkeypatch, env, want):
    """The JAX package's env contract: no group for a world of one, else
    dist.init_process_group over gloo on the CPU with the coordinator, the
    world size, the rank and the collective timeout from the env."""
    import torch.distributed as dist

    from efficientsam3_tpu_torch.parallel import initialize_distributed

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    for v in _ENV:
        monkeypatch.delenv(v, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert initialize_distributed() is (want is not None)
    if want is None:
        assert calls == []
        return
    assert calls == [(("gloo",), dict(init_method=want["init_method"],
                                      world_size=want["world_size"], rank=want["rank"],
                                      timeout=datetime.timedelta(seconds=want["timeout_s"])))]


def _fake_params():  # tests/test_tensor_parallel.py's tree
    return {
        "fusion_encoder": {"layers_0": {
            "self_attn": {
                "q_proj": {"kernel": jnp.zeros((256, 256)), "bias": jnp.zeros(256)},
                "out_proj": {"kernel": jnp.zeros((256, 256)), "bias": jnp.zeros(256)}},
            "linear1": {"kernel": jnp.zeros((256, 2048)), "bias": jnp.zeros(2048)},
            "linear2": {"kernel": jnp.zeros((2048, 256)), "bias": jnp.zeros(256)},
            "norm1": {"scale": jnp.zeros(256), "bias": jnp.zeros(256)}}},
        "decoder": {"query_embed": {"embedding": jnp.zeros((200, 256))}},
        "trunk": {"conv": {"kernel": jnp.zeros((3, 3, 3, 64))}},
    }


class _Leaf:
    """A flax leaf's shape and its JAX spec, walked by utils/convert.py."""

    def __init__(self, shape, spec):
        self.shape, self.spec = shape, spec


def _full_detector():
    jdet = JModel(trunk=jmake_trunk("efficientvit", "b0", embed_size=9),
                  text_encoder_type="MobileCLIP-S0", text_context_length=16)
    shapes = jax.eval_shape(
        lambda k: jdet.init(k, jnp.zeros((1, 72, 72, 3)), jnp.zeros((1, 16), jnp.int32),
                            JPrompt.empty(1, 2, 2)), jax.random.PRNGKey(0))
    port = build_efficientsam3_image_model(model_name="b0", embed_size=9,
                                           text_encoder_context_length=16, device="meta")
    return shapes["params"], port


@pytest.mark.parametrize("tree", ["fake", "detector_6_6"])
def test_tp_param_spec_matches_jax_transposed(tree):
    """The port's spec, leaf by leaf, shards the dims JAX's shards after the
    kernel -> weight permutation of utils/convert.py: 6 leaves on JAX's
    fake tree, 246 on the full-depth detector (6 fusion layers x 17 + 6
    decoder layers x 24)."""
    if tree == "fake":
        jparams = _fake_params()
        port = {k: torch.empty(v.shape, device="meta")
                for k, v, _ in _walk({"params": jparams})}
        for k, v, axes in _walk({"params": jparams}):
            if axes is not None:
                port[k] = torch.empty(tuple(v.shape[a] for a in axes), device="meta")
        want_count = 6
    else:
        jparams, port = _full_detector()
        want_count = 246
    jspec = jtp_param_spec(jparams)
    pspec = parallel.tp_param_spec(port)
    assert jcount_sharded(jspec) == parallel.count_sharded(pspec) == want_count
    paired = jax.tree.map(lambda s, v: _Leaf(v.shape, s), jspec, jparams,
                          is_leaf=lambda x: isinstance(x, P))
    assert {k for k, _, _ in _walk({"params": paired})} == pspec.keys()
    for (k, leaf, axes) in _walk({"params": paired}):
        full = tuple(leaf.spec) + (None,) * (len(leaf.shape) - len(leaf.spec))
        if axes is not None:
            full = tuple(full[a] for a in axes)
        got = tuple(pspec[k]) + (None,) * (len(leaf.shape) - len(pspec[k]))
        assert got == full, k
