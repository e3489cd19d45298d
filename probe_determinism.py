#!/usr/bin/env python3
"""Find where the port's training paths stop repeating on one NVIDIA GPU.

Each training path of chip_smoke.py at its full width (the bf16 Stage-3
step, 2 steps at batch 4; the tracker's 8-frame training clip; a geometry
finetune step; an interactive loss and its backward; an EV-M and a ViT-H
Stage-1 step; 2 LiteText steps of MobileCLIP-S1; 5 association steps) runs
twice from one start and one seed, and every metric, gradient, parameter,
buffer and optimizer entry of the two runs is compared bit for bit. Where
they differ, the line names the first module output whose gradient differs
(forward hooks fingerprint the gradient reaching every module's outputs, in
the order the backward computes them), and the two runs are taken again
with torch.backends.cudnn.deterministic on. With --raise each path runs
once under torch.use_deterministic_algorithms(True) instead (set
CUBLAS_WORKSPACE_CONFIG=:4096:8 first), and the line gives the first op
that raises, or that the run reached its end.

    python3 probe_determinism.py [--other DIR] [--raise] [CASE ...]

CASE is any of stage3, tracker, geometry, interactive, stage1_evm,
stage1_vit, text, assoc (default: all). With --other the checkout at DIR
(e.g. a git archive of the parent under runs/) runs first, then this one,
each in its own process. Prints one line a path and a summary, with the
card's name and power limit.
"""
import argparse
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
LABEL = ["this"]
OUT = {}


def log(*a):
    print(f"[{LABEL[0]}]", *a, flush=True)


def bits_of(model, opt, metrics):
    """{name: tensor} cloned: the metrics, every gradient, the model's
    state and the optimizer's (as chip_smoke.training_bits, kept here so
    that an older checkout's chip_smoke serves too)."""
    out = {}

    def add(prefix, obj):
        if isinstance(obj, torch.Tensor):
            out[prefix] = obj.detach().clone()
        elif isinstance(obj, dict):
            for k, v in obj.items():
                add(f"{prefix}.{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                add(f"{prefix}.{i}", v)
        elif isinstance(obj, (bool, int, float)):
            out[prefix] = torch.tensor(obj)

    add("metric", {k: torch.as_tensor(v) for k, v in metrics.items()})
    for k, p in model.named_parameters():
        if p.grad is not None:
            out[f"grad {k}"] = p.grad.detach().clone()
    add("state", model.state_dict())
    if opt is not None:
        add("optimizer", opt.state_dict())
    return out


def bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8) if a.dtype != torch.bool else a,
        b.reshape(-1).view(torch.uint8) if b.dtype != torch.bool else b)


class Trace:
    """A fingerprint of the gradient reaching every module's outputs, in
    the order the backward computes them."""

    def __init__(self, model):
        self.rec = []
        self.handles = [m.register_forward_hook(self.hook(name))
                        for name, m in model.named_modules() if name]

    def hook(self, name):
        def fn(mod, inp, out):
            outs = out if isinstance(out, (tuple, list)) else (
                list(out.values()) if isinstance(out, dict) else [out])
            for t in outs:
                if isinstance(t, torch.Tensor) and t.requires_grad:
                    t.register_hook(lambda g: self.rec.append(
                        (name, torch.stack([g.double().sum(), g.double().abs().sum()]))))
        return fn

    def remove(self):
        for h in self.handles:
            h.remove()


def compare(name, a, b):
    keys = sorted(set(a) | set(b))
    differ = [k for k in keys if k not in a or k not in b or not bits_equal(a[k], b[k])]
    grads = [k for k in differ if k.startswith("grad ")]
    worst = {}
    for k in differ[:400]:
        if k in a and k in b and a[k].is_floating_point():
            d = (a[k].double() - b[k].double()).abs().max().item()
            s = a[k].double().abs().max().item()
            worst[k] = (d, s)
    top = sorted(worst.items(), key=lambda kv: -kv[1][0] / max(kv[1][1], 1e-30))[:6]
    log(f"{name}: {len(differ)} of {len(keys)} tensors differ ({len(grads)} grads); "
        f"metrics differ {[k for k in differ if k.startswith('metric')]}; worst "
        f"{[(k, f'{d:.3e} of {s:.3e}') for k, (d, s) in top]}")
    return differ


def first_split(ta, tb):
    for i, ((na, fa), (nb, fb)) in enumerate(zip(ta.rec, tb.rec)):
        if na != nb:
            return f"order differs at {i}: {na} / {nb}"
        if not torch.equal(fa, fb):
            prev = ta.rec[i - 1][0] if i else None
            return (f"gradient {i} of {len(ta.rec)}: at the output of {na} (after {prev}): "
                    f"{fa.tolist()} vs {fb.tolist()}")
    return "none"


def run_case(name, setup):
    """Two runs of setup()'s run from one start and seed, compared; again
    with cudnn.deterministic where they differ. setup() -> (model, run),
    run() -> (model, optimizer or None, metrics)."""
    t0 = time.perf_counter()
    model, run = setup()
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    res = {}
    traces = []
    for i in range(2):
        model.load_state_dict(start)
        tr = Trace(model)
        torch.manual_seed(0)
        m, opt, metrics = run()
        torch.cuda.synchronize()
        tr.remove()
        traces.append(tr)
        res[i] = bits_of(m, opt, metrics)
    differ = compare(name, res[0], res[1])
    rec = {"differ": len(differ), "tensors": len(res[0]),
           "first_split": first_split(*traces) if differ else None}
    if differ:
        log(f"{name}: first split {rec['first_split']}")
    del res, traces
    if differ:
        torch.backends.cudnn.deterministic = True
        try:
            res = {}
            for i in range(2):
                model.load_state_dict(start)
                torch.manual_seed(0)
                m, opt, metrics = run()
                torch.cuda.synchronize()
                res[i] = bits_of(m, opt, metrics)
            rec["differ_cudnn_det"] = len(compare(name + " (cudnn.deterministic)", res[0], res[1]))
            del res
        finally:
            torch.backends.cudnn.deterministic = False
    rec["s"] = time.perf_counter() - t0
    OUT[name] = rec
    del model
    torch.cuda.empty_cache()


def raise_case(name, setup):
    """One run under use_deterministic_algorithms(True): the first op
    without a deterministic CUDA implementation raises."""
    model, run = setup()
    torch.use_deterministic_algorithms(True)
    try:
        torch.manual_seed(0)
        run()
        torch.cuda.synchronize()
        msg = "ran to its end"
    except RuntimeError as e:
        msg = str(e).split("\n")[0][:300]
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"{name}: under use_deterministic_algorithms(True): {msg}")
    OUT[name] = {"raise": msg}
    del model
    torch.cuda.empty_cache()


def image_model(dtype=torch.bfloat16):
    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    return build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32, dtype=dtype, device=dev, seed=0)


def stage3():
    from efficientsam3_tpu_torch.train import stage3 as s3
    model = image_model()
    batch = cs.stage3_batch(cs.TRAIN_BATCH, 32, dev)

    def run():
        opt = s3.make_stage3_optimizer(s3.Stage3Config(), model)
        met = None
        for _ in range(2):
            met = s3.stage3_train_step(model, opt, batch)
        return model, opt, met
    return model, run


def geometry():
    from efficientsam3_tpu_torch.train import geometry_finetune as gf
    model = image_model()
    cfg = gf.GeometryFinetuneConfig()
    batch = cs.geometry_batch(cs.GEOM_BATCH, dev)

    def run():
        opt = gf.make_geometry_optimizer(cfg, model)
        met = gf.geometry_finetune_step(model, opt, cfg, batch)
        return model, opt, met
    return model, run


def interactive():
    from efficientsam3_tpu_torch.train import interactive as it
    model = image_model()
    model.train().requires_grad_(True)
    batch = cs.geometry_batch(cs.GEOM_BATCH, dev, seed=41)

    def run():
        model.train()
        model.zero_grad(set_to_none=True)
        total, parts = it.interactive_grounding_loss(
            model, batch["images"], batch["tokens"], batch["prompt"], batch["targets"],
            num_interactive_steps=1)
        total.backward()
        return model, None, {"loss": total.detach()}
    return model, run


def tracker():
    from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
    from efficientsam3_tpu_torch.models.common import sine_pos_embed_2d
    image, core = build_efficientsam3_video_model(model_name="b1", dtype=torch.bfloat16,
                                                  device=dev, seed=0)
    with torch.no_grad():
        for blk in core.memory_encoder.fuser:
            blk.gamma.fill_(1.0)
        core.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    core.train().requires_grad_(True)
    fs, d = core.feat_size, core.d_model
    frames = np.random.default_rng(7).standard_normal((cs.TT_FRAMES, 1008, 1008, 3)).astype(np.float32)
    feats = []
    with torch.no_grad():
        for t in range(cs.TT_FRAMES):
            fpn = image.encode_image(torch.as_tensor(frames[t], device=dev)[None])["sam2_fpn"]
            feats.append((fpn[2].reshape(1, fs * fs, d), fpn[0], fpn[1]))
    del image
    pos = sine_pos_embed_2d(fs, fs, d, device=dev).reshape(fs * fs, d)
    gen = torch.Generator(device=dev).manual_seed(5)
    proj = torch.randn((cs.TT_FRAMES, cs.TT_SLOTS, 1, 4 * fs, 4 * fs), generator=gen, device=dev)

    def run():
        core.zero_grad(set_to_none=True)
        loss, _ = cs.tracker_clip(core, feats, pos, proj, cs.TT_LIVE)
        loss.backward()
        return core, None, {"loss": loss.detach()}
    return core, run


def stage1_evm():
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.train import stage1
    cfg = stage1.Stage1ImageConfig()
    model = init_parameters(stage1.make_student(cfg, torch.bfloat16), 0).float().to(dev)
    r = np.random.default_rng(3)
    batch = {"image": r.uniform(-1, 1, (4, 1008, 1008, 3)).astype(np.float32),
             "teacher": r.standard_normal((4, 72, 72, 1024)).astype(np.float32),
             "valid": np.ones((4, 72, 72), np.float32)}

    def run():
        opt = stage1.make_optimizer(cfg, 2, model)
        met = stage1.stage1_train_step(model, opt, batch)
        return model, opt, met
    return model, run


def stage1_vit():
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.models.vitdet import ViTTrunk
    from efficientsam3_tpu_torch.train import stage1
    cfg = stage1.Stage1ImageConfig()
    model = init_parameters(ViTTrunk(drop_path_rate=0.0, dtype=torch.bfloat16), 1).float().to(dev)
    r = np.random.default_rng(3)
    batch = {"image": r.uniform(-1, 1, (2, 1008, 1008, 3)).astype(np.float32),
             "teacher": r.standard_normal((2, 72, 72, 1024)).astype(np.float32),
             "valid": np.ones((2, 72, 72), np.float32)}

    def run():
        opt = stage1.make_optimizer(cfg, 2, model)
        met = stage1.stage1_train_step(model, opt, batch)
        return model, opt, met
    return model, run


def text():
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.train import stage1_text as st
    cfg = st.Stage1TextConfig(backbone_type="MobileCLIP-S1", context_length=32)
    model = init_parameters(st.make_text_student(cfg, dtype=torch.bfloat16), seed=3).to(dev)
    tok, perm = cs.text_tokens(cs.TEXT_BATCH, 32)
    with torch.no_grad():
        out = model(torch.from_numpy(tok).to(dev))[0]
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.from_numpy(tok).to(dev), "tokens_perm": torch.from_numpy(perm).to(dev),
             "teacher": torch.randn(out.shape, generator=g, device=dev),
             "teacher_perm": torch.randn(out.shape, generator=g, device=dev)}

    def run():
        opt = st.make_text_optimizer(cfg, model)
        met = None
        for _ in range(2):
            met = st.stage1_text_train_step(model, opt, cfg, batch)
        return model, opt, met
    return model, run


def assoc():
    from efficientsam3_tpu_torch.build import init_parameters
    from efficientsam3_tpu_torch.train.video_assoc import AssocHead, FramePairDataset, assoc_train_step
    head = init_parameters(AssocHead(256), seed=0).to(dev)
    data = FramePairDataset(q_det=200, q_trk=8, d_model=256, seed=0)
    batches = [data.batch(cs.ASSOC_BATCH) for _ in range(5)]

    def run():
        opt = torch.optim.Adam(head.parameters(), lr=3e-3)
        step = assoc_train_step(head, opt)
        loss = None
        for b in batches:
            loss = step(b)
        return head, opt, {"loss": loss}
    return head, run


CASES = {"stage3": stage3, "tracker": tracker, "geometry": geometry, "interactive": interactive,
         "stage1_evm": stage1_evm, "stage1_vit": stage1_vit, "text": text, "assoc": assoc}

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", metavar="CASE", help=", ".join(CASES))
    ap.add_argument("--other", help="another checkout, probed first in its own process")
    ap.add_argument("--raise", dest="raise_", action="store_true",
                    help="one run a path under torch.use_deterministic_algorithms(True)")
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if set(args.cases) - set(CASES):
        ap.error(f"unknown cases {sorted(set(args.cases) - set(CASES))}")
    if args.other is not None and args.label is None:
        here = os.path.dirname(os.path.abspath(__file__))
        other = os.path.abspath(args.other)
        flags = ["--raise"] if args.raise_ else []
        for where, label in ((other, "other"), (here, "this")):
            subprocess.run([sys.executable, os.path.join(here, "probe_determinism.py"), "--label",
                            f"{label} ({os.path.relpath(where, here)})", *flags, *args.cases],
                           cwd=where, check=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("probe_determinism: needs an NVIDIA GPU")
    from efficientsam3_tpu_torch.ops import _build

    LABEL[0] = args.label or "this"
    _build.build_all()
    log(cs.nvidia_smi_line())
    for name, setup in CASES.items():
        if args.cases and name not in args.cases:
            continue
        try:
            (raise_case if args.raise_ else run_case)(name, setup)
        except Exception:
            traceback.print_exc()
            OUT[name] = {"error": traceback.format_exc().splitlines()[-1]}
        torch.cuda.empty_cache()
    log("summary (tensors that differ; again with cudnn.deterministic; s):",
        {k: (v.get("differ"), v.get("differ_cudnn_det"), round(v.get("s", 0), 1))
         if "raise" not in v else v["raise"] for k, v in OUT.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
