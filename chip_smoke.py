#!/usr/bin/env python3
"""Drive the PyTorch port of EfficientSAM3 on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, TF32 settings, and the build of the CUDA kernels
     (csrc/*.cu, one nvcc per source, all started together);
  2. the main path at full width: EfficientViT-b1 ("EV-M") at 1008^2 with
     the MobileCLIP-S0 text tower at context 32, bf16, seeded random
     weights, through the port's Sam3Processor (set_image on a non-square
     uint8 image, text token ids encoded into state["text"], one box
     prompt). Every kernel launch counter is set to 0 just before and read
     just after: layer_norm 27, flash_sdpa 6 and flash_xattn_rpb 6 launches
     per ground call. encode_image, ground and the whole call are timed
     with CUDA events, and torch.profiler splits one encode_image and one
     ground into device time by kernel (tables under chiprun_out/);
  3. each kernel against its plain PyTorch version, on the inputs of its
     largest launch on the main path (captured in a warm-up run), with the
     tolerance stated; timed inside a CUDA graph (20 calls per graph, median
     of 20 replays, so the host's launch cost drops out) beside the plain
     version, one
     PyTorch library call computing the same function, and the least time
     the card could take (bytes or operations); the per-call time from the
     host (median of 50 between CUDA events) and the profiler's device
     time per launch on the main path are printed beside them;
  4. output checks: finite outputs of the expected shapes, masks at the
     original resolution, and a small-input run of the tiny test config on
     the card held against the same model in fp32 on the CPU.

The line before the last is the kernels JSON, the last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Imports nothing of JAX and nothing of the JAX package.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper), at 700 W.
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12  # fp32 FLOP/s outside the tensor cores
PEAK_SFU = 132 * 16 * 1.98e9  # exponentials/s: 16 per SM per clock at 1.98 GHz

ATOL = RTOL = 1e-2  # kernel vs plain, bf16 outputs: about one bf16 ulp (2^-7 relative)
MAIN_COUNTS = {"layer_norm": 27, "flash_sdpa": 6, "flash_xattn_rpb": 6}


def log(*a):
    print(*a, flush=True)


def cuda_time(fn, iters, warmup=3):
    """Median milliseconds of fn() over iters runs, each between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_time(fn, per_graph=20, replays=20):
    """Device milliseconds per fn() call: per_graph calls captured in one
    CUDA graph, each replay timed between CUDA events, the median of the
    replays divided by per_graph; the host's launch cost of each call
    (Python, ctypes, Triton's launcher) drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    del graph
    return statistics.median(times)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def write_out(name, text):
    """Write a long report under chiprun_out/ beside this script."""
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, name), "w") as f:
        f.write(text + "\n")


def profile_kernels(fn):
    """Device kernels of one fn() call under torch.profiler, after a warm-up:
    ([(name, device us, launches)] by time, total launches, total device us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((e.key, e.self_device_time_total, e.count))
    kernels.sort(key=lambda r: -r[1])
    return kernels, sum(n for _, _, n in kernels), sum(us for _, us, _ in kernels)


class Capture:
    """Record, per kernel wrapper, the arguments of its largest call (by the
    first tensor's size) as the model modules make it, without changing
    what runs."""

    def __init__(self, modules):
        self.modules = modules  # [(module, attribute name), ...]
        self.args = {}
        self.saved = []

    def __enter__(self):
        for mod, name in self.modules:
            orig = getattr(mod, name)

            def wrapped(*a, orig_=orig, name_=name, **kw):
                prev = self.args.get(name_)
                if prev is None or a[0].numel() > prev[0][0].numel():
                    self.args[name_] = (a, kw)
                return orig_(*a, **kw)

            self.saved.append((mod, name, orig))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from efficientsam3_tpu_torch.build import build_efficientsam3_image_model
    from efficientsam3_tpu_torch.models import common
    from efficientsam3_tpu_torch.models.geometry import Prompt
    from efficientsam3_tpu_torch.ops import _build
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln
    from efficientsam3_tpu_torch.processor import Sam3Processor

    # ---------------------------------------------------------------- 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(smi)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t_build = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] nvcc {sorted(reports)} in {time.perf_counter() - t_build:.2f} s (parallel)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 2
    model = build_efficientsam3_image_model(
        backbone_type="efficientvit", model_name="b1", text_encoder_type="MobileCLIP-S0",
        text_encoder_context_length=32, dtype=torch.bfloat16, device=dev, seed=0,
    )
    proc = Sam3Processor(model, resolution=1008, context_length=32)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (600, 800, 3), dtype=np.uint8)
    tokens = np.zeros((1, 32), np.int64)
    tokens[0, :5] = [49406, 320, 1125, 3309, 49407]
    box = [0.45, 0.5, 0.3, 0.4]

    def main_path():
        state = proc.set_image(image)
        state["text"] = proc.encode_tokens(tokens)
        return proc.add_geometric_prompt(box, True, state)

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    capture = Capture([(common, "flash_sdpa"), (common, "flash_xattn_rpb"),
                       (common, "layer_norm")])
    with capture:  # warm-up run: Triton compile, cuDNN plans, captured inputs
        main_path()
    t1.record()
    t1.synchronize()
    log(f"[main] first run (Triton compile and warm-up) {t0.elapsed_time(t1):.1f} ms")

    wrappers = {"layer_norm": ln.layer_norm, "flash_sdpa": fa.flash_sdpa,
                "flash_xattn_rpb": fa.flash_xattn_rpb}
    for w in wrappers.values():
        w.launches = 0
    state = main_path()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"[main] launches per ground call: {launches}")
    for k, want in MAIN_COUNTS.items():
        if launches[k] != want:
            raise AssertionError(f"{k}: {launches[k]} launches on the main path, want {want}")
    h0, w0 = image.shape[:2]
    if state["masks"].shape[1:] != (h0, w0):
        raise AssertionError(f"masks {state['masks'].shape} not at the original {h0}x{w0}")
    for k in ("scores", "boxes", "masks_logits"):
        if not np.isfinite(state[k]).all():
            raise AssertionError(f"non-finite {k}")
    log(f"[main] kept {len(state['scores'])} of 200 queries at threshold 0.5; "
        f"masks {state['masks'].shape}")

    img = proc.preprocess(image)
    with torch.inference_mode():
        feats = model.encode_image(img)
        tm, tmask = state["text"]
        prompt = state["geometric_prompt"]
        enc_ms = cuda_time(lambda: model.encode_image(img), 20)
        ground_ms = cuda_time(
            lambda: model.ground(feats["fpn"], feats["pos"], tm, tmask, prompt), 20)
    whole_ms = cuda_time(main_path, 10, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    main_path()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[main] encode_image {enc_ms:.3f} ms | ground {ground_ms:.3f} ms | whole call "
        f"(set_image + encode text + add_geometric_prompt, host postprocess included) "
        f"{whole_ms:.3f} ms | peak memory {peak:.2f} GiB | {smi}")

    # device time by kernel (torch.profiler), one encode_image and one ground
    device_ms = {}
    for stage, fn, wall_ms in (
        ("encode_image", lambda: model.encode_image(img), enc_ms),
        ("ground", lambda: model.ground(feats["fpn"], feats["pos"], tm, tmask, prompt), ground_ms),
    ):
        kernels, launches_n, total_us = profile_kernels(fn)
        if total_us == 0:
            log(f"[profile] {stage}: the profiler recorded no device time: not measured")
            continue
        busy = total_us / 1e3 / wall_ms
        log(f"[profile] {stage}: {launches_n} kernel launches, {total_us / 1e3:.3f} ms of "
            f"device time in a {wall_ms:.3f} ms call: device busy {busy:.1%}, idle {1 - busy:.1%}")
        for name, us, n in kernels[:8]:
            log(f"[profile] {stage}:   {us / 1e3:8.4f} ms  x{n:<4d} {name[:90]}")
        for name, us, n in kernels:
            for key, pattern in (("flash_sdpa", "flash_sdpa_fwd_kernel"),
                                 ("flash_xattn_rpb", "flash_xattn_rpb_"),
                                 ("layer_norm", "_ln_fwd")):
                if pattern in name:  # flash_xattn_rpb runs two kernels per call
                    device_ms[key] = device_ms.get(key, 0.0) + us / 1e3 / MAIN_COUNTS[key]
        write_out(f"profile_{stage}.txt",
                  "\n".join(f"{us:12.2f} us  x{n:<5d} {name}" for name, us, n in kernels))
    log(f"[profile] device ms per wrapper call on the main path, our kernels: "
        f"{ {k: round(v, 5) for k, v in device_ms.items()} }")

    # ---------------------------------------------------------------- 3
    rows = []

    def bound(nbytes, mma_flops=0.0, exps=0.0, fp32_ops=0.0):
        parts = {"bytes": nbytes / PEAK_BYTES,
                 "operations": max(mma_flops / PEAK_BF16, exps / PEAK_SFU, fp32_ops / PEAK_FP32)}
        by = max(parts, key=parts.get)
        return parts[by] * 1e3, by

    def check(name, got, want):
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.allclose(got.float(), want.float(), atol=ATOL, rtol=RTOL))
        log(f"[kernel] {name}: max|kernel - plain| = {err:.3e} "
            f"(atol {ATOL}, rtol {RTOL}) -> {'pass' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return err

    # flash_sdpa at the fusion-encoder self-attention
    (q, k, v, key_bias, scale), _ = capture.args["flash_sdpa"]
    b, h, lq, d = q.shape
    lk = k.shape[2]
    got = fa.flash_sdpa(q, k, v, key_bias, scale)
    err = check("flash_sdpa", got, fa.flash_sdpa_plain(q, k, v, key_bias, scale))
    got_o, got_lse = fa.flash_sdpa(q, k, v, key_bias, scale, return_lse=True)
    _, want_lse = fa.flash_sdpa_plain(q, k, v, key_bias, scale, return_lse=True)
    lse_err = (got_lse - want_lse).abs().max().item()
    log(f"[kernel] flash_sdpa lse: max err {lse_err:.3e} (atol 1e-2)")
    if lse_err > 1e-2:
        raise AssertionError("flash_sdpa lse disagrees with its plain version")
    live_keys = int((key_bias > fa.NEG_INF / 2).sum().item()) // b  # skipped tiles do no work
    nb = 2 * (q.numel() + k.numel() + v.numel() + got.numel()) + 4 * key_bias.numel()
    bms, by = bound(nb, 4.0 * b * h * lq * live_keys * d, 1.0 * b * h * lq * live_keys,
                    6.0 * b * h * lq * live_keys)
    rows.append(dict(
        name="flash_sdpa", route="cuda", source="efficientsam3_tpu_torch/csrc/flash_sdpa.cu",
        replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:304",
        launches=launches["flash_sdpa"], max_abs_err=err,
        ms=graph_time(lambda: fa.flash_sdpa(q, k, v, key_bias, scale)),
        call_ms=cuda_time(lambda: fa.flash_sdpa(q, k, v, key_bias, scale), 50),
        plain_ms=graph_time(lambda: fa.flash_sdpa_plain(q, k, v, key_bias, scale)),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
        shape=f"q/k/v {tuple(q.shape)} bf16", **{"pass": True},
    ))

    # flash_xattn_rpb at the decoder's image cross-attention
    (q, k, v, ey, ex, feat_hw, scale), _ = capture.args["flash_xattn_rpb"]
    b, h, lq, d = q.shape
    lk = k.shape[2]
    got = fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale)
    err = check("flash_xattn_rpb", got, fa.flash_xattn_rpb_plain(q, k, v, ey, ex, feat_hw, scale))
    full_bias = fa.rpb_bias(ey, ex, feat_hw).to(q.dtype)
    nb = 2 * (q.numel() + k.numel() + v.numel() + got.numel()) + 4 * (ey.numel() + ex.numel())
    bms, by = bound(nb, 4.0 * b * h * lq * lk * d, 1.0 * b * h * lq * lk, 8.0 * b * h * lq * lk)
    nsplit, per = fa.xattn_splits(b * h, lq, lk,
                                  torch.cuda.get_device_properties(0).multi_processor_count)
    rows.append(dict(
        name="flash_xattn_rpb", route="cuda",
        source="efficientsam3_tpu_torch/csrc/flash_xattn_rpb.cu",
        replaces="efficientsam3_tpu/ops/pallas/flash_attention.py:898",
        launches=launches["flash_xattn_rpb"], max_abs_err=err,
        ms=graph_time(lambda: fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale)),
        call_ms=cuda_time(lambda: fa.flash_xattn_rpb(q, k, v, ey, ex, feat_hw, scale), 50),
        plain_ms=graph_time(lambda: fa.flash_xattn_rpb_plain(q, k, v, ey, ex, feat_hw, scale)),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=full_bias, scale=scale)),
        shape=f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16, ey/ex f32, "
              f"{nsplit} kv splits of {per} tiles", **{"pass": True},
    ))

    # layer_norm at the fusion encoder's (5184, 256) norms
    (x, wt, bs, eps, out_dtype), _ = capture.args["layer_norm"]
    got = ln.layer_norm(x, wt, bs, eps, out_dtype)
    wt_x, bs_x = wt.to(x.dtype), bs.to(x.dtype)
    err = check("layer_norm", got, ln.layer_norm_plain(x, wt, bs, eps, out_dtype))
    rows_, c = x.numel() // x.shape[-1], x.shape[-1]
    nb = x.numel() * x.element_size() + got.numel() * got.element_size() + 8 * c
    bms, by = bound(nb, fp32_ops=8.0 * rows_ * c)
    rows.append(dict(
        name="layer_norm", route="triton", source="efficientsam3_tpu_torch/ops/layer_norm.py",
        replaces="efficientsam3_tpu/ops/pallas/layer_norm.py:71",
        launches=launches["layer_norm"], max_abs_err=err,
        ms=graph_time(lambda: ln.layer_norm(x, wt, bs, eps, out_dtype)),
        call_ms=cuda_time(lambda: ln.layer_norm(x, wt, bs, eps, out_dtype), 50),
        plain_ms=graph_time(lambda: ln.layer_norm_plain(x, wt, bs, eps, out_dtype)),
        bound_ms=bms, bound_by=by,
        library_ms=graph_time(lambda: F.layer_norm(x, (c,), wt_x, bs_x, eps)),
        shape=f"x {tuple(x.shape)} {x.dtype} -> {out_dtype}", **{"pass": True},
    ))
    for r in rows:
        # per-launch device time on the main path (profiler), beside the
        # CUDA-event time per wrapper call, which includes the host's launch
        r["device_ms"] = device_ms.get(r["name"])
        log(f"[kernel] {r['name']}: {r['ms']:.4f} ms in a CUDA graph | {r['call_ms']:.4f} ms "
            f"per call from the host | profiler {r['device_ms']} ms | plain {r['plain_ms']:.4f} ms | "
            f"library {r['library_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
            f"| {r['launches']} launches | {r['shape']} | {smi}")

    # ---------------------------------------------------------------- 4
    with torch.inference_mode():
        out = model.ground(feats["fpn"], feats["pos"], tm, tmask, prompt)
    torch.cuda.synchronize()
    want = {"pred_logits": (1, 200, 1), "pred_boxes": (1, 200, 4),
            "pred_masks": (1, 200, 288, 288), "presence_logit_dec": (1,)}
    for key, shape in want.items():
        t = out[key]
        if tuple(t.shape) != shape or not torch.isfinite(t.float()).all():
            raise AssertionError(f"{key}: shape {tuple(t.shape)} (want {shape}) or non-finite")
    boxes = out["pred_boxes"].float()
    if not ((boxes >= 0) & (boxes <= 1)).all():
        raise AssertionError("pred_boxes outside [0, 1]")
    state = proc.set_confidence_threshold(0.0, state)
    if state["masks"].shape != (200, h0, w0) or not np.isfinite(state["masks_logits"]).all():
        raise AssertionError(f"all-query masks {state['masks'].shape}, want (200, {h0}, {w0})")
    log(f"[check] full-width outputs finite with expected shapes; 200 masks at {h0}x{w0}")

    # small input: tiny test config, bf16 on the card vs fp32 on the CPU
    tiny = dict(backbone_type="efficientvit", model_name="b0", embed_size=8,
                text_encoder_context_length=16, fusion_layers=2, decoder_layers=2, seed=1)
    ref_model = build_efficientsam3_image_model(device="cpu", **tiny)
    gpu_model = build_efficientsam3_image_model(device=dev, dtype=torch.bfloat16, **tiny)
    gpu_model.load_state_dict(ref_model.state_dict())
    timg = torch.from_numpy(rng.standard_normal((1, 64, 64, 3)).astype(np.float32))
    ttok = torch.zeros((1, 16), dtype=torch.long)
    ttok[0, :4] = torch.tensor([49406, 320, 1125, 49407])
    tprompt = Prompt.empty(1, 2, 2).with_box(0, 0, [0.5, 0.45, 0.4, 0.3])
    with torch.inference_mode():
        ref = ref_model(timg, ttok, tprompt)
        got = gpu_model(timg.to(dev), ttok.to(dev), tprompt.to(dev))
    # bf16 end to end against fp32: the boxes are sigmoid outputs in [0, 1]
    # and the logits clamp at 12; 5e-2 / 2.5e-1 are about 2^-4 of each range
    errs = {}
    for key, tol in (("pred_boxes", 5e-2), ("pred_logits", 2.5e-1),
                     ("presence_logit_dec", 2.5e-1)):
        errs[key] = (got[key].float().cpu() - ref[key]).abs().max().item()
        if not errs[key] <= tol:
            raise AssertionError(f"tiny config on the card: {key} off by {errs[key]} (tol {tol})")
    log(f"[check] tiny config, bf16 on the card vs fp32 on the CPU: max abs err {errs}")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
