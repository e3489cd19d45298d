#!/usr/bin/env python3
"""Time the flash-attention backward kernels at head dim 256 on one NVIDIA
GPU: flash_sdpa_bwd_dq and flash_sdpa_bwd_dkv, each in a CUDA graph
(chip_smoke.graph_time), 3 of 8 object slots live, dO a strided view. In
bf16 (the default) at the 8-frame tracker training clip's cross-attention
(q (8, 1, 5184, 256), k/v (8, 1, 36352, 256), a masked tail of 37 keys)
and self-attention (k/v 5184 keys) shapes; with --dtype fp32 at the
default build's 3-frame clip's (cross: k/v 10376 keys, every key of a live
slot live, 31128 in all; self: 5184), the split passes included.

    python3 bench_bwd_d256.py [--dtype bf16|fp32] [--clip]
                              [--other DIR | --set NAME=VALUE ...]

With --clip (fp32 only), instead of the kernels: chip_smoke.py's [fp32]
3-frame tracker training clip (EV-M b1 at 1008², 8 slots, 3 live, compact
bank, seeded inputs), once to warm up, then its forward and backward with
the peak memory statistics reset just before: the peak
(torch.cuda.max_memory_allocated) and the backward's wall time.

With --other, the same measurement of the checkout at DIR (another
commit's kernels, built there) is taken in the same process order other,
this, this, other, each in its own process, so that two versions compare
on one card. --set NAME=VALUE makes that other checkout a variant of this
one: a copy under runs/variants/ with the tuning constant NAME of
csrc/flash_sdpa_bwd_wide_h_fp32.cu (FLUSH: key tiles a dQ fragment sums;
NR: k-steps of the dkv kernel's resident hi part in registers) set to
VALUE, and prints its kernels' registers and spills first. Prints one line
a run, with the card's name and power limit.
"""

import argparse
import os
import re
import shutil
import subprocess
import sys

FP32_SOURCE = os.path.join("efficientsam3_tpu_torch", "csrc", "flash_sdpa_bwd_wide_h_fp32.cu")
TUNABLE = ("FLUSH", "NR")


def make_variant(here, sets):
    """A copy of the checkout at `here` (without runs/, _build/, *_out/)
    with each NAME=VALUE constant of the fp32 source replaced; its path."""
    for item in sets:
        key, _, value = item.partition("=")
        if key not in TUNABLE or not value.isdigit():
            raise SystemExit(f"bench_bwd_d256: --set takes {' or '.join(TUNABLE)}=INTEGER")
    name = "_".join(sets).replace("=", "")
    dst = os.path.join(here, "runs", "variants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(here, dst, ignore=shutil.ignore_patterns("runs", "*_out", "_build", ".git"))
    path = os.path.join(dst, FP32_SOURCE)
    with open(path) as f:
        text = f.read()
    for item in sets:
        key, value = item.split("=")
        text, n = re.subn(rf"(constexpr int {key} = )[^;]+;", rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"bench_bwd_d256: no constant {key} in {FP32_SOURCE}")
    with open(path, "w") as f:
        f.write(text)
    return dst


def run_here(dtype_name, resources=False):
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from efficientsam3_tpu_torch.ops import _build
    from efficientsam3_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("bench_bwd_d256: no CUDA device")
    _build.build_all()
    if resources:
        for kernel in ("flash_sdpa_bwd_dq_wide_f32", "flash_sdpa_bwd_dkv_wide_f32"):
            print(f"[bench_bwd_d256] {os.getcwd()}: {kernel} "
                  f"{fa.kernel_resources(kernel, 256, 36352)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    scale = 256 ** -0.5
    parts = []
    cross, tail = (36352, 37) if dtype == torch.bfloat16 else (10376, 0)
    for name, lk in (("cross", cross), ("self", 5184)):
        q, k, v = randn(8, 1, 5184, 256), randn(8, 1, lk, 256), randn(8, 1, lk, 256)
        bias = torch.full((8, lk), fa.NEG_INF, device="cuda")
        bias[:3] = 0.0
        if name == "cross" and tail:
            bias[:3, -tail:] = fa.NEG_INF
        o, lse = fa.flash_sdpa(q, k, v, bias, return_lse=True)
        do = randn(8, 5184, 256).reshape(8, 5184, 1, 256).transpose(1, 2)
        _, delta = fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale)
        per, reps = (2, 5) if name == "cross" else (5, 10)
        ms_dq = cs.graph_time(lambda: fa.flash_sdpa_bwd_dq(q, k, v, bias, o, lse, do, scale),
                              per, reps)
        ms_dkv = cs.graph_time(lambda: fa.flash_sdpa_bwd_dkv(q, k, v, bias, do, lse, delta, scale),
                               per, reps)
        parts.append(f"{name} (k/v {lk} keys) dq {ms_dq:.4f} ms dkv {ms_dkv:.4f} ms")
        del q, k, v, o, lse, do, delta
        torch.cuda.empty_cache()
    print(f"[bench_bwd_d256] {dtype_name} {os.getcwd()}: {' | '.join(parts)} (CUDA graph) | "
          f"{cs.nvidia_smi_line()}", flush=True)


def run_clip():
    """The [fp32] clip's peak memory and backward wall time in this checkout."""
    import time

    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from efficientsam3_tpu_torch.build import build_efficientsam3_video_model
    from efficientsam3_tpu_torch.models.common import sine_pos_embed_2d
    from efficientsam3_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("bench_bwd_d256: no CUDA device")
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    frames = cs.FP32_CLIP_FRAMES
    image_m, core = build_efficientsam3_video_model(model_name="b1", device=dev, seed=0)
    with torch.no_grad():  # as chip_smoke.py's clip
        for blk in core.memory_encoder.fuser:
            blk.gamma.fill_(1.0)
        core.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    core.train().requires_grad_(True)
    fs, d = core.feat_size, core.d_model
    feats = []
    with torch.no_grad():
        for t in range(frames):
            img = torch.as_tensor(np.random.default_rng(7 + t).standard_normal(
                (1008, 1008, 3)).astype(np.float32), device=dev)[None]
            fpn = image_m.encode_image(img)["sam2_fpn"]
            feats.append((fpn[2].reshape(1, fs * fs, d), fpn[0], fpn[1]))
    del image_m
    pos = sine_pos_embed_2d(fs, fs, d, device=dev).reshape(fs * fs, d)
    proj = torch.randn((frames, cs.TT_SLOTS, 1, 4 * fs, 4 * fs),
                       generator=torch.Generator(device=dev).manual_seed(5), device=dev)

    def clip():
        torch.manual_seed(0)
        core.zero_grad(set_to_none=True)
        return cs.tracker_clip(core, feats, pos, proj, cs.TT_LIVE, compact=True)

    loss, _ = clip()
    loss.backward()
    del loss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = clip()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[bench_bwd_d256] fp32 clip {os.getcwd()}: {frames} frames, peak memory "
          f"{peak / 2**30:.4f} GiB ({peak} bytes), backward {bwd_ms:.1f} ms wall | "
          f"{cs.nvidia_smi_line()}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--clip", action="store_true",
                    help="the fp32 tracker clip's peak memory, not the kernels' times")
    ap.add_argument("--other", help="root of another checkout to time in turns with this one")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="time a variant of this checkout (FLUSH or NR of the fp32 source)")
    ap.add_argument("--here", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--resources", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.clip and args.dtype != "fp32":
        raise SystemExit("bench_bwd_d256: --clip measures the fp32 clip (--dtype fp32)")
    if args.here or not (args.other or args.set):
        if args.clip:
            run_clip()
        else:
            run_here(args.dtype, args.resources)
        return
    me = os.path.abspath(__file__)
    here = os.path.dirname(me)
    other = make_variant(here, args.set) if args.set else args.other
    for i, root in enumerate((other, here, here, other)):
        extra = ["--resources"] if args.set and i < 2 else []
        extra += ["--clip"] if args.clip else []
        subprocess.run([sys.executable, me, "--here", "--dtype", args.dtype, *extra], cwd=root,
                       check=True, timeout=600)


if __name__ == "__main__":
    main()
