#!/usr/bin/env python3
"""Time the decoder's boxRPB cross-attention (flash_xattn_rpb) and the
LayerNorm forward (layer_norm) on one NVIDIA GPU at the main path's shapes:
the cross-attention at q (1, 8, 201, 32) over k/v (1, 8, 5184, 32) with
ey/ex (1, 8, 201, 72) f32, in bf16 (the grounding path) and fp32 (the
default build), q, k and v split_heads views of (B, N, 256) projections as
the decoder hands them in; the LayerNorm at (5184, 256) bf16 -> bf16 (the
fusion encoder's 18 norms of a `ground`, whose tokens arrive as a
channel-major map seen as (1, 5184, 256); also row-major), (201, 256) bf16
-> bf16 (the decoder's) and (5184, 256) fp32 -> fp32 (the default build's
fusion encoder, channel-major and row-major), w and b f32.

Each kernel is held against its plain version first (the cross-attention
within 2e-2 (bf16) or 1e-4 (fp32) of the largest magnitude, the LayerNorm
within 1e-2), then timed: in a CUDA graph of 20 calls (chip_smoke.graph_time),
between CUDA events from the host (chip_smoke.cuda_time), and under
torch.profiler both eagerly (one call) and over one replay of the graph (the
device time of every kernel of a call, and the kernels' names), beside the
plain version in a graph, one library call (F.scaled_dot_product_attention
with the full bias at q's dtype; F.layer_norm) and the bound
(chip_smoke.bound).

    python3 bench_decoder_kernels.py [--tracker] [--other DIR | --splits]

With --tracker, the tracker's and the training steps' kernels instead: the
7x7 depthwise conv (depthwise_conv2d) forward and backward at the memory
encoder's fuser shape x (8, 72, 72, 256), taps and bias a permuted view of
a (C, 1, 7, 7) weight in the maps' dtype as CXBlock hands them, bf16 and
fp32 (held within 1e-2 / 1e-4 of the plain versions' largest magnitude, dw
and db within 1e-4; library F.conv2d groups=C, channels-last, and its
backward); and the LayerNorm backward (layer_norm_bwd) at the Stage-3
step's (4, 5184, 256) and the tracker clip's (8, 5184, 256), row-major and
channel-major ((B, C, N) maps transposed, as the fusion encoder's tokens),
x and dy both bf16 or both fp32 (dx within 1e-2 / 1e-4, dw and db within
1e-3 / 1e-4; library F.layer_norm's backward). Backward library times are
host-timed calls (chip_smoke.cuda_time): autograd is not captured.

With --splits, the cross-attention alone at the decoder's shape in both
dtypes at each key split count 1 to 8 (each the cluster size; the kernel's
rule picks one), beside the kernel's resources at each.
With --other, the same measurement of the checkout at DIR (another commit's
kernels, built there) is taken in the process order other, this, this,
other, each in its own process, so that two versions compare on one card (the
helpers are this checkout's chip_smoke.py, the kernels the other's).
Prints one line a kernel and run, with the card's name and power limit.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

XATTN = (("bf16", 1, 201, (72, 72)), ("fp32", 1, 201, (72, 72)))
# (rows, channels, x dtype, y dtype, x channel-major: the fusion encoder's
# tokens as its norms receive them, a (1, C, N) map seen as (1, N, C))
NORMS = ((5184, 256, "bf16", "bf16", True), (5184, 256, "bf16", "bf16", False),
         (201, 256, "bf16", "bf16", False), (5184, 256, "fp32", "fp32", True),
         (5184, 256, "fp32", "fp32", False))


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def measure_tracker(cs, label, smi, failed):
    """The depthwise conv (forward, backward) and layer_norm_bwd, each held
    to its plain version and then timed as report() times a kernel."""
    import torch
    import torch.nn.functional as F

    from efficientsam3_tpu_torch.ops import depthwise as dw
    from efficientsam3_tpu_torch.ops import layer_norm as ln

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.backends.cudnn.allow_tf32 = False  # the fp32 library conv in fp32

    def timed(what, errs, tols, fn, plain, library, bms, by, lib_graph=True):
        bad = [f"{k} {errs[k]:.3e} (bound {tols[k]})" for k in errs if not errs[k] <= tols[k]]
        if bad:
            print(f"[{label}] {what}: DISAGREES with its plain version: {'; '.join(bad)}: not "
                  f"timed | {smi}", flush=True)
            failed.append(what)
            return
        ms = cs.graph_time(fn)
        call_ms = cs.cuda_time(fn, 50)
        _, _, eager_us = cs.profile_kernels(fn)
        graph_ms_dev, names = cs.replay_profile(fn)
        plain_ms = cs.graph_time(plain, 2, 5)
        lib_ms = cs.graph_time(library) if lib_graph else cs.cuda_time(library, 20)
        kernels = ", ".join(f"{k[:48]} {v:.4f}" for k, v in
                            sorted(names.items(), key=lambda kv: -kv[1])[:3])
        err = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        print(f"[{label}] {what}: graph {ms:.4f} ms | call {call_ms:.4f} ms | dev eager "
              f"{eager_us / 1e3:.4f} ms | dev in graph {graph_ms_dev:.4f} ms ({kernels}) | "
              f"plain {plain_ms:.4f} ms | library {lib_ms:.4f} ms | bound {bms:.4f} ms ({by}) | "
              f"errors of the largest magnitude: {err} | {smi}", flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        shape = (8, 72, 72, 256)
        c = shape[-1]
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        g = (1e-2 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
        weight = (0.2 * torch.randn((c, 1, 7, 7), generator=gen, device=dev)).to(dtype)
        kernel = weight.permute(2, 3, 1, 0)
        bias = (0.1 * torch.randn((c,), generator=gen, device=dev)).to(dtype)
        esz = x.element_size()
        x_cl = x.permute(0, 3, 1, 2)
        bms, by = cs.bound(2 * esz * x.numel() + esz * (kernel.numel() + c),
                           fp32_ops=2.0 * 49 * x.numel())
        got = dw.depthwise_conv2d(x, kernel, bias)
        timed(f"depthwise_conv2d {name} x {shape}",
              {"y": _rel(got, dw.depthwise_conv2d_plain(x, kernel, bias))}, {"y": tol},
              lambda: dw.depthwise_conv2d(x, kernel, bias),
              lambda: dw.depthwise_conv2d_plain(x, kernel, bias),
              lambda: F.conv2d(x_cl, weight, bias, padding=3, groups=c), bms, by)
        got = dw.depthwise_conv2d_bwd(x, kernel, g)
        want = dw.depthwise_conv2d_bwd_plain(x, kernel, g)
        bms, by = cs.bound(3 * esz * x.numel() + esz * kernel.numel(),
                           fp32_ops=4.0 * 49 * x.numel())
        xl = x_cl.detach().clone().requires_grad_()
        wl = weight.detach().clone().requires_grad_()
        bl = bias.detach().clone().requires_grad_()
        yl = F.conv2d(xl, wl, bl, padding=3, groups=c)
        gl = g.permute(0, 3, 1, 2)
        timed(f"depthwise_conv2d_bwd {name} x {shape}",
              dict(zip(("dx", "dw", "db"), (_rel(a, b) for a, b in zip(got, want)))),
              {"dx": tol, "dw": 1e-4, "db": 1e-4},
              lambda: dw.depthwise_conv2d_bwd(x, kernel, g),
              lambda: dw.depthwise_conv2d_bwd_plain(x, kernel, g),
              lambda: torch.autograd.grad(yl, (xl, wl, bl), gl, retain_graph=True), bms, by,
              lib_graph=False)
        del x, g, got, want, xl, wl, bl, yl

    for (b, n), cmajor, dtype in ((bnc, cm, dt) for bnc in ((4, 5184), (8, 5184))
                                  for cm in (True, False)
                                  for dt in (torch.bfloat16, torch.float32)):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        c = 256
        if cmajor:
            x, g = ((3.0 * torch.randn((b, c, n), generator=gen, device=dev)).to(dtype)
                    .transpose(1, 2) for _ in range(2))
        else:
            x, g = ((3.0 * torch.randn((b, n, c), generator=gen, device=dev)).to(dtype)
                    for _ in range(2))
        w = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        got = ln.layer_norm_bwd(x, w, g, 1e-5)
        want = ln.layer_norm_bwd_plain(x, w, g, 1e-5)
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        esz = x.element_size()
        bms, by = cs.bound(3 * esz * x.numel(), fp32_ops=16.0 * x.numel())
        xl = x.detach().clone().requires_grad_()
        wl = w.detach().clone().to(dtype).requires_grad_()
        bl = torch.zeros_like(wl, requires_grad=True)
        yl = F.layer_norm(xl, (c,), wl, bl, 1e-5)
        timed(f"layer_norm_bwd {name} ({b}, {n}, {c}){' channel-major' if cmajor else ''}",
              dict(zip(("dx", "dw", "db"), (_rel(a, e) for a, e in zip(got, want)))),
              {"dx": tol, "dw": 1e-3 if dtype == torch.bfloat16 else 1e-4,
               "db": 1e-3 if dtype == torch.bfloat16 else 1e-4},
              lambda: ln.layer_norm_bwd(x, w, g, 1e-5),
              lambda: ln.layer_norm_bwd_plain(x, w, g, 1e-5),
              lambda: torch.autograd.grad(yl, (xl, wl, bl), g, retain_graph=True), bms, by,
              lib_graph=False)
        del x, g, got, want, xl, wl, bl, yl
        torch.cuda.empty_cache()


def measure(label, tracker=False):
    import torch
    import torch.nn.functional as F

    # this file's chip_smoke (its helpers), the package of the checkout run
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.getcwd())
    from efficientsam3_tpu_torch.ops import flash_attention as fa
    from efficientsam3_tpu_torch.ops import layer_norm as ln

    if not torch.cuda.is_available():
        raise SystemExit("bench_decoder_kernels: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    smi = cs.nvidia_smi_line()
    failed = []
    if tracker:
        measure_tracker(cs, label, smi, failed)
        if failed:
            raise SystemExit(f"bench_decoder_kernels [{label}]: {len(failed)} kernel(s) disagree "
                             f"with their plain versions: {failed}")
        return

    def report(what, got, want, tol, fn, plain, library, bms, by):
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if not err <= tol * max(scale, 1e-30):
            print(f"[{label}] {what}: DISAGREES with its plain version (max abs err {err:.3e}, "
                  f"{err / max(scale, 1e-30):.3e} of the largest magnitude against {tol}): "
                  f"not timed | {smi}", flush=True)
            failed.append(what)
            return
        ms = cs.graph_time(fn)
        call_ms = cs.cuda_time(fn, 50)
        _, _, eager_us = cs.profile_kernels(fn)
        graph_ms_dev, names = cs.replay_profile(fn)
        plain_ms = cs.graph_time(plain)
        lib_ms = cs.graph_time(library)
        kernels = ", ".join(f"{k[:48]} {v:.4f}" for k, v in
                            sorted(names.items(), key=lambda kv: -kv[1])[:3])
        print(f"[{label}] {what}: graph {ms:.4f} ms | call {call_ms:.4f} ms | dev eager "
              f"{eager_us / 1e3:.4f} ms | dev in graph {graph_ms_dev:.4f} ms ({kernels}) | "
              f"plain {plain_ms:.4f} ms | library {lib_ms:.4f} ms | bound {bms:.4f} ms ({by}) | "
              f"max abs err {err:.3e} | {smi}", flush=True)

    for dt, b, lq, hw in XATTN:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        h, d = 8, 32
        lk = hw[0] * hw[1]
        q, k, v = (torch.randn((b, n, h * d), generator=gen, device=dev).to(dtype)
                   .view(b, n, h, d).transpose(1, 2) for n in (lq, lk, lk))
        ey = 2.0 * torch.randn((b, h, lq, hw[0]), generator=gen, device=dev)
        ex = 2.0 * torch.randn((b, h, lq, hw[1]), generator=gen, device=dev)
        scale = d ** -0.5
        fn = lambda: fa.flash_xattn_rpb(q, k, v, ey, ex, hw, scale)  # noqa: E731
        plain = lambda: fa.flash_xattn_rpb_plain(q, k, v, ey, ex, hw, scale)  # noqa: E731
        full_bias = fa.rpb_bias(ey, ex, hw).to(dtype)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=full_bias, scale=scale)
        if dt == "bf16":
            nb = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * (ey.numel() + ex.numel())
            bms, by = cs.bound(nb, 4.0 * b * h * lq * lk * d, 1.0 * b * h * lq * lk,
                               8.0 * b * h * lq * lk)
        else:
            bms, by = cs.attn_bound(q.numel(), b * h * lq * lk, d,
                                    kv_elems=k.numel() + v.numel())
        report(f"flash_xattn_rpb {dt} q {tuple(q.shape)} k/v {tuple(k.shape)}", fn(), plain(),
               2e-2 if dt == "bf16" else 1e-4, fn, plain, library, bms, by)

    for rows, c, xdt, ydt, cmajor in NORMS:
        x_dtype = torch.bfloat16 if xdt == "bf16" else torch.float32
        y_dtype = torch.bfloat16 if ydt == "bf16" else torch.float32
        if cmajor:
            x = (3.0 * torch.randn((1, c, rows), generator=gen, device=dev)).to(x_dtype)
            x = x.transpose(1, 2)
        else:
            x = (3.0 * torch.randn((1, rows, c), generator=gen, device=dev)).to(x_dtype)
        w = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        bs = 0.1 * torch.randn((c,), generator=gen, device=dev)
        wx, bx = w.to(x_dtype), bs.to(x_dtype)
        fn = lambda: ln.layer_norm(x, w, bs, 1e-5, y_dtype)  # noqa: E731
        plain = lambda: ln.layer_norm_plain(x, w, bs, 1e-5, y_dtype)  # noqa: E731
        library = lambda: F.layer_norm(x, (c,), wx, bx, 1e-5)  # noqa: E731
        nb = x.numel() * x.element_size() + x.numel() * y_dtype.itemsize + 8 * c
        bms, by = cs.bound(nb, fp32_ops=8.0 * rows * c)
        report(f"layer_norm ({rows}, {c}) {xdt} -> {ydt}"
               f"{' channel-major' if cmajor else ''}", fn(), plain(), 1e-2, fn, plain,
               library, bms, by)
    if failed:
        raise SystemExit(f"bench_decoder_kernels [{label}]: {len(failed)} kernel(s) disagree "
                         f"with their plain versions: {failed}")


def sweep_splits():
    import torch

    import chip_smoke as cs
    from efficientsam3_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("bench_decoder_kernels: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    smi = cs.nvidia_smi_line()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((1, n, 256), generator=gen, device=dev).to(dtype)
                   .view(1, n, 8, 32).transpose(1, 2) for n in (201, 5184, 5184))
        ey, ex = (2.0 * torch.randn((1, 8, 201, 72), generator=gen, device=dev) for _ in range(2))
        picked = fa.xattn_splits_for(dtype, 8, 201, (72, 72))
        for splits in range(1, 9):
            ms = cs.graph_time(lambda: fa.flash_xattn_rpb(q, k, v, ey, ex, (72, 72), splits=splits))
            res = fa.xattn_resources(dtype, (72, 72), splits)
            print(f"[splits] flash_xattn_rpb {str(dtype)[6:]} {splits} key splits"
                  f"{' (the rule)' if splits == picked else ''}: graph {ms:.4f} ms | {res} | {smi}",
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout, timed in turns with this one")
    ap.add_argument("--splits", action="store_true",
                    help="time the cross-attention at each key split count")
    ap.add_argument("--tracker", action="store_true",
                    help="time the depthwise conv and the LayerNorm backward instead")
    ap.add_argument("--label", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.splits:
        sweep_splits()
        return 0
    if args.other is None or args.label is not None:
        measure(args.label or "this", args.tracker)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    rc = 0
    for where, label in ((other, "other"), (here, "this"), (here, "this"), (other, "other")):
        run = subprocess.run([sys.executable, os.path.join(here, "bench_decoder_kernels.py"),
                              "--label", f"{label} ({os.path.relpath(where, here)})",
                              *(["--tracker"] if args.tracker else [])], cwd=where)
        if label == "this":
            rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
