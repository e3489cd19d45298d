"""Same-padded depthwise 2D convolution over NHWC maps: a CUDA kernel for
the H100 and its plain PyTorch version.

Replaces the Pallas kernel ``efficientsam3_tpu/ops/pallas/depthwise.py``
(``_dw_call`` / ``_dw_kernel``, forward only): the 7x7 depthwise conv of the
tracker memory encoder's ConvNeXt fuser (``models/memory_encoder.CXBlock``),
fp32 accumulation, bias, output in the input dtype. The kernel is CUDA C++
in ``csrc/depthwise_conv2d.cu`` (see its note for what bounds it), built by
``ops/_build.py`` on first use.

The kernel takes any channel count and any map size. The JAX package's
dispatch rule ``use_pallas_depthwise`` (channels a multiple of 128, maps
within the VMEM budget) only existed for the TPU's lanes and fast memory;
here every CXBlock depthwise on a CUDA tensor goes to the kernel. CPU
tensors take the plain version; a CUDA tensor the kernel does not take
(not bf16, a kernel size other than 7) raises, and so does a call that
autograd would record (the kernel has no backward yet). CPU tensors are
differentiated through the plain version. ``depthwise_conv2d.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from efficientsam3_tpu_torch.ops import _build

_KERNEL_SIZE = 7
_I, _P = ctypes.c_int, ctypes.c_void_p


def depthwise_conv2d_plain(x, kernel, bias):
    """x (B, H, W, C); kernel (k, k, 1, C) in the flax depthwise layout;
    bias (C,). Zero 'same' padding, fp32 sum of the k*k taps, bias added in
    fp32, result in x.dtype."""
    k = kernel.shape[0]
    p = k // 2
    h, w = x.shape[1:3]
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    wk = kernel[:, :, 0, :].float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dj in range(k):
        for di in range(k):
            acc += wk[di, dj] * xp[:, di:di + h, dj:dj + w]
    return (acc + bias.float()).to(x.dtype)


def _lib():
    fn = _build.load("depthwise_conv2d").depthwise_conv2d_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        fn.restype = _I
    return fn


def depthwise_conv2d(x, kernel, bias):
    """Same-padded depthwise conv (forward). x (B, H, W, C); kernel
    (k, k, 1, C); bias (C,). Returns (B, H, W, C) in x.dtype."""
    if not x.is_cuda:
        return depthwise_conv2d_plain(x, kernel, bias)
    _build.refuse_grad("depthwise_conv2d", x, kernel, bias)
    b, h, w, c = x.shape
    k = kernel.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"depthwise_conv2d kernel takes bfloat16 maps, got {x.dtype}")
    if kernel.shape != (_KERNEL_SIZE, _KERNEL_SIZE, 1, c) or bias.shape != (c,):
        raise ValueError(f"depthwise_conv2d kernel takes a ({_KERNEL_SIZE}, {_KERNEL_SIZE}, 1, "
                         f"{c}) kernel and ({c},) bias, got {tuple(kernel.shape)} and "
                         f"{tuple(bias.shape)}")
    x = x.contiguous()
    wk = kernel[:, :, 0, :].float().contiguous()
    bs = bias.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        status = _lib()(x.data_ptr(), wk.data_ptr(), bs.data_ptr(), out.data_ptr(),
                        b, h, w, c, k, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "depthwise_conv2d launch")
    depthwise_conv2d.launches += 1
    return out


depthwise_conv2d.launches = 0
