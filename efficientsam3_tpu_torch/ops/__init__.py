"""Numerical ops of the port: torch-parity resize / roi_align / grid_sample,
and the hand-written Hopper kernels (layer_norm, flash_attention) with
their plain PyTorch versions."""

from efficientsam3_tpu_torch.ops.grid_sample import grid_sample
from efficientsam3_tpu_torch.ops.interpolate import resize, resize_bicubic, resize_bilinear
from efficientsam3_tpu_torch.ops.roi_align import roi_align

__all__ = ["grid_sample", "resize", "resize_bicubic", "resize_bilinear", "roi_align"]
