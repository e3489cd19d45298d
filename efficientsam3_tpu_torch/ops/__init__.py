"""Numerical ops of the port: torch-parity resize / roi_align / grid_sample,
and the hand-written Hopper kernels (layer_norm, flash_attention) with
their plain PyTorch versions."""
