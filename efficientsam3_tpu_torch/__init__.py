"""efficientsam3_tpu_torch: the PyTorch + CUDA port of efficientsam3_tpu.

The JAX package ``efficientsam3_tpu`` is the reference this package is held
against; nothing here imports it, nor JAX. The layout mirrors the JAX
package module for module, so each file has a counterpart at the same path:

  models/    nn.Module definitions (trunk, neck, text tower, geometry,
             fusion encoder, decoder, seg head, the image model)
  ops/       torch-parity resize / roi_align / grid_sample, and the
             hand-written Hopper kernels with their plain PyTorch versions
  csrc/      CUDA C++ sources of the attention kernels (built on first use)
  utils/     weight conversion from the JAX variables, tokenizer

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
