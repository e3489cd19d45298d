"""efficientsam3_tpu_torch: the PyTorch + CUDA port of efficientsam3_tpu.

The JAX package ``efficientsam3_tpu`` is the reference this package is held
against; nothing here imports it, nor JAX. The layout mirrors the JAX
package module for module, so each file has a counterpart at the same path:

  models/    nn.Module definitions (trunk, neck, text tower, geometry,
             fusion encoder, decoder, seg head, the image model; the SAM3
             teacher's ViTDet trunk and CLIP text tower; the SAM heads,
             memory attention and memory encoder of the tracker)
  video/     the tracker core and the VOS predictor
  train/     Stage-1 distillation and Stage-3 training: steps, optimizers,
             losses, matcher, trainer
  data/      the Stage-1 data pipeline (SA-1B teacher records, numpy only)
  ops/       torch-parity resize / roi_align / grid_sample, focal loss, box
             IoU, the host Hungarian solver, and the hand-written Hopper
             kernels (forward and backward) with their plain versions
  csrc/      CUDA C++ sources of the kernels, and the Hungarian solver's
             host C++ (built on first use)
  utils/     weight conversion from the JAX variables, tokenizer,
             checkpoints, logging and metrics writers
  eval/      COCO-format helpers (RLE encode / decode)
  student_sam.py / automatic_mask_generator.py
             the SAM1 students (RepViT, TinyViT, EfficientViT and ViT
             trunks under the SAM heads) with their predictor, and
             automatic mask generation over the SAM1-task predictor

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
