"""Host-side data pipelines of the port (numpy only): ``sa1b`` for Stage-1
distillation, ``transforms`` and ``stage3_mixed`` for Stage-3 batches,
``engine`` for VLM pseudo-labels."""
