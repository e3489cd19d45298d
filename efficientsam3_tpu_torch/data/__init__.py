"""Host-side data pipelines of the port (numpy only): ``sa1b`` for Stage-1
distillation."""
