"""The port's examples, one module for each of the JAX package's
``examples/``: ``python -m efficientsam3_tpu_torch.examples.<name>``. Each has
``main(argv=None)``, the JAX example's arguments and ``--device`` (default
``cuda``); with no checkpoint the weights are seeded (a dry run)."""
