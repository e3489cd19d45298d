"""The port's command-line entry points, one module for each of the JAX
package's ``scripts/`` tools: ``python -m efficientsam3_tpu_torch.scripts.<name>``.
Each has ``main(argv=None)``, the JAX script's flags, and ``--device``
(default ``cuda``; ``--device cpu`` runs on the host)."""
