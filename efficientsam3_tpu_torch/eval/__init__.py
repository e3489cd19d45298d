"""Evaluation helpers of the port (copies of the JAX package's JAX-free ones)."""
