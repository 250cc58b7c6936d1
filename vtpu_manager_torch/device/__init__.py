"""Chip and mesh descriptions (see the JAX package's device/)."""
