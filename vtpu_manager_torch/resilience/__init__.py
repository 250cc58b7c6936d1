"""Retries for the node agent's API calls (see the JAX package's
resilience/)."""
