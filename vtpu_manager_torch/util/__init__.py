"""Device resolution and the limit variables (see the JAX package's util/)."""
