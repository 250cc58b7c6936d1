"""Entry points of the port (see the JAX package's cmd/)."""
