"""The node exporter's collector (see the JAX package's metrics/)."""
