"""The node agent's Kubernetes client (see the JAX package's client/)."""
