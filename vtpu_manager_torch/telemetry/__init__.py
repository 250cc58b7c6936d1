"""Per-tenant step telemetry (see the JAX package's telemetry/)."""
