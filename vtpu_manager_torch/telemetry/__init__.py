"""Per-tenant step telemetry (see the JAX package's telemetry/): the ring
the tenant writes (stepring.py), the node's fold of every ring into
per-pod metrics (aggregate.py) and the pressure annotation the scheduler
scores by (pressure.py)."""

from vtpu_manager_torch.telemetry.aggregate import TenantStepTelemetry

__all__ = ["TenantStepTelemetry"]
