"""Feature gates, parsed from `--feature-gates=A=true,B=false`.

The port of the JAX package's `util/featuregates.py:314-357`, holding only
the gates the port's node agents wire (same names and defaults as the
JAX package's). A gate the port does not know is an error, as it is in the
JAX parser: a part that is not ported yet is refused, not ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field

TC_WATCHER = "TCWatcher"                # the node's utilization watcher
VMEMORY_NODE = "VMemoryNode"            # the cross-process memory ledger
HONOR_PREALLOC_IDS = "HonorPreAllocatedDeviceIDs"
STEP_TELEMETRY = "StepTelemetry"        # per-tenant step rings
COMM_TELEMETRY = "CommTelemetry"        # copies and collectives in the rings
NRI_SUPPORT = "NRISupport"              # DRA: the NRI runtime hook
CORE_PLUGIN = "CorePlugin"              # advertise the vtpu-cores resource
MEMORY_PLUGIN = "MemoryPlugin"          # advertise the vtpu-memory resource
COMPILE_CACHE = "CompileCache"          # the node compile cache
CLUSTER_COMPILE_CACHE = "ClusterCompileCache"  # entries fetched from peers
TRACING = "Tracing"                     # allocation-path spans
FAULT_INJECTION = "FaultInjection"      # the failpoint registry
CLIENT_MODE = "ClientMode"              # the registry socket's pid sets
QUOTA_MARKET = "QuotaMarket"            # the workload class in Allocate
HBM_OVERCOMMIT = "HBMOvercommit"        # virtual memory + the host overflow

_KNOWN = {
    TC_WATCHER: False,
    VMEMORY_NODE: False,
    HONOR_PREALLOC_IDS: False,
    STEP_TELEMETRY: False,
    # on top of StepTelemetry: the interposer counts host-card copies and
    # NCCL's kernels into the ring's comm block
    COMM_TELEMETRY: False,
    NRI_SUPPORT: False,
    CORE_PLUGIN: False,
    MEMORY_PLUGIN: False,
    COMPILE_CACHE: False,
    # on top of CompileCache: the node advertises its warm entries, and a
    # cold node's miss fetches one from a peer before compiling
    CLUSTER_COMPILE_CACHE: False,
    TRACING: False,
    FAULT_INJECTION: False,
    CLIENT_MODE: False,
    # Allocate stamps the pod's workload class into the config; the
    # market manager that lends between classes is a plane, not ported
    # (cmd/device_plugin.py refuses the gate on)
    QUOTA_MARKET: False,
    # the node's policy publishes per-class ratios from the rings' memory
    # high-waters, Allocate stamps each device's virtual capacity and the
    # node's spill budget, and the interposer serves an allocation past
    # the card's physical memory from host memory within both
    HBM_OVERCOMMIT: False,
}


@dataclass
class FeatureGates:
    gates: dict[str, bool] = field(default_factory=lambda: dict(_KNOWN))

    def enabled(self, name: str) -> bool:
        if name not in self.gates:
            raise KeyError(f"unknown feature gate {name!r}")
        return self.gates[name]

    def set(self, name: str, value: bool) -> None:
        if name not in self.gates:
            raise KeyError(f"unknown feature gate {name!r}")
        self.gates[name] = value

    def parse(self, spec: str) -> None:
        """Parses `Gate1=true,Gate2=false`. All or nothing: the whole spec
        is checked before any gate is set, and every problem (an unknown
        name included) raises ValueError."""
        if not spec:
            return
        parsed: list[tuple[str, bool]] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"invalid feature gate spec {part!r}")
            name, _, raw = part.partition("=")
            name = name.strip()
            raw = raw.strip().lower()
            if raw not in ("true", "false"):
                raise ValueError(f"invalid feature gate value {part!r}")
            if name not in self.gates:
                raise ValueError(f"unknown feature gate {name!r}")
            parsed.append((name, raw == "true"))
        for name, value in parsed:
            self.set(name, value)

    def known(self) -> list[str]:
        return sorted(self.gates)
