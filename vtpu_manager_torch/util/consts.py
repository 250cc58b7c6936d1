"""The variables and names a tenant's enforcement reads.

The limit variables keep the names the JAX package gives them
(`vtpu_manager/util/consts.py:444-451`), so one device plugin can inject the
same environment into a TPU tenant and a GPU tenant. This is the port's own
copy of the part it needs; the GPU-only names follow.
"""

from __future__ import annotations

ENV_MEM_LIMIT = "VTPU_MEM_LIMIT"            # + "_<i>" per device, bytes
ENV_CORE_LIMIT = "VTPU_CORE_LIMIT"          # + "_<i>", percent
ENV_CORE_SOFT_LIMIT = "VTPU_CORE_SOFT_LIMIT"
ENV_VISIBLE_DEVICES = "MANAGER_VISIBLE_DEVICES"    # host-index list
ENV_COMPAT_MODE = "MANAGER_COMPATIBILITY_MODE"
ENV_DISABLE_CONTROL = "DISABLE_VTPU_CONTROL"

# Compatibility modes (bitmask); the default counts every process.
COMPAT_HOST = 0x01

# Core-limit policies of a device (the JAX package's config/vtpu_config.py).
CORE_LIMIT_NONE = 0
CORE_LIMIT_HARD = 1
CORE_LIMIT_SOFT = 2

MANAGER_BASE_DIR = "/etc/vtpu-manager"
DRIVER_DIR = f"{MANAGER_BASE_DIR}/driver"          # interposer install dir

# GPU side: the interposer is preloaded into the tenant and forwards to the
# real driver named here (libcuda.so.1 from the loader's path when unset).
ENV_LD_PRELOAD = "LD_PRELOAD"
ENV_REAL_CUDA_LIBRARY_PATH = "VTPU_REAL_CUDA_LIBRARY_PATH"
ENV_SHIM_PATH = "VTPU_SHIM_PATH"
CONTROL_LIBRARY_NAME = "libvtpu-cuda-control.so"
# CLIENT mode's stdlib-only registrar, installed beside the interposer
DEVICE_CLIENT_SCRIPT = "vtpu_device_client.py"

# Node-shared state (the JAX package's util/consts.py:515-548, 572-573):
# each container's config file, the node watcher's utilization feed, the
# cross-process memory ledger and the per-device allocation locks.
ENV_CONFIG_PATH = "VTPU_CONFIG_PATH"
CONTAINER_CONFIG = f"{MANAGER_BASE_DIR}/config/vtpu.config"
WATCHER_DIR = f"{MANAGER_BASE_DIR}/watcher"
TC_UTIL_CONFIG = f"{WATCHER_DIR}/tc_util.config"
ENV_TC_UTIL_PATH = "VTPU_TC_UTIL_PATH"
LOCK_DIR = "/tmp/.vtpu_lock"
ENV_LOCK_DIR = "VTPU_LOCK_DIR"
VMEM_DIR = "/tmp/.vmem_node"
VMEM_NODE_CONFIG = f"{VMEM_DIR}/vmem_node.config"
ENV_VMEM_PATH = "VTPU_VMEM_PATH"
ENV_VMEM_STALE_S = "VTPU_VMEM_STALE_S"
# HBMOvercommit's host pool: one node-shared dir under the ledger's (so the
# ledger's mount carries it), whose files `overcommit/spill.py` accounts in
# the ledger's `spilled`; the variable arms the interposer's overflow tier
SPILL_DIR = f"{VMEM_DIR}/spill"
ENV_SPILL_POOL_DIR = "VTPU_SPILL_POOL_DIR"
ENV_POD_UID = "VTPU_POD_UID"
ENV_CONTAINER_NAME = "VTPU_CONTAINER_NAME"

MAX_DEVICE_COUNT = 64
NODE_WATCHER_INTERVAL_MS = 80  # node-level utilization watcher
EXTERNAL_WATCHER_FRESH_S = 5   # feed staleness before the shim falls back
LOCK_TIMEOUT_S = 10

# --- The device plugin's names ----------------------------------------------
# The same strings as the JAX package's (`util/consts.py:19-106, 215-219,
# 397-430, 457-561`): the scheduler and the webhook read them, whichever
# package wrote them.

DEFAULT_RESOURCE_DOMAIN = "google.com"
DEFAULT_ANNOTATION_DOMAIN = "vtpu-manager.io"


def resource_domain() -> str:
    return DEFAULT_RESOURCE_DOMAIN


def annotation_domain() -> str:
    return DEFAULT_ANNOTATION_DOMAIN


def vtpu_number_resource() -> str:
    return f"{resource_domain()}/vtpu-number"


def vtpu_cores_resource() -> str:
    return f"{resource_domain()}/vtpu-cores"


def vtpu_memory_resource() -> str:
    return f"{resource_domain()}/vtpu-memory"


def _ann(suffix: str) -> str:
    return f"{annotation_domain()}/{suffix}"


def pre_allocated_annotation() -> str:
    """The scheduler's chosen devices."""
    return _ann("pre-allocated")


def real_allocated_annotation() -> str:
    """The device plugin's final allocation."""
    return _ann("real-allocated")


def predicate_node_annotation() -> str:
    return _ann("predicate-node")


def allocation_status_annotation() -> str:
    return _ann("allocation-status")


def compute_policy_annotation() -> str:
    return _ann("compute-policy")


def workload_class_annotation() -> str:
    """The pod's workload class, normalized by the webhook (QuotaMarket):
    which side of the node's quota market its tenant sits on."""
    return _ann("workload-class")


# The workload classes (`util/consts.py:434-437`)
WORKLOAD_CLASS_LATENCY_CRITICAL = "latency-critical"
WORKLOAD_CLASS_THROUGHPUT = "throughput"
WORKLOAD_CLASSES = (WORKLOAD_CLASS_LATENCY_CRITICAL,
                    WORKLOAD_CLASS_THROUGHPUT)


def memory_oversold_annotation() -> str:
    return _ann("memory-oversold")


def node_device_register_annotation() -> str:
    return _ann("node-device-register")


def node_device_heartbeat_annotation() -> str:
    return _ann("node-device-heartbeat")


def node_obs_overhead_annotation() -> str:
    """The node's calibrated excess table ("gap_us:excess_us,...",
    manager/obs_calibrate.py); for observation only."""
    return _ann("node-obs-excess-table")


def node_pressure_annotation() -> str:
    """The node's step-ring pressure rollup,
    `<throttle_frac>:<hbm_headroom>@<ts>` (telemetry/pressure.py), which
    the scheduler scores by."""
    return _ann("node-pressure")


def node_overcommit_annotation() -> str:
    """The node's per-class memory ratios and spill signal,
    `<class>:<ratio>;...|<spill_frac>:<spilled_bytes>@<ts>`
    (overcommit/ratio.py), which the scheduler admits against."""
    return _ann("node-overcommit")


def node_cache_keys_annotation() -> str:
    """The node's warm compile-cache entries,
    `<endpoint>|<fp>=<entry_key>,...@<ts>` hottest first
    (clustercache/advertise.py): a cold node's fetcher downloads an entry
    key it names from `endpoint`, the node exporter's `/cache/entry`."""
    return _ann("node-cache-keys")


def trace_id_annotation() -> str:
    """The trace id minted at admission and carried through every stage of
    a pod's allocation path: the join key across processes."""
    return _ann("trace-id")


def trace_sampled_annotation() -> str:
    """The sampling decision ("true"/"false"), made once at admission so
    every later stage records or skips alike."""
    return _ann("trace-sampled")


ALLOC_STATUS_SUCCEED = "succeed"
ALLOC_STATUS_FAILED = "failed"

COMPUTE_POLICY_FIXED = "fixed"      # hard clamp at hard_core
COMPUTE_POLICY_BALANCE = "balance"  # elastic between hard_core..soft_core
COMPUTE_POLICY_NONE = "none"        # no core limit

ENV_POD_NAME = "VTPU_POD_NAME"
ENV_POD_NAMESPACE = "VTPU_POD_NAMESPACE"
ENV_STEP_TELEMETRY = "VTPU_STEP_TELEMETRY"  # "true": step ring armed
ENV_STEP_RING_PATH = "VTPU_STEP_RING_PATH"  # tenant-side ring file path
# "true": the interposer measures copies and collectives into the ring's
# comm block; written only beside ENV_STEP_TELEMETRY (the ring is the wire)
ENV_COMM_TELEMETRY = "VTPU_COMM_TELEMETRY"
ENV_TRACE_ID = "VTPU_TRACE_ID"              # the pod's trace id
ENV_TRACE_SAMPLED = "VTPU_TRACE_SAMPLED"    # "true"/"false"
ENV_TRACE_DIR = "VTPU_TRACE_DIR"            # a tenant's spool dir, if set

# the other compatibility modes (bitmask, with COMPAT_HOST above)
COMPAT_CGROUP = 0x02
COMPAT_CLIENT = 0x04
COMPAT_OPEN_KERNEL = 0x08

REGISTRY_DIR = f"{MANAGER_BASE_DIR}/registry"
# ClientMode: the node registry's socket, at the same path on the host and
# in the container (the JAX package's `util/consts.py:490, 521`)
REGISTRY_SOCKET = f"{REGISTRY_DIR}/socket.sock"
ENV_REGISTRY_SOCKET = "VTPU_REGISTRY_SOCKET"  # the socket's override
# the command the interposer runs as the device client in CLIENT mode
ENV_DEVICE_CLIENT_CMD = "VTPU_DEVICE_CLIENT_CMD"
# the step ring: <base>/<uid>_<cont>/telemetry/<name> on the host, the
# subdir mounted read-write at MANAGER_BASE_DIR/telemetry in the container
TELEMETRY_SUBDIR = "telemetry"
STEP_RING_NAME = "step_telemetry.ring"
PIDS_CONFIG_NAME = "pids.config"
DEVICES_JSON_NAME = "devices.json"          # the plugin's allocation record

# GPU side of Allocate: the NVIDIA container runtime picks the cards named
# here (UUIDs); the dynamic linker preloads what /etc/ld.so.preload names.
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
LD_SO_PRELOAD = "/etc/ld.so.preload"
LD_SO_PRELOAD_NAME = "ld.so.preload"        # the host file, under base dir
NVIDIA_CONTROL_DEVICES = ("/dev/nvidiactl", "/dev/nvidia-uvm")

# --- The DRA kubelet plugin's names -----------------------------------------
# The JAX package's (`util/consts.py:455-456, 586`; the claim variables of
# `kubeletplugin/device_state.py:166, 303`): ResourceSlices and claims name
# the driver, and the runtime hook reads the claim variables.
DRA_DRIVER_NAME = "vtpu.resource.google.com"
ENV_CLAIM_UID = "VTPU_CLAIM_UID"
ENV_CLAIM_REQUEST = "VTPU_CLAIM_REQUEST"     # a multi-request claim's request
ENV_REGISTER_UUID = "VTPU_REGISTER_UUID"     # ClientMode's registry match
ENV_OBS_EXCESS_TABLE = "VTPU_OBS_EXCESS_TABLE"

# --- The node exporter's names ----------------------------------------------
# The JAX package's (`util/consts.py:525, 538`): the span spools it serves
# on /traces (which the device plugin also mounts into a traced tenant) and
# the compile cache whose counters close every scrape.
TRACE_DIR = f"{MANAGER_BASE_DIR}/trace"
COMPILE_CACHE_SUBDIR = "compilecache"
COMPILE_CACHE_DIR = f"{MANAGER_BASE_DIR}/{COMPILE_CACHE_SUBDIR}"
# the advertiser's fan-in of the other nodes' warm keys, under the cache
# root, which in-container fetchers read (`util/consts.py:544`)
CACHE_PEERS_NAME = "peers.json"

# --- The compile cache's tenant variables -----------------------------------
# The JAX package's (`util/consts.py:467-482`), so one plugin arms both
# kinds of tenant.
ENV_COMPILE_CACHE = "VTPU_COMPILE_CACHE"    # "true": node compile cache armed
ENV_COMPILE_CACHE_DIR = "VTPU_COMPILE_CACHE_DIR"  # in-container cache dir
# "true": the miss path fetches a warm peer's entry before compiling
ENV_CLUSTER_CACHE = "VTPU_CLUSTER_CACHE"
# the bearer token the fetcher shows a peer exporter's /cache/entry
ENV_CACHE_PEER_TOKEN = "VTPU_CACHE_PEER_TOKEN"
# the tenant's program fingerprint: the marker the advertiser publishes
ENV_PROGRAM_FINGERPRINT = "VTPU_PROGRAM_FINGERPRINT"
# Inductor's and Triton's own cache directories, which the runtime client
# points under the mount when the cache is armed
ENV_INDUCTOR_CACHE_DIR = "TORCHINDUCTOR_CACHE_DIR"
ENV_TRITON_CACHE_DIR = "TRITON_CACHE_DIR"
