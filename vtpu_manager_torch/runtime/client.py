"""The tenant's runtime client: what it is held to, how to hold it, its
step telemetry and its compile cache.

Ports `vtpu_manager/runtime/client.py` (`EffectiveLimits:43`,
`_ensure_tenant_trace:49`, `_env_limits:67`, `effective_limits:95`,
`install:113`, the compile cache's arming `_arm_jax_compile_cache:134`,
the step telemetry of `:206-379`, `compile_cache:377-438` and
`mark_first_execute:444`, and CLIENT mode's `register_client:151` and
`main:459`). The limits come from the
container's `vtpu.config` first and the environment second, the order the
interposer reads them in (`csrc/shim/loader.cc`).

When the device plugin armed the node compile cache
(`VTPU_COMPILE_CACHE=true`), `install` points Inductor's and Triton's own
cache directories under the mount unless the tenant set them, so a tenant
that never calls this client still reuses what its neighbours compiled;
`compile_cache()` is the store itself, for a tenant that shares its
compile explicitly (`workloads/compiled_step.py`).

A tenant has no feature gates: the trace id its Allocate response carries
(`VTPU_TRACE_ID`, with `VTPU_TRACE_SAMPLED=true`) turns its tracing on, and
its spans spool to `VTPU_TRACE_DIR`, else the node trace dir the plugin
mounted. `install` records the `shim.install` event and
`mark_first_execute` the `shim.first_execute` event, which a tenant calls
right before the first call of its step.

In CLIENT compat mode the interposer starts this module as the tenant's
device client (`python3 -m vtpu_manager_torch.runtime.client`, or
`VTPU_DEVICE_CLIENT_CMD`): `main` registers the container with the node
registry over `VTPU_REGISTRY_SOCKET`, the `shim.register` span of a
traced tenant, so that the node writes the container's pid set.

The JAX client could swap the PJRT plugin path inside the running process
before JAX loaded it. A CUDA driver interposer is loaded by the dynamic
linker, which reads LD_PRELOAD only at exec, so `install` returns the
environment a tenant subprocess needs instead, and sets it on this process
only when asked (for the children it will start).
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import socket
import struct
from dataclasses import dataclass

from vtpu_manager_torch import trace
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.util import consts


@dataclass
class EffectiveLimits:
    devices: list[vc.DeviceConfig]
    compat_mode: int
    source: str              # "config-file" | "env" | "none"


def _ensure_tenant_trace() -> None:
    """Turns tracing on from the environment at first use. The trace id
    is the gate (only pods admitted under Tracing carry one); an
    unsampled tenant never configures: no recorder, no spool file."""
    if trace.is_enabled():
        return
    if not os.environ.get(consts.ENV_TRACE_ID):
        return
    if os.environ.get(consts.ENV_TRACE_SAMPLED, "true") != "true":
        return
    trace.configure("tenant",
                    spool_dir=os.environ.get(consts.ENV_TRACE_DIR)
                    or consts.TRACE_DIR)


def _env_limits() -> EffectiveLimits | None:
    if not (os.environ.get(consts.ENV_MEM_LIMIT)
            or os.environ.get(f"{consts.ENV_MEM_LIMIT}_0")
            or os.environ.get(consts.ENV_CORE_LIMIT)
            or os.environ.get(f"{consts.ENV_CORE_LIMIT}_0")):
        return None
    visible = os.environ.get(consts.ENV_VISIBLE_DEVICES, "0")
    indices = [int(v) for v in visible.split(",") if v.strip() != ""]

    def env_int(base: str, i: int, default: int) -> int:
        raw = os.environ.get(f"{base}_{i}", os.environ.get(base))
        return int(raw) if raw else default

    devices = []
    for i, host_index in enumerate(indices):
        mem = env_int(consts.ENV_MEM_LIMIT, i, 0)
        core = env_int(consts.ENV_CORE_LIMIT, i, 0)
        soft = env_int(consts.ENV_CORE_SOFT_LIMIT, i, core)
        limit = (consts.CORE_LIMIT_NONE if core <= 0 else
                 consts.CORE_LIMIT_SOFT if soft > core else
                 consts.CORE_LIMIT_HARD)
        devices.append(vc.DeviceConfig(
            uuid=f"env-{host_index}", total_memory=mem, real_memory=mem,
            hard_core=core, soft_core=soft, core_limit=limit,
            memory_limit=mem > 0, host_index=host_index))
    compat = int(os.environ.get(consts.ENV_COMPAT_MODE, consts.COMPAT_HOST))
    return EffectiveLimits(devices=devices, compat_mode=compat, source="env")


def effective_limits(config_path: str | None = None) -> EffectiveLimits:
    """What the interposer will enforce for this process: the config file
    (`VTPU_CONFIG_PATH`, else the node's default path) when it reads and
    validates, else the environment."""
    if os.environ.get(consts.ENV_DISABLE_CONTROL):
        return EffectiveLimits([], 0, "none")
    path = config_path or os.environ.get(consts.ENV_CONFIG_PATH,
                                         consts.CONTAINER_CONFIG)
    try:
        cfg = vc.read_config(path)
        return EffectiveLimits(devices=cfg.devices,
                               compat_mode=cfg.compat_mode,
                               source="config-file")
    except (OSError, ValueError):
        pass
    env = _env_limits()
    return env if env is not None else EffectiveLimits([], 0, "none")


def install(shim_path: str | None = None,
            real_cuda_path: str | None = None,
            apply: bool = False) -> dict[str, str] | None:
    """The environment that preloads the interposer into a tenant process:
    LD_PRELOAD with the interposer first, and the real driver's path when
    one is known. None when the interposer is missing. With `apply`, also
    set it on os.environ, which reaches only processes started afterwards,
    every one of them, compilers included: prefer passing the returned
    mapping to the tenant's own subprocess."""
    # the cache needs no interposer: a container's dynamic linker loads
    # that from /etc/ld.so.preload whether or not this finds it
    _arm_torch_compile_cache()
    shim = shim_path or os.environ.get(consts.ENV_SHIM_PATH) or os.path.join(
        consts.DRIVER_DIR, consts.CONTROL_LIBRARY_NAME)
    if not os.path.exists(shim):
        return None
    preload = [shim] + [p for p in os.environ.get(
        consts.ENV_LD_PRELOAD, "").split(":") if p and p != shim]
    env = {consts.ENV_LD_PRELOAD: ":".join(preload)}
    real = real_cuda_path or os.environ.get(consts.ENV_REAL_CUDA_LIBRARY_PATH)
    if real:
        env[consts.ENV_REAL_CUDA_LIBRARY_PATH] = real
    if apply:
        os.environ.update(env)
    _ensure_tenant_trace()
    trace.event(trace.context_from_env(), "shim.install", shim=shim)
    return env


def _compile_cache_root() -> str:
    return os.environ.get(consts.ENV_COMPILE_CACHE_DIR) or \
        consts.COMPILE_CACHE_DIR


def _arm_torch_compile_cache() -> None:
    """With the cache armed, Inductor's and Triton's cache directories
    default to `inductor/` and `triton/` under the mount; a directory the
    tenant or its operator set stays."""
    if os.environ.get(consts.ENV_COMPILE_CACHE) != "true":
        return
    root = _compile_cache_root()
    os.environ.setdefault(consts.ENV_INDUCTOR_CACHE_DIR,
                          os.path.join(root, "inductor"))
    os.environ.setdefault(consts.ENV_TRITON_CACHE_DIR,
                          os.path.join(root, "triton"))


def _interposer_counter(symbol: str, signed: bool = False):
    """A ctypes accessor for one of the interposer's cumulative counters
    (`signed`: an int64 one), or None in a process without it. The dynamic
    linker preloads the interposer (LD_PRELOAD or /etc/ld.so.preload) into
    the global scope, so the lookup goes there: the live counter of this
    very process."""
    try:
        fn = getattr(ctypes.CDLL(None), symbol)
    except (OSError, AttributeError):
        return None
    fn.restype = ctypes.c_int64 if signed else ctypes.c_uint64
    fn.argtypes = []
    fn()     # a broken export fails here, not at every step
    return fn


def _interposer_comm_sources():
    """(comm time ns, bytes, collectives) total accessors of the
    interposer (JAX `runtime/client.py:211 _shim_comm_sources`), or None
    when CommTelemetry did not arm this container or the interposer lacks
    the exports: the ring's comm block then stays zeros. All three or
    none, so that a record's comm fields never disagree."""
    if os.environ.get(consts.ENV_COMM_TELEMETRY) != "true":
        return None
    fns = tuple(_interposer_counter(sym) for sym in
                ("vtpu_comm_time_ns_total", "vtpu_comm_bytes_total",
                 "vtpu_collectives_total"))
    return fns if all(fns) else None


def _interposer_spill_fill_source():
    """The interposer's total time in its host overflow tier
    (`vtpu_spill_fill_ns_total`, JAX `runtime/client.py:225
    _shim_spill_fill_source`), or None when HBMOvercommit did not arm this
    container's pool or the interposer lacks the export: the record's
    spill_fill_time_ns then stays 0."""
    if not os.environ.get(consts.ENV_SPILL_POOL_DIR):
        return None
    return _interposer_counter("vtpu_spill_fill_ns_total")


class _ShimWaitStepRing:
    """A StepRingWriter that charges each record the interposer's token
    wait since the previous record (`vtpu_throttle_wait_ns_total`): the
    wait hides inside the step's launches, where the step loop cannot see
    it. A step the interposer charged (`charged_fn`,
    `vtpu_charged_ns_total`: a metered tenant's) records its time off the
    card instead, its duration less the device time charged since the
    previous record, as the interposer's own records take it
    (`csrc/shim/enforce_rate.cc CloseStepLocked`): a launch waits in the
    bucket while the step's earlier kernels still run, and a kernel waits
    behind co-tenants' time slices, so the bucket's wait read against the
    duration says nothing of the card time the step took; that record
    carries the bucket's wait apart (`bucket_wait_ns`). A caller's
    explicit throttle_wait_ns is kept. With CommTelemetry's
    counters (`comm_fns`), each record also gets the copies and
    collectives the interposer measured since the previous one, and with
    the overflow tier's (`spill_fill_fn`) the time it spent there, as the
    JAX writer charges them (`runtime/client.py:243-310`)."""

    __slots__ = ("ring", "_wait_total_fn", "_last_wait_ns", "_comm_fns",
                 "_last_comm", "_spill_fill_fn", "_last_spill_fill_ns",
                 "_charged_fn", "_last_charged_ns")

    def __init__(self, ring, wait_total_fn, comm_fns=None,
                 spill_fill_fn=None, charged_fn=None):
        self.ring = ring
        self._wait_total_fn = wait_total_fn
        self._last_wait_ns = int(wait_total_fn())
        self._charged_fn = charged_fn
        self._last_charged_ns = int(charged_fn()) if charged_fn else 0
        self._comm_fns = comm_fns
        self._last_comm = tuple(int(fn()) for fn in comm_fns) \
            if comm_fns else (0, 0, 0)
        self._spill_fill_fn = spill_fill_fn
        self._last_spill_fill_ns = int(spill_fill_fn()) \
            if spill_fill_fn else 0

    @property
    def writes(self) -> int:
        return self.ring.writes

    def _comm_deltas(self) -> tuple[int, int, int]:
        if not self._comm_fns:
            return 0, 0, 0
        totals = tuple(int(fn()) for fn in self._comm_fns)
        # a reloaded interposer starts again at 0: re-baseline
        deltas = tuple(max(0, t - last)
                       for t, last in zip(totals, self._last_comm))
        self._last_comm = totals
        return deltas

    def record(self, duration_ns: int, throttle_wait_ns: int | None = None,
               hbm_highwater_bytes: int = 0, compiled: bool = False,
               start_mono_ns: int | None = None) -> None:
        on_card = None
        if self._charged_fn is not None:
            charged = int(self._charged_fn())
            on_card = max(0, charged - self._last_charged_ns)
            self._last_charged_ns = charged
        bucket_wait_ns = None
        if throttle_wait_ns is None:
            total = int(self._wait_total_fn())
            # a reloaded interposer starts again at 0: a negative delta
            # re-baselines and never reaches the ring
            throttle_wait_ns = max(0, total - self._last_wait_ns)
            self._last_wait_ns = total
            if on_card:
                bucket_wait_ns = throttle_wait_ns
                throttle_wait_ns = max(0, duration_ns - on_card)
        comm_ns, comm_bytes, collectives = self._comm_deltas()
        spill_fill_ns = 0
        if self._spill_fill_fn is not None:
            total = int(self._spill_fill_fn())
            spill_fill_ns = max(0, total - self._last_spill_fill_ns)
            self._last_spill_fill_ns = total
        self.ring.record(duration_ns, throttle_wait_ns=throttle_wait_ns,
                         hbm_highwater_bytes=hbm_highwater_bytes,
                         compiled=compiled, start_mono_ns=start_mono_ns,
                         comm_time_ns=comm_ns, bytes_transferred=comm_bytes,
                         collective_count=collectives,
                         spill_fill_time_ns=spill_fill_ns,
                         bucket_wait_ns=bucket_wait_ns)

    def close(self) -> None:
        self.ring.close()


_step_telemetry = None
_step_telemetry_checked = False


def _take_ring_from_interposer() -> None:
    """The interposer writes the ring itself for a tenant whose step loop
    does not (`csrc/shim/enforce_rate.cc`, "Steps"), from its first launch
    on. A Python writer takes over: the interposer's writer closes, which
    drops the ring's lock, and stays closed; the Python writer continues
    the ring's index. Without the interposer, nothing to do."""
    try:
        release = ctypes.CDLL(None).vtpu_step_ring_release
    except (OSError, AttributeError):
        return
    release.restype = ctypes.c_int
    release.argtypes = []
    release()


def step_telemetry():
    """The tenant's step-ring writer, or None when the device plugin did
    not arm StepTelemetry for this container. After the first call this is
    one global load and a branch: no environment read, no import, no file.
    A broken telemetry mount means no telemetry, never a broken step loop."""
    global _step_telemetry, _step_telemetry_checked
    if _step_telemetry_checked:
        return _step_telemetry
    _step_telemetry_checked = True
    if os.environ.get(consts.ENV_STEP_TELEMETRY) != "true":
        return None
    from vtpu_manager_torch.telemetry import stepring
    path = os.environ.get(consts.ENV_STEP_RING_PATH) or os.path.join(
        consts.MANAGER_BASE_DIR, consts.TELEMETRY_SUBDIR,
        consts.STEP_RING_NAME)
    _take_ring_from_interposer()
    try:
        _step_telemetry = stepring.StepRingWriter(
            path, trace_id=os.environ.get(consts.ENV_TRACE_ID, ""))
        wait_fn = _interposer_counter("vtpu_throttle_wait_ns_total")
        if wait_fn is not None:
            _step_telemetry = _ShimWaitStepRing(
                _step_telemetry, wait_fn, comm_fns=_interposer_comm_sources(),
                spill_fill_fn=_interposer_spill_fill_source(),
                charged_fn=_interposer_counter("vtpu_charged_ns_total",
                                               signed=True))
        import atexit
        atexit.register(_step_telemetry.close)
    except (OSError, ValueError) as e:
        logging.getLogger(__name__).warning(
            "step telemetry unavailable at %s (%s); running untelemetered",
            path, e)
        _step_telemetry = None
    return _step_telemetry


def _reset_step_telemetry() -> None:
    """For tests: drop the cached writer, so the next step_telemetry()
    reads the environment again."""
    global _step_telemetry, _step_telemetry_checked
    if _step_telemetry is not None:
        _step_telemetry.close()
    _step_telemetry = None
    _step_telemetry_checked = False


_compile_cache = None
_compile_cache_checked = False


def compile_cache():
    """The tenant's node compile cache (`compilecache.CompileCache` on the
    mount), or None when the device plugin did not arm CompileCache for
    this container. After the first call this is one global load and a
    branch: no environment read, no import, no file. A broken mount means
    compiling uncached, never a failed tenant.

        cc = compile_cache()
        if cc is not None:
            payload, outcome = cc.get_or_compile(
                key, compile_fn, ctx=trace.context_from_env())

    With `VTPU_CLUSTER_CACHE=true` (JAX `runtime/client.py:407-420`) it
    is a `clustercache.ClusterCompileCache` on the same store, whose miss
    fetches a warm peer's entry (from the `peers.json` the device plugin's
    advertiser keeps under the mount) before compiling, and whose
    `get_or_compile(..., fingerprint=...)` leaves the `fps/` marker the
    advertiser publishes."""
    global _compile_cache, _compile_cache_checked
    if _compile_cache_checked:
        return _compile_cache
    _compile_cache_checked = True
    if os.environ.get(consts.ENV_COMPILE_CACHE) != "true":
        return None
    root = _compile_cache_root()
    if os.environ.get(consts.ENV_CLUSTER_CACHE) == "true":
        from vtpu_manager_torch.clustercache import ClusterCompileCache as cls
    else:
        from vtpu_manager_torch.compilecache import CompileCache as cls
    try:
        _compile_cache = cls(root)
    except OSError as e:
        logging.getLogger(__name__).warning(
            "compile cache unavailable at %s (%s); compiling uncached",
            root, e)
        _compile_cache = None
    return _compile_cache


def _reset_compile_cache() -> None:
    """For tests: drop the cached client, so the next compile_cache() reads
    the environment again."""
    global _compile_cache, _compile_cache_checked
    if _compile_cache is not None:
        _compile_cache.close()
    _compile_cache = None
    _compile_cache_checked = False


_first_execute_marked = False


def mark_first_execute() -> None:
    """Records the tenant's first-execute moment, once: the timeline's
    last stage. The interposer cannot see a step begin, so the tenant
    calls this right before the first call of its step."""
    global _first_execute_marked
    if _first_execute_marked:
        return
    _first_execute_marked = True
    _ensure_tenant_trace()
    trace.event(trace.context_from_env(), "shim.first_execute",
                pid=os.getpid())


def register_client(timeout_s: float = 5.0) -> bool:
    """CLIENT mode: announces this container to the node registry, which
    attests the caller's pid by SO_PEERCRED and writes the container's pid
    set; this side only presents the pod identity Allocate set. True when
    the registry accepted it."""
    path = os.environ.get(consts.ENV_REGISTRY_SOCKET, consts.REGISTRY_SOCKET)
    if not os.path.exists(path):
        return False
    payload = json.dumps({
        "pod_name": os.environ.get(consts.ENV_POD_NAME, ""),
        "pod_namespace": os.environ.get(consts.ENV_POD_NAMESPACE, ""),
        "pod_uid": os.environ.get(consts.ENV_POD_UID, ""),
        "container": os.environ.get(consts.ENV_CONTAINER_NAME, ""),
        "register_uuid": os.environ.get(consts.ENV_REGISTER_UUID, ""),
    }).encode()
    # paired with the node's registry.register span, the difference is
    # the socket's queueing
    _ensure_tenant_trace()
    with trace.span(trace.context_from_env(), "shim.register"):
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
                sock.settimeout(timeout_s)
                sock.connect(path)
                sock.sendall(struct.pack("<I", len(payload)) + payload)
                raw = sock.recv(4)
                if len(raw) < 4:
                    return False
                (status,) = struct.unpack("<i", raw)
                return status == 0
        except OSError:
            return False


def main() -> int:
    """The device client the interposer starts in CLIENT mode; exit 0 when
    the registration was accepted."""
    import sys
    ok = register_client()
    print(f"vtpu device-client: registration "
          f"{'succeeded' if ok else 'FAILED'}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
