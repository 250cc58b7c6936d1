"""The vtpu-number plugin: how a pod the scheduler committed gets its slice.

The port of the JAX package's `deviceplugin/vnum.py:53-694`:

- ListAndWatch advertises `split_count` slots per device and advertises
  again when a device's health flips;
- GetPreferredAllocation follows the scheduler's pre-allocation;
- Allocate finds the pod the scheduler committed to the devices kubelet
  chose, answers with the container's environment, device nodes and
  mounts, writes its `vtpu.config` with the port's writer, records the
  allocation and patches the pod `succeed` with its real-allocated claims
  (or `failed`, and the RPC fails, when any of that fails);
- PreStartContainer checks the devices against the record and writes the
  config file again when it was lost.

What changes for CUDA: the container runtime picks the cards named by
`NVIDIA_VISIBLE_DEVICES` (the claims' UUIDs); the device nodes are
`/dev/nvidia<minor>`, `/dev/nvidiactl` and `/dev/nvidia-uvm`; the
interposer is loaded by the dynamic linker from a host file the plugin
writes (`<base_dir>/ld.so.preload`, mounted read-only at
`/etc/ld.so.preload`, naming the interposer under the driver mount), and
forwards to the card's driver at `VTPU_REAL_CUDA_LIBRARY_PATH`.

Gates: HonorPreAllocatedDeviceIDs (`preferred_allocation_available`),
StepTelemetry (`step_telemetry_enabled`) and CompileCache
(`compile_cache_enabled`, `vnum.py:436-449, 471-482, 525-536`): the node's
compile cache dir `<base_dir>/compilecache` is made first, and only when
it exists does the config name it (`compile_cache_dir`), is it mounted
read-write at the same container path for every tenant, and do
`VTPU_COMPILE_CACHE` / `VTPU_COMPILE_CACHE_DIR` arm the runtime client;
ClusterCompileCache (`cluster_cache_enabled`, `vnum.py:61, 537-543`) adds
`VTPU_CLUSTER_CACHE=true` only on top of that mounted node cache.
CommTelemetry (`comm_telemetry_enabled`, `vnum.py:560-567`) adds
`VTPU_COMM_TELEMETRY=true` only beside the ring's env: the ring is the
wire.
Tracing (`vnum.py:256-258, 424-431, 462, 511-523`): once
`trace.configure` ran, Allocate records the `plugin.allocate` span and,
inside it, `plugin.config`, for a pod whose annotations carry a trace id;
the response carries `VTPU_TRACE_ID` and `VTPU_TRACE_SAMPLED` for such a
pod, and for a sampled one also the node trace dir `consts.TRACE_DIR`,
mounted read-write at the same path, where the tenant spools its own
spans. QuotaMarket (`vnum.py:451-461`) stamps the pod's workload class.
HBMOvercommit (`vnum.py:358-410, 458, 496-510`) stamps each device's
virtual capacity (its memory times the current ratio of the pod's class,
from the node's policy; 1.0 when the policy's fold fails) and the node's
spill budget, stamps the class too, and makes the host pool's dir under the
ledger's host dir; only once it exists does `VTPU_SPILL_POOL_DIR` arm the
interposer's overflow tier. The link share (ICILinkAware) is not ported;
its config field is written as the JAX package writes it with the gate
off. Allocate fires the JAX plugin's
failpoints where it fires them: `plugin.allocate` inside the span, before
the response is built; `plugin.config_write` right after `vtpu.config` is
written (a partial-write tears it, and the crash fails the RPC: the
kubelet's retried Allocate writes it whole again); and
`plugin.record_devices` after the records file is written.

The node's shared directories (locks, memory ledger, watcher feed) default
to the node's fixed paths and are arguments, so a run from a checkout can
keep a node of its own.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from collections import Counter

from vtpu_manager_torch import quota, trace
from vtpu_manager_torch.client.kube import KubeClient, KubeError
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.device.claims import (DeviceClaim, PodDeviceClaims,
                                              try_decode)
from vtpu_manager_torch.device.types import ChipSpec
from vtpu_manager_torch.deviceplugin.api import messages as api
from vtpu_manager_torch.deviceplugin.base import DevicePluginServicer
from vtpu_manager_torch.manager.device_manager import DeviceManager
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.resilience.policy import RetryPolicy
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)

COMPAT_BITS = {"host": consts.COMPAT_HOST, "cgroup": consts.COMPAT_CGROUP,
               "client": consts.COMPAT_CLIENT,
               "open-kernel": consts.COMPAT_OPEN_KERNEL}

# what the dynamic linker resolves in the container; the interposer's own
# default when the variable is unset
DEFAULT_REAL_LIBCUDA = "libcuda.so.1"

# one Allocate can cross this policy three times (pod list, succeed patch,
# failed patch): the sum must fit inside kubelet's deadline, or a late
# "succeed" could land on an abandoned RPC
_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.05, deadline_s=2.0)


def device_id(uuid: str, slot: int) -> str:
    return f"{uuid}::{slot}"


def device_uuid(dev_id: str) -> str:
    return dev_id.split("::", 1)[0]


def interposer_container_path() -> str:
    return os.path.join(consts.DRIVER_DIR, consts.CONTROL_LIBRARY_NAME)


def install_interposer(src: str, driver_dir: str) -> str:
    """Copies the built interposer into the node's driver directory under
    the name the preload file gives it, and beside it CLIENT mode's
    stdlib-only registrar (the one beside `src`, else the package's); each
    atomic, since a tenant may be loading the old one."""
    os.makedirs(driver_dir, exist_ok=True)
    registrar = os.path.join(os.path.dirname(src),
                             consts.DEVICE_CLIENT_SCRIPT)
    if not os.path.exists(registrar):
        registrar = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", consts.DEVICE_CLIENT_SCRIPT)
    for source, name in ((registrar, consts.DEVICE_CLIENT_SCRIPT),
                         (src, consts.CONTROL_LIBRARY_NAME)):
        dst = os.path.join(driver_dir, name)
        tmp = f"{dst}.tmp.{os.getpid()}"
        shutil.copy2(source, tmp)
        os.replace(tmp, dst)
    return dst


def _write_atomic(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def preload_file(base_dir: str) -> str:
    """The host file mounted at /etc/ld.so.preload, `<base_dir>/ld.so.preload`:
    one line, the interposer's path in the container. Written when missing
    or different."""
    path = os.path.join(base_dir, consts.LD_SO_PRELOAD_NAME)
    want = interposer_container_path() + "\n"
    try:
        with open(path) as f:
            current = f.read()
    except OSError:
        current = None
    if current != want:
        _write_atomic(path, want)
    return path


class VnumPlugin(DevicePluginServicer):
    pre_start_required = True
    preferred_allocation_available = False   # gated: HonorPreAllocatedDeviceIDs
    step_telemetry_enabled = False           # gated: StepTelemetry
    compile_cache_enabled = False            # gated: CompileCache
    cluster_cache_enabled = False            # gated: ClusterCompileCache
    comm_telemetry_enabled = False           # gated: CommTelemetry
    quota_market_enabled = False             # gated: QuotaMarket
    hbm_overcommit_enabled = False           # gated: HBMOvercommit
    # HBMOvercommit: the node's policy (an OvercommitPolicy) whose current
    # per-class ratio gives each device its virtual capacity, and the
    # node's spill budget every device entry carries
    overcommit_policy = None
    spill_budget_bytes = 0

    def __init__(self, manager: DeviceManager, client: KubeClient,
                 node_name: str, node_config: NodeConfig | None = None,
                 base_dir: str = consts.MANAGER_BASE_DIR,
                 shim_host_dir: str = consts.DRIVER_DIR,
                 real_libcuda_path: str = DEFAULT_REAL_LIBCUDA,
                 lock_dir: str = consts.LOCK_DIR,
                 vmem_dir: str = consts.VMEM_DIR,
                 watcher_dir: str = consts.WATCHER_DIR):
        self.manager = manager
        self.client = client
        self.node_name = node_name
        self.node_config = node_config or NodeConfig()
        self.base_dir = base_dir
        self.shim_host_dir = shim_host_dir
        self.real_libcuda_path = real_libcuda_path
        self.lock_dir = lock_dir
        self.vmem_dir = vmem_dir
        self.watcher_dir = watcher_dir
        self.resource_name = consts.vtpu_number_resource()
        self.socket_name = "vtpu-number.sock"
        self._update = threading.Event()
        manager.on_unhealthy(lambda chip: self._update.set())
        self._served_lock = threading.Lock()
        self._served: set[tuple[str, str]] = set()   # (pod_uid, container)

    # -- advertisement --------------------------------------------------------

    def list_devices(self) -> list[api.Device]:
        out = []
        for chip in self.manager.chips:
            health = "Healthy" if chip.healthy else "Unhealthy"
            topo = api.TopologyInfo(nodes=[api.NUMANode(ID=chip.numa)])
            for slot in range(chip.split_count):
                out.append(api.Device(ID=device_id(chip.uuid, slot),
                                      health=health, topology=topo))
        return out

    def watch_devices(self):
        yield self.list_devices()
        while True:
            self._update.wait(timeout=10)
            self._update.clear()
            yield self.list_devices()

    # -- the pods the scheduler committed here --------------------------------

    def _pending_allocations(self) -> list[tuple[dict, str,
                                                 list[DeviceClaim]]]:
        """(pod, container, claims) for the containers the scheduler
        committed on this node and the plugin has not served yet.

        A bound pod carries nodeName; a pod bound a moment ago may carry
        only the predicate-node annotation. A pod stays pending for its
        container B after container A's Allocate patched the
        real-allocated annotation, which then covers A only.

        Raises KubeError when the pod list fails: no answer is not "no
        pending pods", which would serve a committed pod unenforced."""
        out = []
        all_pods = _POLICY.run(self.client.list_pods, op="plugin.list_pods")
        seen_uids: set[str] = set()
        pods = []
        for pod in all_pods:
            meta = pod.get("metadata") or {}
            uid = meta.get("uid", "")
            if uid in seen_uids:
                continue
            anns = meta.get("annotations") or {}
            if ((pod.get("spec") or {}).get("nodeName") == self.node_name
                    or anns.get(consts.predicate_node_annotation())
                    == self.node_name):
                seen_uids.add(uid)
                pods.append(pod)
        with self._served_lock:
            served = set(self._served)
        for pod in pods:
            meta = pod.get("metadata") or {}
            anns = meta.get("annotations") or {}
            pre = try_decode(anns.get(consts.pre_allocated_annotation()))
            if pre is None:
                continue
            real = try_decode(anns.get(consts.real_allocated_annotation()))
            done_containers = set(real.containers) if real else set()
            uid = meta.get("uid", "")
            for cont, cont_claims in pre.containers.items():
                if (cont_claims and cont not in done_containers
                        and (uid, cont) not in served):
                    out.append((pod, cont, cont_claims))
        return out

    # -- GetPreferredAllocation -----------------------------------------------

    def get_preferred_allocation(self, request: api.PreferredAllocationRequest
                                 ) -> api.PreferredAllocationResponse:
        resp = api.PreferredAllocationResponse()
        try:
            pending = self._pending_allocations()
        except KubeError:
            # only a hint: kubelet's own pick is still matched at Allocate
            log.warning("pod list failed; preferring without the "
                        "pre-allocations", exc_info=True)
            pending = []
        for creq in request.container_requests:
            available = list(creq.available_deviceIDs)
            preferred: list[str] = []
            for _, _, claims in pending:
                if len(claims) != creq.allocation_size:
                    continue
                picks = self._pick_ids_for_claims(claims, available)
                if picks is not None:
                    preferred = picks
                    break
            if not preferred:
                preferred = list(creq.must_include_deviceIDs)
                for dev in available:
                    if len(preferred) >= creq.allocation_size:
                        break
                    if dev not in preferred:
                        preferred.append(dev)
            resp.container_responses.append(
                api.ContainerPreferredAllocationResponse(
                    deviceIDs=preferred[: creq.allocation_size]))
        return resp

    @staticmethod
    def _pick_ids_for_claims(claims: list[DeviceClaim],
                             available: list[str]) -> list[str] | None:
        by_uuid: dict[str, list[str]] = {}
        for dev in available:
            by_uuid.setdefault(device_uuid(dev), []).append(dev)
        picks = []
        for claim in claims:
            pool = by_uuid.get(claim.uuid)
            if not pool:
                return None
            picks.append(pool.pop(0))
        return picks

    # -- Allocate -------------------------------------------------------------

    def allocate(self, request: api.AllocateRequest) -> api.AllocateResponse:
        resp = api.AllocateResponse()
        for creq in request.container_requests:
            resp.container_responses.append(
                self._allocate_container(list(creq.devicesIDs)))
        return resp

    def _match_container(self, dev_ids: list[str]
                         ) -> tuple[dict, str, list[DeviceClaim]] | None:
        want = Counter(device_uuid(d) for d in dev_ids)
        for pod, cont, claims in self._pending_allocations():
            if Counter(c.uuid for c in claims) == want:
                return (pod, cont, claims)
        return None

    def _allocate_container(self, dev_ids: list[str]
                            ) -> api.ContainerAllocateResponse:
        match = self._match_container(dev_ids)
        if match is None:
            # devices no scheduler commitment explains (the scheduler was
            # bypassed): served with no enforcement config, as the JAX
            # plugin serves them
            log.warning("allocate without matching pre-allocation: %s",
                        dev_ids)
            return self._response_for(None, "", [
                DeviceClaim(device_uuid(d), self._host_index(device_uuid(d)),
                            0, 0) for d in dev_ids])
        pod, cont, claims = match
        meta = pod.get("metadata") or {}
        uid = meta.get("uid", "")
        try:
            with trace.span(trace.context_for_pod(pod), "plugin.allocate",
                            container=cont, devices=len(dev_ids)):
                failpoints.fire("plugin.allocate", pod_uid=uid,
                                container=cont)
                response = self._response_for(pod, cont, claims)
                self._record_devices(uid, cont, dev_ids, claims)
                _POLICY.run(
                    lambda: self.client.patch_pod_annotations(
                        meta.get("namespace", "default"),
                        meta.get("name", ""), {
                            consts.real_allocated_annotation():
                                self._claims_annotation(pod, cont, claims),
                            consts.allocation_status_annotation():
                                consts.ALLOC_STATUS_SUCCEED}),
                    op="plugin.allocate_patch")
            with self._served_lock:
                self._served.add((uid, cont))
            return response
        except Exception:
            log.exception("allocate failed for %s/%s", uid, cont)
            try:
                _POLICY.run(
                    lambda: self.client.patch_pod_annotations(
                        meta.get("namespace", "default"),
                        meta.get("name", ""),
                        {consts.allocation_status_annotation():
                         consts.ALLOC_STATUS_FAILED}),
                    op="plugin.failed_patch")
            except KubeError:
                log.warning("failed-status patch did not land for %s/%s",
                            uid, cont, exc_info=True)
            raise

    def _claims_annotation(self, pod: dict, cont: str,
                           claims: list[DeviceClaim]) -> str:
        """This container merged into the real allocation only: seeding
        from the pre-allocation would make other containers' uncommitted
        claims real."""
        anns = (pod.get("metadata") or {}).get("annotations") or {}
        decoded = try_decode(anns.get(consts.real_allocated_annotation()))
        existing = decoded.copy() if decoded else PodDeviceClaims()
        existing.containers[cont] = claims
        return existing.encode()

    def _host_index(self, uuid: str) -> int:
        chip = self._chip(uuid)
        return chip.index if chip else 0

    def _chip(self, uuid: str) -> ChipSpec | None:
        for chip in self.manager.chips:
            if chip.uuid == uuid:
                return chip
        return None

    def spill_pool_host_dir(self) -> str:
        return os.path.join(self.vmem_dir,
                            os.path.relpath(consts.SPILL_DIR, consts.VMEM_DIR))

    def _overcommit_ratio(self, pod: dict | None) -> float:
        """The pod's class ratio from the node's current policy; 1.0 with
        the gate off, and when the policy's fold fails (this allocation is
        admitted at physical capacity, the safe direction)."""
        if not self.hbm_overcommit_enabled or pod is None:
            return 1.0
        from vtpu_manager_torch.overcommit import ratio
        oc = None
        if self.overcommit_policy is not None:
            try:
                oc = self.overcommit_policy.compute()
            except Exception:  # noqa: BLE001 - physical admission instead
                log.warning("overcommit policy compute failed; allocating "
                            "at physical capacity", exc_info=True)
        return ratio.ratio_for_class(oc, quota.workload_class_of(pod))

    def compile_cache_host_dir(self) -> str:
        return os.path.join(self.base_dir, consts.COMPILE_CACHE_SUBDIR)

    def _container_dir(self, pod_uid: str, cont: str) -> str:
        return os.path.join(self.base_dir, f"{pod_uid}_{cont}")

    def _response_for(self, pod: dict | None, cont: str,
                      claims: list[DeviceClaim]
                      ) -> api.ContainerAllocateResponse:
        resp = api.ContainerAllocateResponse()
        meta = (pod or {}).get("metadata") or {}
        anns = meta.get("annotations") or {}
        uid = meta.get("uid", "")
        compute_policy = anns.get(consts.compute_policy_annotation(),
                                  consts.COMPUTE_POLICY_FIXED)
        oversold = anns.get(consts.memory_oversold_annotation(), "") == "true"

        resp.envs[consts.ENV_VISIBLE_DEVICES] = ",".join(
            str(c.host_index) for c in claims)
        resp.envs[consts.ENV_NVIDIA_VISIBLE_DEVICES] = ",".join(
            c.uuid for c in claims)
        oc_ratio = self._overcommit_ratio(pod)
        devices = []
        for i, claim in enumerate(claims):
            if claim.memory:
                resp.envs[f"{consts.ENV_MEM_LIMIT}_{i}"] = str(claim.memory)
            if claim.cores:
                resp.envs[f"{consts.ENV_CORE_LIMIT}_{i}"] = str(claim.cores)
                soft = claim.cores
                core_limit = vc.CORE_LIMIT_HARD
                if compute_policy == consts.COMPUTE_POLICY_BALANCE:
                    soft = 100
                    core_limit = vc.CORE_LIMIT_SOFT
                    resp.envs[f"{consts.ENV_CORE_SOFT_LIMIT}_{i}"] = str(soft)
                elif compute_policy == consts.COMPUTE_POLICY_NONE:
                    core_limit = vc.CORE_LIMIT_NONE
            else:
                soft, core_limit = 0, vc.CORE_LIMIT_NONE
            chip = self._chip(claim.uuid)
            real_mem = chip.memory if chip else claim.memory
            devices.append(vc.DeviceConfig(
                uuid=claim.uuid, total_memory=claim.memory,
                real_memory=real_mem,
                hard_core=claim.cores, soft_core=soft, core_limit=core_limit,
                memory_limit=claim.memory > 0, memory_oversold=oversold,
                host_index=claim.host_index,
                mesh=chip.coords if chip else (0, 0, 0),
                # the device's virtual capacity and the node's budget
                # (zeros with the gate off)
                virtual_hbm_bytes=(int(real_mem * oc_ratio)
                                   if self.hbm_overcommit_enabled else 0),
                spill_budget_bytes=(self.spill_budget_bytes
                                    if self.hbm_overcommit_enabled else 0)))
            node = self.manager.device_node(claim.host_index)
            resp.devices.append(api.DeviceSpec(
                container_path=node, host_path=node, permissions="rw"))
        if claims:
            for node in consts.NVIDIA_CONTROL_DEVICES:
                resp.devices.append(api.DeviceSpec(
                    container_path=node, host_path=node, permissions="rw"))

        compat = COMPAT_BITS.get(self.node_config.compat_mode,
                                  consts.COMPAT_HOST)
        resp.envs[consts.ENV_COMPAT_MODE] = str(compat)
        resp.envs[consts.ENV_POD_NAME] = meta.get("name", "")
        resp.envs[consts.ENV_POD_NAMESPACE] = meta.get("namespace", "")
        resp.envs[consts.ENV_POD_UID] = uid
        resp.envs[consts.ENV_CONTAINER_NAME] = cont
        # the admission-minted context, and its sampling decision, reach
        # the tenant only through its environment
        ctx = trace.context_for_pod(pod) if pod is not None else None
        if ctx is not None and ctx.trace_id:
            resp.envs[consts.ENV_TRACE_ID] = ctx.trace_id
            resp.envs[consts.ENV_TRACE_SAMPLED] = \
                "true" if ctx.sampled else "false"

        if pod is None:
            return resp
        cont_dir = self._container_dir(uid, cont)
        config_host = os.path.join(cont_dir, "config")
        # the cache dir first: the config field, the mount and the env all
        # follow from whether it exists
        cc_host = self.compile_cache_host_dir()
        cc_ok = False
        if self.compile_cache_enabled:
            try:
                os.makedirs(cc_host, exist_ok=True)
                cc_ok = True
            except OSError as e:
                log.warning("compile cache dir %s unavailable (%s); tenant "
                            "%s/%s compiles uncached", cc_host, e, uid, cont)
        # the webhook-normalized workload class rides into the config, so
        # the interposer and the node's quota market agree on which side of
        # the market the tenant sits (`vnum.py:451-461`); gate off: 0, the
        # bytes the config carried before the market
        wl_class = vc.WORKLOAD_CLASS_NONE
        if self.quota_market_enabled or self.hbm_overcommit_enabled:
            wl_class = quota.workload_class_abi(quota.workload_class_of(pod))
        with trace.span(ctx, "plugin.config", container=cont,
                        devices=len(devices)):
            os.makedirs(config_host, exist_ok=True)
            cfg_path = os.path.join(config_host, "vtpu.config")
            vc.write_config(cfg_path, vc.VtpuConfig(
                pod_uid=uid, pod_name=meta.get("name", ""),
                pod_namespace=meta.get("namespace", ""),
                container_name=cont, compat_mode=compat,
                compile_cache_dir=consts.COMPILE_CACHE_DIR if cc_ok else "",
                workload_class=wl_class, devices=devices))
            # a partial-write tears the file just written: the state a
            # crash mid-write leaves, which the retried Allocate rewrites
            failpoints.fire("plugin.config_write", pod_uid=uid,
                            path=cfg_path)
        # mounts: the container's config, the interposer, the node's locks,
        # ledger, step ring and watcher feed, and the preload file
        resp.mounts.append(api.Mount(
            container_path=f"{consts.MANAGER_BASE_DIR}/config",
            host_path=config_host, read_only=True))
        resp.mounts.append(api.Mount(container_path=consts.DRIVER_DIR,
                                     host_path=self.shim_host_dir,
                                     read_only=True))
        for path, host in ((consts.LOCK_DIR, self.lock_dir),
                           (consts.VMEM_DIR, self.vmem_dir)):
            resp.mounts.append(api.Mount(container_path=path, host_path=host,
                                         read_only=False))
        if self.hbm_overcommit_enabled:
            # the host pool lives under the ledger's dir, mounted above;
            # the variable that arms the overflow tier only once it exists
            pool_host = self.spill_pool_host_dir()
            try:
                os.makedirs(pool_host, exist_ok=True)
                resp.envs[consts.ENV_SPILL_POOL_DIR] = consts.SPILL_DIR
            except OSError as e:
                log.warning("spill pool dir %s unavailable (%s); tenant "
                            "%s/%s runs without the host overflow tier",
                            pool_host, e, uid, cont)
        if ctx is not None and ctx.sampled:
            # the tenant's own spans spool into the node trace dir, at the
            # same path on both sides (the JAX plugin's mount)
            try:
                os.makedirs(consts.TRACE_DIR, exist_ok=True)
                resp.mounts.append(api.Mount(
                    container_path=consts.TRACE_DIR,
                    host_path=consts.TRACE_DIR, read_only=False))
            except OSError as e:
                log.warning("trace dir %s unavailable (%s); tenant spans "
                            "for %s/%s will not spool", consts.TRACE_DIR, e,
                            uid, cont)
        if cc_ok:
            # one cache for every tenant of the node: sharing is the point
            resp.mounts.append(api.Mount(
                container_path=consts.COMPILE_CACHE_DIR, host_path=cc_host,
                read_only=False))
            resp.envs[consts.ENV_COMPILE_CACHE] = "true"
            resp.envs[consts.ENV_COMPILE_CACHE_DIR] = consts.COMPILE_CACHE_DIR
            if self.cluster_cache_enabled:
                # the miss path then fetches from the peers.json the
                # advertiser keeps under the same mount
                resp.envs[consts.ENV_CLUSTER_CACHE] = "true"
        if self.step_telemetry_enabled:
            # the one writable surface under the container's config dir:
            # the tenant writes its step ring there, the node reads it by
            # its host path
            tel_host = os.path.join(cont_dir, consts.TELEMETRY_SUBDIR)
            tel_cont = os.path.join(consts.MANAGER_BASE_DIR,
                                    consts.TELEMETRY_SUBDIR)
            try:
                os.makedirs(tel_host, exist_ok=True)
                resp.mounts.append(api.Mount(container_path=tel_cont,
                                             host_path=tel_host,
                                             read_only=False))
                resp.envs[consts.ENV_STEP_TELEMETRY] = "true"
                resp.envs[consts.ENV_STEP_RING_PATH] = os.path.join(
                    tel_cont, consts.STEP_RING_NAME)
                if self.comm_telemetry_enabled:
                    # the interposer's copies and collectives into the
                    # ring's comm block
                    resp.envs[consts.ENV_COMM_TELEMETRY] = "true"
            except OSError as e:
                log.warning("telemetry dir %s unavailable (%s); tenant "
                            "%s/%s runs untelemetered", tel_host, e, uid,
                            cont)
        resp.mounts.append(api.Mount(container_path=consts.WATCHER_DIR,
                                     host_path=self.watcher_dir,
                                     read_only=True))
        if compat & consts.COMPAT_CLIENT:
            resp.mounts.append(api.Mount(container_path=consts.REGISTRY_DIR,
                                         host_path=consts.REGISTRY_DIR,
                                         read_only=False))
        resp.mounts.append(api.Mount(container_path=consts.LD_SO_PRELOAD,
                                     host_path=preload_file(self.base_dir),
                                     read_only=True))
        resp.envs[consts.ENV_REAL_CUDA_LIBRARY_PATH] = self.real_libcuda_path
        resp.envs[consts.ENV_CONFIG_PATH] = consts.CONTAINER_CONFIG
        if self.manager.obs_excess_table is not None:
            # the node's calibrated excess table: the interposer discounts
            # an isolated sample by it in place of its own probe
            # (manager/obs_calibrate.py)
            resp.envs[consts.ENV_OBS_EXCESS_TABLE] = \
                self.manager.obs_excess_table
        return resp

    # -- records and PreStartContainer ----------------------------------------

    def _records_path(self) -> str:
        return os.path.join(self.base_dir, consts.DEVICES_JSON_NAME)

    def _read_records(self) -> dict:
        try:
            with open(self._records_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def _record_devices(self, pod_uid: str, cont: str, dev_ids: list[str],
                        claims: list[DeviceClaim]) -> None:
        # records older than a week are dropped: a stale record must not
        # shadow a new tenant's at PreStartContainer. The clock is this
        # node's own on both sides.
        cutoff = time.time() - 7 * 24 * 3600
        records = {k: v for k, v in self._read_records().items()
                   if v.get("ts", 0) >= cutoff}
        records[f"{pod_uid}/{cont}"] = {
            "devices": dev_ids,
            "claims": [c.to_wire() for c in claims],
            "ts": time.time(),
        }
        path = self._records_path()
        _write_atomic(path, json.dumps(records))
        failpoints.fire("plugin.record_devices", pod_uid=pod_uid, path=path)

    def pre_start_container(self, request: api.PreStartContainerRequest
                            ) -> api.PreStartContainerResponse:
        """Checks that the devices belong to a recorded allocation and that
        its config file exists, writing it again from the record if the
        Allocate-time write was lost."""
        dev_ids = list(request.devicesIDs)
        want = Counter(device_uuid(d) for d in dev_ids)
        ordered = sorted(self._read_records().items(),
                         key=lambda kv: kv[1].get("ts", 0), reverse=True)
        # exact device ids only (slots included), newest first: a match by
        # device uuid alone could pick a previous tenant's record
        exact = [kv for kv in ordered
                 if sorted(kv[1].get("devices", [])) == sorted(dev_ids)]
        if not exact and ordered:
            log.error("prestart: devices %s match no record exactly; %d "
                      "records exist", dev_ids, len(ordered))
        for key, rec in exact:
            claims = [DeviceClaim.from_wire(c) for c in rec.get("claims", [])]
            if Counter(c.uuid for c in claims) != want:
                continue
            pod_uid, _, cont = key.partition("/")
            config_dir = os.path.join(self._container_dir(pod_uid, cont),
                                      "config")
            cfg_path = os.path.join(config_dir, "vtpu.config")
            if not os.path.exists(cfg_path):
                log.warning("config missing at prestart; rewriting %s",
                            cfg_path)
                os.makedirs(config_dir, exist_ok=True)
                devices = []
                for claim in claims:
                    chip = self._chip(claim.uuid)
                    devices.append(vc.DeviceConfig(
                        uuid=claim.uuid, total_memory=claim.memory,
                        real_memory=chip.memory if chip else claim.memory,
                        hard_core=claim.cores, soft_core=claim.cores,
                        core_limit=vc.CORE_LIMIT_HARD if claim.cores
                        else vc.CORE_LIMIT_NONE,
                        memory_limit=claim.memory > 0,
                        host_index=claim.host_index))
                vc.write_config(cfg_path, vc.VtpuConfig(
                    pod_uid=pod_uid, container_name=cont, devices=devices))
            # a previous tenant's per-container state
            pids_cfg = os.path.join(config_dir, consts.PIDS_CONFIG_NAME)
            if os.path.exists(pids_cfg):
                try:
                    os.unlink(pids_cfg)
                except OSError:
                    pass
            return api.PreStartContainerResponse()
        raise RuntimeError(
            f"prestart devices {dev_ids} match no recorded allocation")
