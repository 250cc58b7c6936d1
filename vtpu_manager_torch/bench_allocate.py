"""The device plugin hands slices of one card to tenants: the checks of
chip_smoke.py's `allocate` phase.

The phase plays kubelet and the container runtime around the port's own
node agent, on a node directory of its own (plugin base dir, locks,
memory ledger, watcher feed, driver dir), with the node's watcher fed by
NVML running as in the `co_tenancy` phase:

- kubelet: `VnumPlugin.allocate` and `pre_start_container` are called
  directly with the messages of `deviceplugin/api/messages.py` (the card
  machine has no grpc);
- the container runtime: `container_env` is the one place that stands in
  for bind mounts and the runtime's device selection. A tenant gets the
  response's environment with every value under a mount's container
  path rewritten to the mount's host path, the node paths (config, ring,
  locks, ledger, feed) pointed at the host side of their mounts,
  LD_PRELOAD read from the host file mounted at /etc/ld.so.preload, and
  CUDA_VISIBLE_DEVICES set to NVIDIA_VISIBLE_DEVICES's UUIDs,
  VTPU_SHIM_PATH at the interposer under the driver mount, and
  VTPU_TRACE_DIR at the node trace dir when it is mounted. No
  VTPU_*_LIMIT variable, and no config file but the plugin's.

Checks, each a record with an `ok` verdict:

1. registry: the device manager over NVML (split 4) registers the node;
   the annotation decodes to the card NVML and torch see (UUID, name,
   usable memory, SMs) and the plugin advertises 4 healthy slots;
2. allocate: pods the scheduler committed (A at 50 % and 16 GiB, B at
   25 % and 8 GiB, both with StepTelemetry; C unmetered at 8 GiB without
   it; D unmetered at 8 GiB with it) are allocated through the plugin:
   CUDA environment, device nodes and mounts, pods patched `succeed`,
   each config file read back with its claim, PreStartContainer passes
   and writes A's config file again after it is deleted;
3. tenants: C alone, then D alone, then A and B together run the quota
   step (`STEPS` steps), then read their memory view, try twice their
   claim and launch the attention kernel once: limits from the config
   file, capped totals, the over-claim refused with OutOfMemoryError,
   A and B's shares (against C alone) within `SHARE_BAND` of 50 and 25
   and in order, the kernel's launch counted by the interposer;
4. step_ring: A, B and D's rings, tailed at their host paths while they
   run: one record per step, only the first `compiled`, the tenant's
   pid as writer, the median timed step within `RING_REL` of the
   tenant's ms/step, throttle wait above zero for A and B and higher for
   B; C has no ring env, no telemetry mount and no ring file.

Run `python -m vtpu_manager_torch.bench_allocate --tenant ...` only as
the tenant subprocess the phase starts.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time
from pathlib import Path

from vtpu_manager_torch import build
from vtpu_manager_torch.util import consts

GIB = 2**30
STEPS = 300
WARMUP = 10
SPLIT = 4
SHARE_BAND = 15.0
RING_REL = 0.10
NODE = "node-h100"
# pod: (cores %, memory GiB, StepTelemetry, kubelet's slot)
PODS = {"pod-a": (50, 16, True, 0), "pod-b": (25, 8, True, 1),
        "pod-c": (0, 8, False, 2), "pod-d": (0, 8, True, 3)}


def committed_pod(name: str, chip, cores: int, memory: int,
                  node: str = NODE, annotations: dict | None = None) -> dict:
    """A pod as the JAX scheduler leaves it on `node`: bound, with its
    pre-allocation and the predicate-node annotation (and `annotations`,
    the webhook's, beside them)."""
    from vtpu_manager_torch.device.claims import DeviceClaim, PodDeviceClaims
    claims = PodDeviceClaims()
    claims.add("main", DeviceClaim(chip.uuid, chip.index, cores, memory))
    return {"metadata": {
        "name": name, "namespace": "default", "uid": f"uid-{name}",
        "annotations": {
            consts.pre_allocated_annotation(): claims.encode(),
            consts.predicate_node_annotation(): node,
            consts.compute_policy_annotation():
                consts.COMPUTE_POLICY_FIXED, **(annotations or {})}},
        "spec": {"nodeName": node, "containers": [{"name": "main"}]},
        "status": {"phase": "Pending"}}


def host_path(resp, path: str) -> str:
    """Where a container path lies on the host, by the response's mounts
    (the longest mount prefix wins); unmounted paths are the same."""
    for m in sorted(resp.mounts, key=lambda m: len(m.container_path),
                    reverse=True):
        cp = m.container_path
        if path == cp or path.startswith(cp + "/"):
            return m.host_path + path[len(cp):]
    return path


def container_env(resp) -> dict:
    """The environment a container runtime would give a tenant started
    from this Allocate response, with the mounts resolved to host paths
    (this process cannot bind-mount)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "DISABLE_VTPU"))
           and k not in (consts.ENV_LD_PRELOAD, "CUDA_VISIBLE_DEVICES",
                         consts.ENV_NVIDIA_VISIBLE_DEVICES)}
    env.update({k: host_path(resp, v) for k, v in resp.envs.items()})
    env[consts.ENV_LOCK_DIR] = host_path(resp, consts.LOCK_DIR)
    env[consts.ENV_VMEM_PATH] = host_path(resp, consts.VMEM_NODE_CONFIG)
    env[consts.ENV_TC_UTIL_PATH] = host_path(resp, consts.TC_UTIL_CONFIG)
    preload = host_path(resp, consts.LD_SO_PRELOAD)
    if preload != consts.LD_SO_PRELOAD:
        with open(preload) as f:
            env[consts.ENV_LD_PRELOAD] = ":".join(
                host_path(resp, line.strip()) for line in f if line.strip())
    # the interposer where the driver mount puts it (runtime.client.install
    # looks for it there)
    env[consts.ENV_SHIM_PATH] = host_path(resp, os.path.join(
        consts.DRIVER_DIR, consts.CONTROL_LIBRARY_NAME))
    for m in resp.mounts:
        if m.container_path == consts.TRACE_DIR:
            # the node trace dir, where a traced tenant finds it mounted
            env[consts.ENV_TRACE_DIR] = m.host_path
    env["CUDA_VISIBLE_DEVICES"] = resp.envs[consts.ENV_NVIDIA_VISIBLE_DEVICES]
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(build.REPO), os.environ.get("PYTHONPATH")) if p)
    return env


class RingTail:
    """Tails one tenant's step ring by cursor while it runs, as the node's
    reader does (a run of more than RING_CAPACITY steps overwrites its
    first records)."""

    def __init__(self, path: str, poll_s: float = 0.05):
        self.path = path
        self.poll_s = poll_s
        self.records: list = []
        self.dropped = 0
        self.head = 0
        self.writer_pid = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from vtpu_manager_torch.telemetry.stepring import StepRingReader
        while not os.path.exists(self.path):
            if self._stop.wait(self.poll_s):
                return
        reader = StepRingReader(self.path)
        try:
            while True:
                stopping = self._stop.wait(self.poll_s)
                recs, self.head, dropped = reader.poll(self.head)
                self.records += recs
                self.dropped += dropped
                self.writer_pid = reader.writer_pid
                if stopping:
                    return
        finally:
            reader.close()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


class Node:
    """The node agent on the card, on a directory of its own; a second
    node on the same card takes a `name` of its own and may share the
    first one's fake API `client`. It starts as `cmd/device_plugin.py`
    does: discovery, then the observation calibration under
    `obs_calibrate` (the plugin's VTPU_OBS_CALIBRATE: "0", the default of
    every phase but `observation`, skips it; "1" measures the idle card in
    a throwaway process), registration, and the watcher, whose feed the
    table seeds."""

    def __init__(self, root: str, shim: str, name: str = NODE, client=None,
                 obs_calibrate: str = "0", split: int = SPLIT):
        from vtpu_manager_torch.client.fake import FakeKubeClient
        from vtpu_manager_torch.config.node_config import NodeConfig
        from vtpu_manager_torch.config.vmem import VmemLedger
        from vtpu_manager_torch.deviceplugin.vnum import install_interposer
        from vtpu_manager_torch.manager import \
            obs_calibrate as obs_calibrate_mod
        from vtpu_manager_torch.manager.device_manager import DeviceManager
        from vtpu_manager_torch.manager.watcher import (NvmlSampler,
                                                        TcWatcherDaemon)
        from vtpu_manager_torch.tpu.discovery import NvmlBackend

        self.name = name
        self.root = Path(root)
        self.base_dir = str(self.root / "mgr")
        self.lock_dir = str(self.root / "locks")
        self.vmem_dir = str(self.root / "vmem")
        self.watcher_dir = str(self.root / "watcher")
        self.driver_dir = str(self.root / "driver")
        install_interposer(shim, self.driver_dir)
        vmem_path = os.path.join(self.vmem_dir,
                                 os.path.basename(consts.VMEM_NODE_CONFIG))
        os.makedirs(self.vmem_dir, exist_ok=True)
        VmemLedger(vmem_path, create=True).close()
        self.client = client or FakeKubeClient()
        self.client.add_node({"metadata": {"name": name, "annotations": {}}})
        self.manager = DeviceManager(
            name, self.client, node_config=NodeConfig(device_split_count=split),
            backends=[NvmlBackend()])
        self.manager.init_devices()
        t0 = time.perf_counter()
        table = obs_calibrate_mod.maybe_calibrate(
            real_chips=True,
            env={**os.environ, "VTPU_OBS_CALIBRATE": obs_calibrate})
        self.calibration_s = time.perf_counter() - t0
        if table is not None:
            self.manager.calibrate_obs_overhead(table=table)
        self.manager.register_node()
        self.daemon = TcWatcherDaemon(
            [c.index for c in self.manager.chips], NvmlSampler(),
            tc_path=os.path.join(self.watcher_dir,
                                 os.path.basename(consts.TC_UTIL_CONFIG)),
            vmem_path=vmem_path)
        if table is not None:
            self.daemon.publish_calibration(
                obs_calibrate_mod.decode_table(table))
        self.daemon.start()

    def plugin(self, step_telemetry: bool, gates: str = ""):
        """The vtpu-number plugin, its Allocate armed by `gates` as
        `cmd/device_plugin.main` arms it (`configure_vnum`), with the step
        ring as `step_telemetry` says."""
        from vtpu_manager_torch.cmd.device_plugin import configure_vnum
        from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin
        from vtpu_manager_torch.util.featuregates import FeatureGates
        p = VnumPlugin(self.manager, self.client, self.name,
                       node_config=self.manager.node_config,
                       base_dir=self.base_dir, shim_host_dir=self.driver_dir,
                       lock_dir=self.lock_dir, vmem_dir=self.vmem_dir,
                       watcher_dir=self.watcher_dir)
        if gates:
            fg = FeatureGates()
            fg.parse(gates)
            configure_vnum(p, fg)
        p.step_telemetry_enabled = step_telemetry
        return p

    def go_file(self, name: str) -> str:
        """A start signal for tenants (`bench_quota.run_tenants` takes a
        node as its world)."""
        return str(self.root / f"{name}.go")

    def close(self) -> None:
        self.daemon.stop()


class Phase:
    def __init__(self, torch, shim: str, root: str):
        self.torch = torch
        self.node = Node(root, shim)
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")
        self.allocations: dict[str, tuple] = {}   # pod -> (ids, response)
        self.runs: dict[str, dict] = {}
        self.tails: dict[str, RingTail] = {}

    def close(self) -> None:
        for tail in self.tails.values():
            tail.stop()
        self.node.close()

    # --- 1. registry -----------------------------------------------------

    def check_registry(self) -> dict:
        from vtpu_manager_torch.device.types import NodeDeviceRegistry
        from vtpu_manager_torch.tpu import discovery
        torch = self.torch
        node = self.node.client.get_node(NODE)
        reg = NodeDeviceRegistry.decode(node["metadata"]["annotations"][
            consts.node_device_register_annotation()])
        nvml = discovery.Nvml.load()
        handle = nvml.handle(self.chip.index)
        props = torch.cuda.get_device_properties(0)
        (chip,) = reg.chips
        devices = self.node.plugin(False).list_devices()
        rec = {"uuid": chip.uuid, "chip_type": chip.chip_type,
               "memory": chip.memory, "core_count": chip.core_count,
               "split_count": chip.split_count,
               "nvml_name": nvml.name(handle),
               "torch_name": torch.cuda.get_device_name(0),
               "nvml_usable": nvml.memory_usable(handle),
               "torch_memory": int(props.total_memory),
               "torch_sms": props.multi_processor_count,
               "device_node": self.node.manager.device_node(chip.index),
               "slots": len(devices),
               "healthy_slots": sum(d.health == "Healthy" for d in devices)}
        rec["ok"] = (chip.uuid == nvml.uuid(handle) == f"GPU-{props.uuid}"
                     and chip.chip_type == discovery.chip_type_for(
                         rec["torch_name"])
                     and rec["nvml_name"] == rec["torch_name"]
                     and chip.memory == rec["nvml_usable"]
                     and abs(chip.memory - rec["torch_memory"]) <= 2**20
                     and chip.core_count == rec["torch_sms"]
                     and chip.split_count == SPLIT
                     and rec["slots"] == rec["healthy_slots"] == SPLIT)
        return rec

    # --- 2. allocate and prestart ----------------------------------------

    def _allocate(self, pod_name: str) -> dict:
        from vtpu_manager_torch.config import vtpu_config as vc
        from vtpu_manager_torch.device.claims import PodDeviceClaims
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import (
            device_id, interposer_container_path)
        cores, gib, ring, slot = PODS[pod_name]
        chip = self.chip
        self.node.client.add_pod(committed_pod(pod_name, chip, cores,
                                               gib * GIB))
        plugin = self.node.plugin(ring)
        ids = [device_id(chip.uuid, slot)]
        (resp,) = plugin.allocate(api.AllocateRequest(
            [api.ContainerAllocateRequest(ids)])).container_responses
        self.allocations[pod_name] = (ids, resp)
        envs = resp.envs
        mounts = {m.container_path: m for m in resp.mounts}
        node_paths = [d.host_path for d in resp.devices]
        anns = self.node.client.get_pod("default", pod_name)["metadata"][
            "annotations"]
        real = PodDeviceClaims.decode(anns[
            consts.real_allocated_annotation()])
        pre = PodDeviceClaims.decode(anns[consts.pre_allocated_annotation()])
        cfg = vc.read_config(host_path(resp, consts.CONTAINER_CONFIG))
        dev = cfg.devices[0]
        with open(mounts[consts.LD_SO_PRELOAD].host_path) as f:
            preload = f.read().split()
        tel = os.path.join(consts.MANAGER_BASE_DIR, consts.TELEMETRY_SUBDIR)
        plugin.pre_start_container(api.PreStartContainerRequest(ids))
        rec = {"pod": pod_name, "envs": envs, "devices": node_paths,
               "mounts": sorted(mounts), "status": anns.get(
                   consts.allocation_status_annotation()),
               "config": {"uuid": dev.uuid, "total_memory": dev.total_memory,
                          "real_memory": dev.real_memory,
                          "hard_core": dev.hard_core,
                          "core_limit": dev.core_limit},
               "preload": preload}
        rec["ok"] = bool(
            envs[consts.ENV_NVIDIA_VISIBLE_DEVICES] == chip.uuid
            and envs[consts.ENV_VISIBLE_DEVICES] == str(chip.index)
            and envs[consts.ENV_REAL_CUDA_LIBRARY_PATH]
            and envs[consts.ENV_CONFIG_PATH] == consts.CONTAINER_CONFIG
            and envs.get(f"{consts.ENV_MEM_LIMIT}_0") == str(gib * GIB)
            and not any(k.startswith("TPU_") or "PJRT" in k for k in envs)
            and node_paths == [self.node.manager.device_node(chip.index),
                               *consts.NVIDIA_CONTROL_DEVICES]
            and mounts[consts.LD_SO_PRELOAD].read_only
            and preload == [interposer_container_path()]
            and mounts[consts.DRIVER_DIR].host_path == self.node.driver_dir
            and os.path.exists(host_path(resp, preload[0]))
            and (envs.get(consts.ENV_STEP_TELEMETRY) == "true") == ring
            and (tel in mounts) == ring
            and rec["status"] == consts.ALLOC_STATUS_SUCCEED
            and real.containers == pre.containers
            and (dev.uuid, dev.total_memory, dev.hard_core, dev.real_memory)
            == (chip.uuid, gib * GIB, cores, chip.memory))
        return rec

    def check_allocate(self) -> dict:
        from vtpu_manager_torch.config import vtpu_config as vc
        from vtpu_manager_torch.deviceplugin.api import messages as api
        pods = {name: self._allocate(name) for name in PODS}
        ids, resp = self.allocations["pod-a"]
        cfg_path = host_path(resp, consts.CONTAINER_CONFIG)
        os.unlink(cfg_path)
        self.node.plugin(True).pre_start_container(
            api.PreStartContainerRequest(ids))
        again = vc.read_config(cfg_path).devices[0] \
            if os.path.exists(cfg_path) else None
        cores, gib, _, _ = PODS["pod-a"]
        repaired = again is not None and (
            again.uuid, again.total_memory, again.hard_core) == (
                self.chip.uuid, gib * GIB, cores)
        return {"pods": pods, "prestart_repaired": repaired,
                "ok": repaired and all(r["ok"] for r in pods.values())}

    # --- 3. tenants, 4. step rings ----------------------------------------

    def _run(self, pods: list[str], timeout: float = 300.0) -> None:
        from vtpu_manager_torch import bench_quota as bq
        go = str(self.node.root / ("go-" + "-".join(pods)))
        tenants = []
        try:
            for pod in pods:
                _, resp = self.allocations[pod]
                env = container_env(resp)
                if consts.ENV_STEP_RING_PATH in env:
                    self.tails[pod] = RingTail(env[consts.ENV_STEP_RING_PATH])
                tenants.append(bq.Tenant(pod, [
                    "-m", "vtpu_manager_torch.bench_allocate", "--tenant",
                    "--steps", str(STEPS), "--warmup", str(WARMUP),
                    "--go-file", go], env, str(self.node.root)))
            for t in tenants:
                t.line("READY", timeout)
            Path(go).touch()
            for t in tenants:
                self.runs[t.tag] = t.line("WORKER ", timeout)
                self.runs[t.tag]["popen_pid"] = t.proc.pid
            for t in tenants:
                t.proc.wait(timeout=60)
        finally:
            for t in tenants:
                t.stop()
            for pod in pods:
                if pod in self.tails:
                    self.tails[pod].stop()

    def check_tenants(self) -> dict:
        self._run(["pod-c"])
        self._run(["pod-d"])
        self._run(["pod-a", "pod-b"])
        solo = self.runs["pod-c"]["ms_per_step"]
        out = {}
        for pod, (cores, gib, ring, _) in PODS.items():
            r = dict(self.runs[pod])
            r["share"] = 100.0 * solo / r["ms_per_step"]
            r["ok"] = (r["source"] == "config-file"
                       and r["total"] == gib * GIB
                       and r["over_claim"] == "oom"
                       and r["kernel_launches_delta"] == 1
                       and r["kernel_shim_launches_delta"] >= 1
                       and r["vtpu_launches_total"] > 0
                       and r["vtpu_fail_open_total"] == 0)
            out[pod] = r
        a, b = out["pod-a"]["share"], out["pod-b"]["share"]
        out["shares_ok"] = (abs(a - 50) <= SHARE_BAND
                            and abs(b - 25) <= SHARE_BAND and a > b)
        out["ring_hook_ms"] = {"off": solo,
                               "on": self.runs["pod-d"]["ms_per_step"]}
        out["ok"] = out["shares_ok"] and all(out[p]["ok"] for p in PODS)
        return out

    def check_step_ring(self) -> dict:
        out = {}
        for pod in ("pod-a", "pod-b", "pod-d"):
            tail, run = self.tails[pod], self.runs[pod]
            recs = tail.records
            timed = [r.duration_ns for r in recs if r.index >= WARMUP]
            median_ms = statistics.median(timed) / 1e6 if timed else None
            r = {"records": len(recs), "head": tail.head,
                 "dropped": tail.dropped, "steps": run["steps"],
                 "indices_in_order": [x.index for x in recs]
                 == list(range(len(recs))),
                 "compiled": [x.index for x in recs if x.compiled],
                 "writer_pid": tail.writer_pid, "pid": run["pid"],
                 "median_ms": median_ms, "ms_per_step": run["ms_per_step"],
                 "throttle_wait_ns": sum(x.throttle_wait_ns for x in recs),
                 "zeros": all(x.spilled_bytes == x.comm_time_ns
                              == x.bytes_transferred == 0 for x in recs)}
            r["median_rel"] = (None if median_ms is None
                               else median_ms / run["ms_per_step"] - 1)
            r["ok"] = (r["records"] == r["head"] == r["steps"]
                       and r["dropped"] == 0 and r["indices_in_order"]
                       and r["compiled"] == [0]
                       and r["writer_pid"] == r["pid"] == run["popen_pid"]
                       and r["median_rel"] is not None
                       and abs(r["median_rel"]) <= RING_REL and r["zeros"])
            out[pod] = r
        wa = out["pod-a"]["throttle_wait_ns"]
        wb = out["pod-b"]["throttle_wait_ns"]
        out["wait_ok"] = wa > 0 and wb > wa
        _, resp_c = self.allocations["pod-c"]
        c_dir = Path(self.node.base_dir) / "uid-pod-c_main"
        tel = os.path.join(consts.MANAGER_BASE_DIR, consts.TELEMETRY_SUBDIR)
        out["pod-c"] = {
            "ring_env": sorted(k for k in resp_c.envs if "STEP" in k),
            "telemetry_mount": any(m.container_path == tel
                                   for m in resp_c.mounts),
            "ring_files": [str(p) for p in c_dir.rglob(
                consts.STEP_RING_NAME)],
            "telemetry_dir": (c_dir / consts.TELEMETRY_SUBDIR).exists(),
            "ran": "pod-c" in self.runs}
        c = out["pod-c"]
        c["ok"] = (c["ran"] and not c["ring_env"]
                   and not c["telemetry_mount"] and not c["ring_files"]
                   and not c["telemetry_dir"])
        out["ok"] = out["wait_ok"] and all(
            out[p]["ok"] for p in ("pod-a", "pod-b", "pod-c", "pod-d"))
        return out


def _tenant(args) -> None:
    import torch

    from vtpu_manager_torch.bench_quota import (shim_counters, _wait_file,
                                                kernel_launch_once)
    from vtpu_manager_torch.bench_steps import quota_step_measure
    from vtpu_manager_torch.runtime.client import effective_limits

    def before_timed():
        print("READY", flush=True)
        _wait_file(args.go_file)

    ms = quota_step_measure(dim=args.dim, warmup=args.warmup,
                            steps=args.steps, before_timed=before_timed)
    limits = effective_limits()
    claim = limits.devices[0].total_memory if limits.devices else 0
    free, total = torch.cuda.mem_get_info()
    try:
        over = torch.empty(2 * claim, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        verdict = "granted"
        del over
    except torch.cuda.OutOfMemoryError:
        verdict = "oom"
    print("WORKER " + json.dumps({
        "pid": os.getpid(), "ms_per_step": ms,
        "steps": args.warmup + args.steps, "source": limits.source,
        "claim": claim, "free": free, "total": total, "over_claim": verdict,
        **kernel_launch_once(), **shim_counters()}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenant", action="store_true")
    ap.add_argument("--dim", type=int, default=8192)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--go-file")
    args = ap.parse_args(argv)
    if args.tenant:
        _tenant(args)
    else:
        ap.error("bench_allocate runs as a tenant; the phase is driven by "
                 "chip_smoke.py")


if __name__ == "__main__":
    sys.exit(main())
