"""The DRA kubelet plugin hands slices of one card to tenants: the checks
of chip_smoke.py's `dra` phase.

The DRA counterpart of `bench_allocate.py`, on the same kind of private
node (`bench_allocate.Node`: NVML discovery split 4 ways, the interposer
installed in the node's driver directory, locks, ledger and the feed of
the NVML-fed watcher in directories of their own). The phase plays
kubelet, the API server and the container runtime around the port's
kubelet plugin:

- kubelet: `DraDriver.node_prepare` / `node_unprepare` are called with
  the messages of `kubeletplugin/api/messages.py` (the card machine has
  no grpc); the claims come from the fake API client through the
  driver's `ClaimSource`;
- the container runtime: `cdi_env` applies a CDI device's
  `containerEdits` by `bench_allocate.container_env`, the one stand-in
  for the runtime: mounts resolved to host paths, LD_PRELOAD from the
  mounted preload file, CUDA_VISIBLE_DEVICES from NVIDIA_VISIBLE_DEVICES.
  No VTPU_* variable of the calling process reaches a tenant, and no
  config file but the one Prepare wrote.

Checks, each a record with an `ok` verdict:

1. slice: the ResourceSlice names NVML's UUID and index, has SPLIT
   devices of a shared counter set of coreRatio 100 and the card's usable
   MiB, and is published through the fake client;
2. prepare: claim A (one request over slots 0 and 1, 25 % / 8 GiB each,
   merged to one device of 50 % / 16 GiB) and claim B (slot 2, 25 % /
   8 GiB): each CDI spec's environment, device nodes (`/dev/nvidia<NVML
   minor>` and the control nodes) and mounts, and `vtpu.config` read back
   equal to the claim; a claim over its slot comes back as its entry's
   error, and the batch still succeeds;
3. tenants: A and B together, started from their CDI devices alone,
   beside an unthrottled tenant alone for t_solo: shares within
   SHARE_BAND of 50 and 25 and in order, `mem_get_info` total equal to
   the claim, twice the claim refused with OutOfMemoryError, the
   attention kernel's one launch counted by the interposer;
4. siblings: two processes from B's one CDI device: the first holds
   6 GiB, the second's 4 GiB is refused (B's 8 GiB is shared). The
   control repeats it with B's environment as the JAX package writes it
   (no VTPU_POD_UID / VTPU_CONTAINER_NAME): the second is granted, each
   process a tenant with a cap of its own;
5. multi_request: A unprepared; claim C, requests `train` (slot 0) and
   `eval` (slot 1) at 25 % / 4 GiB: two CDI devices, the response maps
   each request to its own, one tenant per request at once, each with a
   4 GiB total, 8 GiB refused, and its config's container `dra-train` /
   `dra-eval`;
6. restart: a new DeviceState and DraDriver over the same directories:
   preparing B again returns its CDI id and writes nothing, unpreparing it
   removes its spec and `claim_<uid>/`, and a corrupt checkpoint is set
   aside as `.corrupt` and the driver starts empty.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from vtpu_manager_torch import bench_allocate as ba
from vtpu_manager_torch import bench_quota as bq
from vtpu_manager_torch.util import consts

GIB = 2**30
SHARE_BAND = 15.0
NAMESPACE = "ml"
TENANT_ARGS = ["-m", "vtpu_manager_torch.bench_allocate", "--tenant",
               "--steps", str(ba.STEPS), "--warmup", str(ba.WARMUP)]
# claim name: ({request: [slot, ...]}, cores %, memory GiB of each result)
CLAIMS = {"claim-a": ({"gpu": [0, 1]}, 25, 8),
          "claim-b": ({"gpu": [2]}, 25, 8),
          "claim-x": ({"gpu": [3]}, 50, 8),          # over its 25 % slot
          "claim-c": ({"train": [0], "eval": [1]}, 25, 4)}


def allocated_claim(name: str, index: int, requests: dict[str, list[int]],
                    cores: int, memory_mib: int) -> dict:
    """A ResourceClaim as the DRA scheduler leaves it: each result a slot
    `vtpu-<index>-<slot>` of this driver, one opaque config per request."""
    return {
        "metadata": {"uid": f"uid-{name}", "name": name,
                     "namespace": NAMESPACE},
        "status": {"allocation": {"devices": {
            "results": [{"request": req, "driver": consts.DRA_DRIVER_NAME,
                         "pool": ba.NODE, "device": f"vtpu-{index}-{slot}"}
                        for req, slots in requests.items()
                        for slot in slots],
            "config": [{"requests": [req], "opaque": {
                "driver": consts.DRA_DRIVER_NAME,
                "parameters": {"cores": cores, "memoryMiB": memory_mib}}}
                for req in requests],
        }}},
    }


def as_response(device: dict):
    """A CDI device's containerEdits in the shape of an Allocate response,
    which `bench_allocate.container_env` applies."""
    from vtpu_manager_torch.deviceplugin.api import messages as api
    edits = device["containerEdits"]
    return api.ContainerAllocateResponse(
        envs=dict(e.split("=", 1) for e in edits.get("env", [])),
        mounts=[api.Mount(container_path=m["containerPath"],
                          host_path=m["hostPath"],
                          read_only="ro" in m.get("options", []))
                for m in edits.get("mounts", [])],
        devices=[api.DeviceSpec(container_path=n["path"],
                                host_path=n.get("hostPath", n["path"]),
                                permissions=n.get("permissions", ""))
                 for n in edits.get("deviceNodes", [])])


def cdi_env(device: dict) -> dict:
    """The environment a container runtime would give a tenant started
    from this CDI device, with its mounts resolved to host paths."""
    return ba.container_env(as_response(device))


def read_spec(cdi_dir: str, uid: str) -> dict[str, dict]:
    """The claim's CDI devices by name."""
    from vtpu_manager_torch.kubeletplugin import cdi
    with open(cdi.spec_path(uid, cdi_dir)) as f:
        return {d["name"]: d for d in json.load(f)["devices"]}


def without_identity(env: dict) -> dict:
    """The environment as the JAX package's Prepare writes it for the same
    claim, as far as the interposer reads it: no tenant identity."""
    return {k: v for k, v in env.items()
            if k not in (consts.ENV_POD_UID, consts.ENV_CONTAINER_NAME)}


class Phase:
    def __init__(self, torch, shim: str, root: str):
        self.node = ba.Node(root, shim)
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")
        self.shim = shim
        self.base_dir = str(self.node.root / "dra")
        self.cdi_dir = str(self.node.root / "cdi")
        for name, (requests, cores, gib) in CLAIMS.items():
            self.node.client.add_resourceclaim(allocated_claim(
                name, self.chip.index, requests, cores, gib * 1024))
        self.driver = self.new_driver()
        self.runs: dict[str, dict] = {}

    def close(self) -> None:
        self.node.close()

    def new_driver(self):
        """The kubelet plugin's driver over this node, as its command
        builds it (a restart builds it again)."""
        from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
        from vtpu_manager_torch.kubeletplugin.driver import (ClaimSource,
                                                             DraDriver)
        node = self.node
        state = DeviceState(
            ba.NODE, node.manager.chips, base_dir=self.base_dir,
            cdi_dir=self.cdi_dir, node_config=node.manager.node_config,
            minors=node.manager.minors, shim_host_dir=node.driver_dir,
            lock_dir=node.lock_dir, vmem_dir=node.vmem_dir,
            watcher_dir=node.watcher_dir,
            registry_dir=str(node.root / "registry"))
        return DraDriver(ba.NODE, ClaimSource(node.client), state,
                         plugin_dir=str(node.root / "plugins"))

    def prepare(self, *names: str, driver=None):
        from vtpu_manager_torch.kubeletplugin.api import messages as api
        return (driver or self.driver).node_prepare(
            api.NodePrepareResourcesRequest([
                api.Claim(f"uid-{n}", n, NAMESPACE) for n in names]))

    def unprepare(self, *names: str, driver=None):
        from vtpu_manager_torch.kubeletplugin.api import messages as api
        return (driver or self.driver).node_unprepare(
            api.NodeUnprepareResourcesRequest([
                api.Claim(f"uid-{n}", n, NAMESPACE) for n in names]))

    def env(self, name: str, device: str | None = None) -> dict:
        uid = f"uid-{name}"
        return cdi_env(read_spec(self.cdi_dir, uid)[device or uid])

    # --- 1. the ResourceSlice ---------------------------------------------

    def check_slice(self) -> dict:
        from vtpu_manager_torch.kubeletplugin.allocatable import \
            build_resource_slice
        from vtpu_manager_torch.kubeletplugin.registration import \
            publish_resource_slice
        from vtpu_manager_torch.tpu import discovery
        chip = self.chip
        published = publish_resource_slice(
            self.node.client, build_resource_slice(ba.NODE,
                                                   self.node.manager.chips))
        doc = self.node.client.resourceslices[f"{ba.NODE}-vtpu"]
        nvml = discovery.Nvml.load()
        handle = nvml.handle(chip.index)
        usable_mib = nvml.memory_usable(handle) // 2**20
        devices = doc["spec"]["devices"]
        counters = {c["name"]: c["counters"]
                    for c in doc["spec"]["sharedCounters"]}
        attrs = [d["basic"]["attributes"] for d in devices]
        rec = {"published": published, "driver": doc["spec"]["driver"],
               "devices": [d["name"] for d in devices],
               "uuids": sorted({a["uuid"]["string"] for a in attrs}),
               "indices": sorted({a["index"]["int"] for a in attrs}),
               "nvml_uuid": nvml.uuid(handle), "nvml_usable_mib": usable_mib,
               "counters": counters,
               "slot_capacity": devices[0]["basic"]["capacity"]}
        want_slot = {"coreRatio": {"value": str(100 // ba.SPLIT)},
                     "memoryMiB": {"value": str(usable_mib // ba.SPLIT)}}
        rec["ok"] = bool(
            published and rec["driver"] == consts.DRA_DRIVER_NAME
            and rec["devices"] == [f"vtpu-{chip.index}-{s}"
                                   for s in range(ba.SPLIT)]
            and rec["uuids"] == [rec["nvml_uuid"]] == [chip.uuid]
            and rec["indices"] == [chip.index]
            and counters == {f"chip-{chip.index}": {
                "coreRatio": {"value": "100"},
                "memoryMiB": {"value": str(usable_mib)}}}
            and all(d["basic"]["capacity"] == want_slot
                    and d["basic"]["consumesCounters"][0]["counters"]
                    == want_slot for d in devices)
            and all(a["healthy"]["bool"] for a in attrs))
        return rec

    # --- 2. prepare --------------------------------------------------------

    def _prepared(self, name: str, entry, cores: int, memory: int,
                  container: str = "dra-claim",
                  device: str | None = None) -> dict:
        """One CDI device of a prepared claim against what was claimed."""
        from vtpu_manager_torch.config import vtpu_config as vc
        from vtpu_manager_torch.deviceplugin.vnum import \
            interposer_container_path
        uid = f"uid-{name}"
        spec = read_spec(self.cdi_dir, uid)[device or uid]
        edits = spec["containerEdits"]
        envs = dict(e.split("=", 1) for e in edits["env"])
        resp = as_response(spec)
        mounts = {m.container_path: m for m in resp.mounts}
        nodes = [n["path"] for n in edits["deviceNodes"]]
        cfg = vc.read_config(ba.host_path(resp, consts.CONTAINER_CONFIG))
        (dev,) = cfg.devices
        preload_host = mounts[consts.LD_SO_PRELOAD].host_path
        with open(preload_host) as f:
            preload = f.read().split()
        chip, node = self.chip, self.node
        rec = {"claim": name, "error": entry.error,
               "response": [vars(d) for d in entry.devices],
               "envs": envs, "device_nodes": nodes, "mounts": sorted(mounts),
               "config": {"pod_uid": cfg.pod_uid,
                          "container_name": cfg.container_name,
                          "uuid": dev.uuid, "total_memory": dev.total_memory,
                          "real_memory": dev.real_memory,
                          "hard_core": dev.hard_core,
                          "core_limit": dev.core_limit},
               "preload": preload}
        rec["ok"] = bool(
            not entry.error
            and envs.get(f"{consts.ENV_CORE_LIMIT}_0") == str(cores)
            and envs.get(f"{consts.ENV_MEM_LIMIT}_0") == str(memory)
            and envs[consts.ENV_NVIDIA_VISIBLE_DEVICES] == chip.uuid
            and envs[consts.ENV_VISIBLE_DEVICES] == str(chip.index)
            and envs[consts.ENV_POD_UID] == uid
            and envs[consts.ENV_CONTAINER_NAME] == container
            and envs[consts.ENV_CLAIM_UID] == uid
            and envs[consts.ENV_REAL_CUDA_LIBRARY_PATH]
            and envs[consts.ENV_CONFIG_PATH] == consts.CONTAINER_CONFIG
            and not any(k.startswith("TPU_") or "PJRT" in k for k in envs)
            and nodes == [node.manager.device_node(chip.index),
                          *consts.NVIDIA_CONTROL_DEVICES]
            and os.path.exists(nodes[0])
            and mounts[consts.DRIVER_DIR].host_path == node.driver_dir
            and mounts[consts.LOCK_DIR].host_path == node.lock_dir
            and mounts[consts.VMEM_DIR].host_path == node.vmem_dir
            and mounts[consts.WATCHER_DIR].host_path == node.watcher_dir
            and mounts[consts.LD_SO_PRELOAD].read_only
            and preload == [interposer_container_path()]
            and os.path.exists(ba.host_path(resp, preload[0]))
            and (cfg.pod_uid, cfg.container_name) == (uid, container)
            and (dev.uuid, dev.total_memory, dev.hard_core, dev.real_memory,
                 dev.core_limit)
            == (chip.uuid, memory, cores, chip.memory, vc.CORE_LIMIT_HARD))
        return rec

    def check_prepare(self) -> dict:
        from vtpu_manager_torch.kubeletplugin import cdi
        resp = self.prepare("claim-a", "claim-b", "claim-x")
        out = {"claim-a": self._prepared("claim-a", resp.claims["uid-claim-a"],
                                         50, 16 * GIB),
               "claim-b": self._prepared("claim-b", resp.claims["uid-claim-b"],
                                         25, 8 * GIB)}
        for name in ("claim-a", "claim-b"):
            (dev,) = resp.claims[f"uid-{name}"].devices
            out[name]["ok"] = out[name]["ok"] and (
                dev.requests == [] and dev.pool_name == ba.NODE
                and dev.cdi_device_ids == [cdi.cdi_device_name(f"uid-{name}")])
        x = resp.claims["uid-claim-x"]
        out["claim-x"] = {
            "error": x.error,
            "left_behind": os.path.exists(cdi.spec_path("uid-claim-x",
                                                        self.cdi_dir))
            or os.path.exists(os.path.join(self.base_dir, "claim_uid-claim-x"))}
        out["claim-x"]["ok"] = ("exceeds allocated device capacity" in x.error
                                and not x.devices
                                and not out["claim-x"]["left_behind"])
        out["ok"] = all(out[n]["ok"] for n in ("claim-a", "claim-b",
                                               "claim-x"))
        return out

    # --- 3. tenants --------------------------------------------------------

    def _tenant_ok(self, r: dict, memory: int) -> bool:
        return (r["source"] == "config-file" and r["claim"] == memory
                and r["total"] == memory and r["over_claim"] == "oom"
                and r["kernel_launches_delta"] == 1
                and r["kernel_shim_launches_delta"] >= 1
                and r["vtpu_launches_total"] > 0
                and r["vtpu_fail_open_total"] == 0)

    def check_tenants(self) -> dict:
        solo_env = bq.tenant_env(self.shim, 100)
        self.runs.update(bq.run_tenants(self.node, [
            ("solo", TENANT_ARGS, solo_env)]))
        self.runs.update(bq.run_tenants(self.node, [
            ("claim-a", TENANT_ARGS, self.env("claim-a")),
            ("claim-b", TENANT_ARGS, self.env("claim-b"))]))
        solo = self.runs["solo"]["ms_per_step"]
        out = {"solo": self.runs["solo"]}
        for name, memory in (("claim-a", 16 * GIB), ("claim-b", 8 * GIB)):
            r = dict(self.runs[name])
            r["share"] = 100.0 * solo / r["ms_per_step"]
            r["ok"] = self._tenant_ok(r, memory)
            out[name] = r
        a, b = out["claim-a"]["share"], out["claim-b"]["share"]
        out["shares_ok"] = (abs(a - 50) <= SHARE_BAND
                            and abs(b - 25) <= SHARE_BAND and a > b)
        out["ok"] = (out["shares_ok"] and out["claim-a"]["ok"]
                     and out["claim-b"]["ok"])
        return out

    # --- 4. siblings -------------------------------------------------------

    def check_siblings(self) -> dict:
        env = self.env("claim-b")
        specs = {"first": ("6", env), "second": ("4", env),
                 "control_first": ("6", without_identity(env)),
                 "control_second": ("4", without_identity(env))}
        hold = {tag: str(self.node.root / f"{tag}.release") for tag in specs}
        tenants = {}
        rec = {}
        try:
            for tag, (gib, tenv) in specs.items():
                tenants[tag] = bq.Tenant(
                    tag, bq.hold_args(gib, self.node.go_file(tag), hold[tag]),
                    tenv, str(self.node.root))
            for t in tenants.values():
                t.line("READY")
            for pair in (("first", "second"),
                         ("control_first", "control_second")):
                for tag in pair:
                    Path(self.node.go_file(tag)).touch()
                    rec[tag] = tenants[tag].line("HOLD ")
                for tag in pair:       # exited, not killed: ledger cleared
                    Path(hold[tag]).touch()
                    tenants[tag].proc.wait(timeout=60)
        finally:
            for t in tenants.values():
                t.stop()
        out = {tag: {"verdicts": r["verdicts"], "total": r["total"],
                     "source": r["source"],
                     "oom_rejected": r.get("vtpu_oom_rejected_total")}
               for tag, r in rec.items()}
        out["shared_cap"] = (rec["first"]["verdicts"] == ["granted"]
                             and rec["second"]["verdicts"] == ["refused"])
        # the JAX package's environment: each process a tenant of its own
        out["control_granted"] = (
            rec["control_first"]["verdicts"] == ["granted"]
            and rec["control_second"]["verdicts"] == ["granted"])
        out["ok"] = (out["shared_cap"] and out["control_granted"]
                     and all(r["source"] == "config-file"
                             and r["total"] == 8 * GIB for r in rec.values()))
        return out

    # --- 5. multi_request --------------------------------------------------

    def check_multi_request(self) -> dict:
        from vtpu_manager_torch.kubeletplugin import cdi
        unprep = self.unprepare("claim-a")
        gone = not (os.path.exists(cdi.spec_path("uid-claim-a", self.cdi_dir))
                    or os.path.exists(os.path.join(self.base_dir,
                                                   "claim_uid-claim-a")))
        resp = self.prepare("claim-c")
        entry = resp.claims["uid-claim-c"]
        uid = "uid-claim-c"
        by_request = {tuple(d.requests): (d.device_name, d.cdi_device_ids)
                      for d in entry.devices}
        out = {"unprepared_a": {"error": unprep.claims["uid-claim-a"].error,
                                "gone": gone},
               "response": {"/".join(k): v for k, v in by_request.items()},
               "spec_devices": sorted(read_spec(self.cdi_dir, uid))}
        specs = [("train", 0), ("eval", 1)]
        for request, slot in specs:
            device = cdi.unqualified_name(uid, request)
            r = self._prepared("claim-c", entry, 25, 4 * GIB,
                               container=f"dra-{request}", device=device)
            r["ok"] = r["ok"] and (
                r["envs"][consts.ENV_CLAIM_REQUEST] == request
                and by_request.get((request,)) == (
                    f"vtpu-{self.chip.index}-{slot}",
                    [cdi.cdi_device_name(uid, request)]))
            out[request] = r
        self.runs.update(bq.run_tenants(self.node, [
            (f"claim-c-{request}", TENANT_ARGS,
             self.env("claim-c", cdi.unqualified_name(uid, request)))
            for request, _ in specs]))
        for request, _ in specs:
            r = self.runs[f"claim-c-{request}"]
            out[f"tenant_{request}"] = r
            r["ok"] = self._tenant_ok(r, 4 * GIB)
        out["ok"] = bool(
            not out["unprepared_a"]["error"] and gone and not entry.error
            and len(entry.devices) == 2
            and out["spec_devices"] == sorted(
                cdi.unqualified_name(uid, r) for r, _ in specs)
            and all(out[r]["ok"] and out[f"tenant_{r}"]["ok"]
                    for r, _ in specs))
        return out

    # --- 6. restart --------------------------------------------------------

    def check_restart(self) -> dict:
        from vtpu_manager_torch.kubeletplugin import cdi
        from vtpu_manager_torch.kubeletplugin.checkpoint import Checkpoint
        uid = "uid-claim-b"
        ckpt = os.path.join(self.base_dir, "dra_checkpoint.json")
        files = [cdi.spec_path(uid, self.cdi_dir), ckpt,
                 os.path.join(self.base_dir, f"claim_{uid}", "config",
                              "vtpu.config")]

        def snapshot():
            return [(os.stat(p).st_mtime_ns, Path(p).read_bytes())
                    for p in files]

        before = snapshot()
        driver = self.new_driver()
        again = self.prepare("claim-b", driver=driver).claims[uid]
        out = {"prepared_after_restart": sorted(driver.state.prepared_uids()),
               "again": [vars(d) for d in again.devices],
               "error": again.error, "unchanged": snapshot() == before}
        unprep = self.unprepare("claim-b", driver=driver).claims[uid]
        on_disk = Checkpoint(ckpt)
        on_disk.load()
        out["unprepared"] = {
            "error": unprep.error,
            "spec": os.path.exists(files[0]),
            "claim_dir": os.path.exists(os.path.join(self.base_dir,
                                                     f"claim_{uid}")),
            "in_checkpoint": uid in on_disk.claims}
        with open(ckpt, "w") as f:
            f.write('{"checksum": 1, "data": {"version": 2,')
        fresh = self.new_driver()
        out["after_corrupt"] = {
            "prepared": sorted(fresh.state.prepared_uids()),
            "quarantined": os.path.exists(ckpt + ".corrupt")}
        out["ok"] = bool(
            uid in out["prepared_after_restart"] and not again.error
            and [d.cdi_device_ids for d in again.devices]
            == [[cdi.cdi_device_name(uid)]]
            and out["unchanged"]
            and not unprep.error
            and not any(v for k, v in out["unprepared"].items()
                        if k != "error")
            and out["after_corrupt"] == {"prepared": [], "quarantined": True})
        return out
