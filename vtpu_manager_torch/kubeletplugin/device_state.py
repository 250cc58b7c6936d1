"""DRA DeviceState: Prepare and Unprepare of ResourceClaims on this node.

The port of the JAX package's `kubeletplugin/device_state.py:31-344`. A
claim's results (resolved by `claimresolve.resolve`) are merged into one
partition per card, checked against the slots the scheduler allocated,
written as `vtpu.config` with the port's writer (the device plugin's
layout), and handed to the container runtime as a CDI spec; the prepared
claim then goes into the checkpoint. All of it under a node-wide lock.
A claim with several requests gets one config and one CDI device per
request. Prepare is idempotent; a corrupt checkpoint is quarantined.

The environment is the device plugin's CUDA set (`deviceplugin/vnum.py`):
`NVIDIA_VISIBLE_DEVICES` names the cards' UUIDs and the interposer
forwards to `VTPU_REAL_CUDA_LIBRARY_PATH`, where the JAX package sets the
PJRT variables. It also carries `VTPU_POD_UID` and `VTPU_CONTAINER_NAME`,
the identity the written config file carries (the claim's uid, and
`dra-claim` or `dra-<request>`): the interposer keys a tenant's processes
by them, so every process of one claim shares the claim's cap. The JAX
package sets neither, and each process of a claim there is a tenant of
its own with a cap of its own.

Writing the CDI spec is the `dra.cdi` span (`device_state.py:309-311`),
joined to the pod's timeline by `trace.context_for_claim`. Prepare fires
the JAX failpoints where they fire: `dra.prepare` after the idempotency
check, before anything is written, and `dra.cdi_write` after the CDI spec
lands and before the checkpoint, so a torn spec (partial-write) never
backs a checkpointed claim and the retried Prepare writes it whole.
`obs_excess_table` is the card's calibrated excess table
(`manager/obs_calibrate.py`), which `cmd/kubelet_plugin.py` measures at
start-up; None (uncalibrated) leaves `VTPU_OBS_EXCESS_TABLE` out.
"""

from __future__ import annotations

import logging
import os
import shutil

from vtpu_manager_torch import trace
from vtpu_manager_torch.claimresolve.resolve import resolve_claim_partitions
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.device.types import ChipSpec
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.deviceplugin.vnum import (COMPAT_BITS,
                                                  DEFAULT_REAL_LIBCUDA,
                                                  preload_file)
from vtpu_manager_torch.kubeletplugin import cdi
from vtpu_manager_torch.kubeletplugin.checkpoint import (Checkpoint,
                                                         PreparedClaim)
from vtpu_manager_torch.util import consts
from vtpu_manager_torch.util.flock import FileLock

log = logging.getLogger(__name__)


CHECKPOINT_NAME = "dra_checkpoint.json"


class PrepareError(RuntimeError):
    pass


class DeviceState:
    def __init__(self, node_name: str, chips: list[ChipSpec],
                 base_dir: str = consts.MANAGER_BASE_DIR,
                 cdi_dir: str = cdi.CDI_DIR,
                 node_config: NodeConfig | None = None,
                 minors: dict[int, int] | None = None,
                 shim_host_dir: str = consts.DRIVER_DIR,
                 lock_dir: str = consts.LOCK_DIR,
                 vmem_dir: str = consts.VMEM_DIR,
                 watcher_dir: str = consts.WATCHER_DIR,
                 registry_dir: str = consts.REGISTRY_DIR,
                 real_libcuda_path: str = DEFAULT_REAL_LIBCUDA,
                 obs_excess_table: str | None = None):
        """minors: host index -> device-node minor, from NVML discovery;
        a card without one cannot be prepared."""
        self.node_name = node_name
        self.node_config = node_config or NodeConfig()
        self.minors = dict(minors or {})
        self.real_libcuda_path = real_libcuda_path
        self.obs_excess_table = obs_excess_table
        self._chips_by_index = {c.index: c for c in chips}
        self.base_dir = base_dir
        self.cdi_dir = cdi_dir
        self.host = cdi.HostPaths(
            shim_dir=shim_host_dir, lock_dir=lock_dir, vmem_dir=vmem_dir,
            watcher_dir=watcher_dir, registry_dir=registry_dir,
            preload_file=os.path.join(base_dir, consts.LD_SO_PRELOAD_NAME))
        self.checkpoint = Checkpoint(
            os.path.join(base_dir, CHECKPOINT_NAME))
        try:
            self.checkpoint.load()
        except (ValueError, TypeError, AttributeError, KeyError) as e:
            # a torn or corrupt checkpoint must not crash-loop the driver:
            # set it aside and start empty (kubelet prepares live claims
            # again)
            quarantine = f"{self.checkpoint.path}.corrupt"
            log.error("checkpoint unreadable (%s); quarantined to %s", e,
                      quarantine)
            try:
                os.replace(self.checkpoint.path, quarantine)
            except OSError:
                pass
            self.checkpoint.claims = {}
        self._lock = FileLock(os.path.join(base_dir, "dra_prepare.lock"))

    def chip_for_device(self, device_name: str) -> ChipSpec | None:
        """Resolves `vtpu-<index>` or a slot `vtpu-<index>-<slot>`."""
        if not device_name.startswith("vtpu-"):
            return None
        idx_part = device_name[len("vtpu-"):].split("-", 1)[0]
        try:
            return self._chips_by_index.get(int(idx_part))
        except ValueError:
            return None

    @staticmethod
    def _is_fractional(device_name: str) -> bool:
        return device_name.count("-") >= 2

    def slot_capacity(self, device_name: str) -> tuple[int, int]:
        """(cores %, memory bytes) the allocated device covers: a slot's
        share of its card, or the whole card. An opaque config may ask for
        less, never more than the scheduler charged."""
        chip = self.chip_for_device(device_name)
        if chip is None:
            return (0, 0)
        if self._is_fractional(device_name):
            split = max(chip.split_count, 1)
            return (100 // split, chip.memory // split)
        return (100, chip.memory)

    def _minors(self, devices: list[dict]) -> list[int]:
        missing = [d["hostIndex"] for d in devices
                   if d["hostIndex"] not in self.minors]
        if missing:
            raise PrepareError(
                f"device(s) {missing} have no device-node minor (discover "
                "by NVML to name /dev/nvidia<minor>)")
        return [self.minors[d["hostIndex"]] for d in devices]

    # -- prepare ------------------------------------------------------------

    def _merge_partitions(self, partitions) -> list[dict]:
        """One device entry per card: two slots of one card are one bigger
        partition of it, not two caps on one index. Opaque configs are
        checked against the allocated slots."""
        merged: dict[int, dict] = {}
        for part in partitions:
            chip = self.chip_for_device(part.device)
            if chip is None:
                raise PrepareError(
                    f"allocated device {part.device!r} not on node")
            slot_cores, slot_mem = self.slot_capacity(part.device)
            cores = part.cores if part.cores is not None else slot_cores
            memory = (part.memory_mib * 2**20
                      if part.memory_mib is not None else slot_mem)
            if not 0 < cores <= 100:
                raise PrepareError(f"cores {cores} out of range")
            # more than the scheduler charged would over-commit the card,
            # but whole-card memory with the node's oversold opt-in, which
            # the merged check below still bounds
            mem_over = memory > slot_mem and (
                self._is_fractional(part.device)
                or not self.node_config.memory_overused)
            if cores > slot_cores or mem_over:
                raise PrepareError(
                    f"opaque config ({cores}%, {memory >> 20}MiB) "
                    f"exceeds allocated device capacity "
                    f"({slot_cores}%, {slot_mem >> 20}MiB)")
            entry = merged.setdefault(chip.index, {
                "device": part.device, "uuid": chip.uuid,
                "hostIndex": chip.index, "cores": 0, "memory": 0})
            entry["cores"] = min(entry["cores"] + cores, 100)
            entry["memory"] += memory
        devices = []
        for index in sorted(merged):
            entry = merged[index]
            chip = self._chips_by_index[index]
            if entry["memory"] > chip.memory and \
                    not self.node_config.memory_overused:
                raise PrepareError(
                    f"merged memory {entry['memory'] >> 20}MiB exceeds "
                    f"device memory {chip.memory >> 20}MiB (node not "
                    "configured for memory oversubscription)")
            devices.append(entry)
        return devices

    def _compat(self) -> int:
        return COMPAT_BITS.get(self.node_config.compat_mode,
                               consts.COMPAT_HOST)

    def _group_envs(self, uid: str, devices: list[dict],
                    container_name: str) -> dict[str, str]:
        """The environment of one group of per-card device entries."""
        envs: dict[str, str] = {}
        for i, entry in enumerate(devices):
            envs[f"{consts.ENV_MEM_LIMIT}_{i}"] = str(entry["memory"])
            if entry["cores"] < 100:
                envs[f"{consts.ENV_CORE_LIMIT}_{i}"] = str(entry["cores"])
        envs[consts.ENV_VISIBLE_DEVICES] = ",".join(
            str(d["hostIndex"]) for d in devices)
        envs[consts.ENV_NVIDIA_VISIBLE_DEVICES] = ",".join(
            d["uuid"] for d in devices)
        envs[consts.ENV_REAL_CUDA_LIBRARY_PATH] = self.real_libcuda_path
        envs[consts.ENV_CLAIM_UID] = uid
        envs[consts.ENV_REGISTER_UUID] = uid
        envs[consts.ENV_POD_UID] = uid
        envs[consts.ENV_CONTAINER_NAME] = container_name
        envs[consts.ENV_COMPAT_MODE] = str(self._compat())
        envs[consts.ENV_CONFIG_PATH] = consts.CONTAINER_CONFIG
        if self.obs_excess_table is not None:
            envs[consts.ENV_OBS_EXCESS_TABLE] = self.obs_excess_table
        return envs

    def _write_group_config(self, config_dir: str, uid: str, meta: dict,
                            container_name: str,
                            devices: list[dict]) -> None:
        os.makedirs(config_dir, exist_ok=True)
        vc.write_config(os.path.join(config_dir, "vtpu.config"),
                        vc.VtpuConfig(
            pod_uid=uid, pod_name=meta.get("name", ""),
            pod_namespace=meta.get("namespace", ""),
            container_name=container_name, compat_mode=self._compat(),
            devices=[vc.DeviceConfig(
                uuid=d["uuid"], total_memory=d["memory"],
                real_memory=self.chip_for_device(d["device"]).memory,
                hard_core=d["cores"], soft_core=d["cores"],
                core_limit=(vc.CORE_LIMIT_HARD if d["cores"] < 100
                            else vc.CORE_LIMIT_NONE),
                memory_limit=True, host_index=d["hostIndex"],
                mesh=self.chip_for_device(d["device"]).coords)
                for d in devices]))

    def prepare_claim(self, claim: dict) -> list[str]:
        """Prepares one ResourceClaim; returns its CDI device ids. A claim
        already prepared returns its recorded ids (kubelet retries
        Prepare). A claim of one request gets one CDI device; a claim
        whose results span several requests gets one per request, each
        with its own environment, limits and config file. Everything is
        checked before the first write, so a refused claim leaves nothing
        on disk."""
        meta = claim.get("metadata") or {}
        uid = meta.get("uid", "")
        if not uid:
            raise PrepareError("claim without uid")
        os.makedirs(self.base_dir, exist_ok=True)
        with self._lock:
            existing = self.checkpoint.claims.get(uid)
            if existing is not None:
                return list(existing.cdi_devices)
            # nothing is on disk yet: a crash here leaves no trace
            failpoints.fire("dra.prepare", claim=uid)

            allocation = ((claim.get("status") or {}).get("allocation")
                          or {})
            results = ((allocation.get("devices") or {}).get("results")
                       or [])
            if not any(r.get("driver") == consts.DRA_DRIVER_NAME
                       for r in results):
                raise PrepareError(
                    f"claim {uid} has no allocation for "
                    f"{consts.DRA_DRIVER_NAME}")
            try:
                partitions = resolve_claim_partitions(claim)
            except (TypeError, ValueError) as e:
                raise PrepareError(f"malformed opaque config: {e}") from e

            by_request: dict[str, list] = {}
            for part in partitions:
                by_request.setdefault(part.request, []).append(part)
            claim_dir = os.path.join(self.base_dir, f"claim_{uid}")
            client_mode = self.node_config.compat_mode == "client"

            if len(by_request) <= 1:
                devices = self._merge_partitions(partitions)
                minors = self._minors(devices)
                config_dir = os.path.join(claim_dir, "config")
                self._write_group_config(config_dir, uid, meta, "dra-claim",
                                         devices)
                spec = cdi.build_spec(
                    uid, minors, self._group_envs(uid, devices, "dra-claim"),
                    config_dir, self.host, client_mode=client_mode)
                cdi_names = [cdi.cdi_device_name(uid)]
            else:
                chip_mem: dict[int, int] = {}
                chip_cores: dict[int, int] = {}
                devices = []
                merged_groups: list[tuple[str, str, list[dict],
                                          list[int]]] = []
                for request in sorted(by_request):
                    group = self._merge_partitions(by_request[request])
                    slug = cdi.slugify(request)
                    cdi_id = cdi.cdi_device_name(uid, slug)
                    for d in group:
                        d["request"] = request
                        d["cdi"] = cdi_id
                        chip_mem[d["hostIndex"]] = \
                            chip_mem.get(d["hostIndex"], 0) + d["memory"]
                        chip_cores[d["hostIndex"]] = \
                            chip_cores.get(d["hostIndex"], 0) + d["cores"]
                    merged_groups.append((request, slug, group,
                                          self._minors(group)))
                    devices.extend(group)
                # requests are carved one by one, but land on the same cards
                for index, mem in chip_mem.items():
                    chip = self._chips_by_index[index]
                    if mem > chip.memory and \
                            not self.node_config.memory_overused:
                        raise PrepareError(
                            f"requests together put {mem >> 20}MiB on "
                            f"device {index} ({chip.memory >> 20}MiB, node "
                            "not configured for memory oversubscription)")
                    if chip_cores[index] > 100:
                        raise PrepareError(
                            f"requests together claim {chip_cores[index]}% "
                            f"of device {index} cores")
                groups = []
                for request, slug, group, minors in merged_groups:
                    config_dir = os.path.join(claim_dir, f"config_{slug}")
                    self._write_group_config(config_dir, uid, meta,
                                             f"dra-{slug}", group)
                    envs = self._group_envs(uid, group, f"dra-{slug}")
                    envs[consts.ENV_CLAIM_REQUEST] = request
                    groups.append((slug, minors, envs, config_dir))
                spec = cdi.build_multi_spec(uid, groups, self.host,
                                            client_mode=client_mode)
                cdi_names = list(dict.fromkeys(d["cdi"] for d in devices))
            preload_file(self.base_dir)
            with trace.span(trace.context_for_claim(claim), "dra.cdi",
                            claim=uid, devices=len(cdi_names)):
                cdi.write_spec(spec, uid, self.cdi_dir)
            failpoints.fire("dra.cdi_write", claim=uid,
                            path=cdi.spec_path(uid, self.cdi_dir))

            before = dict(self.checkpoint.claims)
            self.checkpoint.claims[uid] = PreparedClaim(
                claim_uid=uid, namespace=meta.get("namespace", ""),
                name=meta.get("name", ""), devices=devices,
                cdi_devices=cdi_names)
            self.checkpoint.save()
            self.checkpoint.diff_and_log(before)
            return cdi_names

    # -- unprepare ----------------------------------------------------------

    def unprepare_claim(self, claim_uid: str) -> None:
        """Removes the claim's spec, config files and checkpoint entry; a
        claim not prepared is a no-op."""
        with self._lock:
            claim = self.checkpoint.claims.pop(claim_uid, None)
            if claim is None:
                return
            cdi.remove_spec(claim_uid, self.cdi_dir)
            shutil.rmtree(os.path.join(self.base_dir, f"claim_{claim_uid}"),
                          ignore_errors=True)
            self.checkpoint.save()

    def prepared_uids(self) -> set[str]:
        return set(self.checkpoint.claims)
