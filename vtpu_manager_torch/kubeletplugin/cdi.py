"""CDI specs for prepared claims: what the container runtime applies.

The port of the JAX package's `kubeletplugin/cdi.py:21-127`: one spec file
per claim (CDI 0.6 JSON), one device per claim, or one per request of a
multi-request claim, each carrying the environment, mounts and device
nodes that the device plugin's Allocate response carries
(`deviceplugin/vnum.py`). Names and paths of the spec are the JAX
package's.

What changes for CUDA:
- device nodes: `/dev/nvidia<minor>` per card, with NVML's minor (never
  CUDA's index), then `/dev/nvidiactl` and `/dev/nvidia-uvm`;
- mounts: the preload file at `/etc/ld.so.preload` (the dynamic linker
  loads the interposer from it, as the device plugin mounts it);
- the node's lock, ledger and feed directories lie where the caller says
  (`HostPaths`) on the host; their container paths stay fixed.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from vtpu_manager_torch.util import consts

CDI_VERSION = "0.6.0"
CDI_VENDOR = "google.com"
CDI_CLASS = "vtpu"
CDI_DIR = "/etc/cdi"


@dataclass(frozen=True)
class HostPaths:
    """Where the node's shared files lie on the host."""

    shim_dir: str = consts.DRIVER_DIR
    lock_dir: str = consts.LOCK_DIR
    vmem_dir: str = consts.VMEM_DIR
    watcher_dir: str = consts.WATCHER_DIR
    registry_dir: str = consts.REGISTRY_DIR
    preload_file: str = os.path.join(consts.MANAGER_BASE_DIR,
                                     consts.LD_SO_PRELOAD_NAME)


def unqualified_name(claim_uid: str, request_slug: str = "") -> str:
    """The device's name in the spec; the qualified id derives from it."""
    return f"{claim_uid}-{request_slug}" if request_slug else claim_uid


def cdi_device_name(claim_uid: str, request_slug: str = "") -> str:
    """Qualified CDI device id: per claim, or per request of a
    multi-request claim (a request slug appended)."""
    return f"{CDI_VENDOR}/{CDI_CLASS}={unqualified_name(claim_uid, request_slug)}"


def slugify(request: str) -> str:
    """A request name in CDI's name charset [a-zA-Z0-9._-]."""
    return "".join(c if c.isalnum() or c in "._-" else "-"
                   for c in request) or "req"


def _device(name: str, minors: list[int], envs: dict[str, str],
            config_host_dir: str, host: HostPaths,
            client_mode: bool) -> dict:
    env_list = [f"{k}={v}" for k, v in sorted(envs.items())]
    mounts = [
        {"hostPath": config_host_dir,
         "containerPath": f"{consts.MANAGER_BASE_DIR}/config",
         "options": ["ro", "rbind"]},
        {"hostPath": host.shim_dir, "containerPath": consts.DRIVER_DIR,
         "options": ["ro", "rbind"]},
        {"hostPath": host.lock_dir, "containerPath": consts.LOCK_DIR,
         "options": ["rw", "rbind"]},
        {"hostPath": host.vmem_dir, "containerPath": consts.VMEM_DIR,
         "options": ["rw", "rbind"]},
        {"hostPath": host.watcher_dir, "containerPath": consts.WATCHER_DIR,
         "options": ["ro", "rbind"]},
    ]
    if client_mode:
        mounts.append({"hostPath": host.registry_dir,
                       "containerPath": consts.REGISTRY_DIR,
                       "options": ["rw", "rbind"]})
    mounts.append({"hostPath": host.preload_file,
                   "containerPath": consts.LD_SO_PRELOAD,
                   "options": ["ro", "rbind"]})
    return {
        "name": name,
        "containerEdits": {
            "env": env_list,
            "mounts": mounts,
            # the cards, then the control nodes every CUDA process opens
            "deviceNodes": [{"path": p, "type": "c", "permissions": "rw"}
                            for p in [f"/dev/nvidia{m}" for m in minors]
                            + list(consts.NVIDIA_CONTROL_DEVICES)],
        },
    }


def build_spec(claim_uid: str, minors: list[int], envs: dict[str, str],
               config_host_dir: str, host: HostPaths = HostPaths(),
               client_mode: bool = False) -> dict:
    """One CDI device for the whole claim."""
    return {
        "cdiVersion": CDI_VERSION,
        "kind": f"{CDI_VENDOR}/{CDI_CLASS}",
        "devices": [_device(claim_uid, minors, envs, config_host_dir, host,
                            client_mode)],
    }


def build_multi_spec(claim_uid: str,
                     groups: list[tuple[str, list[int], dict, str]],
                     host: HostPaths = HostPaths(),
                     client_mode: bool = False) -> dict:
    """One CDI device per request, so containers binding different
    requests of one claim never see each other's partition. groups:
    (request slug, minors, envs, config host dir)."""
    return {
        "cdiVersion": CDI_VERSION,
        "kind": f"{CDI_VENDOR}/{CDI_CLASS}",
        "devices": [
            _device(unqualified_name(claim_uid, slug), minors, envs,
                    cfg_dir, host, client_mode)
            for slug, minors, envs, cfg_dir in groups],
    }


def spec_path(claim_uid: str, cdi_dir: str = CDI_DIR) -> str:
    return os.path.join(cdi_dir, f"{CDI_VENDOR}-{CDI_CLASS}-{claim_uid}.json")


def write_spec(spec: dict, claim_uid: str, cdi_dir: str = CDI_DIR) -> str:
    path = spec_path(claim_uid, cdi_dir)
    os.makedirs(cdi_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(spec, f, indent=1)
    os.replace(tmp, path)
    return path


def remove_spec(claim_uid: str, cdi_dir: str = CDI_DIR) -> None:
    try:
        os.unlink(spec_path(claim_uid, cdi_dir))
    except OSError:
        pass
