"""The one walk over the per-container config root.

The port of the JAX package's `config/tenantdirs.py`.
`<base>/<entry>/config[_<request>]/vtpu.config` is the on-disk tenant
layout (entry `<pod_uid>_<container>` for device-plugin tenants,
`claim_<uid>` for DRA). The node exporter joins it with the ledger and the
feed through the owner token (fnv64 of `pod_uid/label`), so the walk and
the labels live in one place.
"""

from __future__ import annotations

import os
from typing import Iterator

from vtpu_manager_torch.config import vtpu_config as vc


def iter_container_config_paths(base_dir: str) -> Iterator[
        tuple[str, str, str, bool]]:
    """`(pod_uid_or_claim, container_label, config_path, is_dra)` per
    tenant partition."""
    if not os.path.isdir(base_dir):
        return
    for entry in sorted(os.listdir(base_dir)):
        entry_dir = os.path.join(base_dir, entry)
        if not os.path.isdir(entry_dir):
            continue
        try:
            config_dirs = sorted(
                d for d in os.listdir(entry_dir)
                if d == "config" or d.startswith("config_"))
        except OSError:
            continue
        pod_uid, _, container = entry.partition("_")
        for config_name in config_dirs:
            cfg_path = os.path.join(entry_dir, config_name, "vtpu.config")
            if not os.path.exists(cfg_path):
                continue
            suffix = config_name[len("config_"):] \
                if config_name != "config" else ""
            label = f"{container}/{suffix}" if suffix else container
            is_dra = entry.startswith("claim_") or bool(suffix)
            yield (pod_uid, label, cfg_path, is_dra)


def iter_container_configs(base_dir: str) -> Iterator[
        tuple[str, str, vc.VtpuConfig, bool, float]]:
    """`(pod_uid_or_claim, container_label, config, is_dra, config_mtime)`
    per tenant partition; each request of a multi-request DRA claim is a
    partition of its own (label `<container>/<request>`). `is_dra` marks
    tenants the kubelet's pod-resources API cannot corroborate, and the
    mtime is the tenant's age for the exporter's start-up grace. An
    unreadable config is skipped (a torn file is its writer's crash
    window)."""
    for pod_uid, label, cfg_path, is_dra in \
            iter_container_config_paths(base_dir):
        try:
            yield (pod_uid, label, vc.read_config(cfg_path),
                   is_dra, os.path.getmtime(cfg_path))
        except (OSError, ValueError):
            continue
