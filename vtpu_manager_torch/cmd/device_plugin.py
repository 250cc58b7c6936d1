"""The port's device plugin: the node agent that hands out slices of a card.

    python -m vtpu_manager_torch.cmd.device_plugin --node-name n1 \\
        --fake-client [--fake-chips 2] [--feature-gates StepTelemetry=true]

The port of the JAX package's `cmd/device_plugin.py:108-290`, the parts
ported so far: discovery (NVML, or `--fake-chips N` synthetic H100s), the
device manager with the node registration and its heartbeat, the
vtpu-number plugin served to kubelet and registered with it (again after
a kubelet restart), the health watcher, and behind gates the memory ledger
(VMemoryNode) and the node's utilization watcher fed by NVML (TCWatcher).

Flags keep their JAX names. A flag of a part not ported yet is refused, as
is running without `--fake-client` (the in-cluster API client is not
ported). A run that is not root points `--base-dir`, `--vmem-path`,
`--lock-dir`, `--watcher-dir`, `--driver-dir` and `--plugin-dir` at a
directory of its own.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

# JAX flags of parts not ported yet: refused when given
NOT_PORTED = {
    "--registry-socket": "ClientMode's registry socket",
    "--trace-sampling-rate": "tracing",
    "--trace-spool-dir": "tracing",
    "--lease-namespace": "the reschedule controller",
    "--compile-cache-budget-mb": "the compile cache",
    "--compile-cache-evict-interval": "the compile cache",
    "--cache-advertise-endpoint": "the cluster compile cache",
    "--cache-ad-max-pairs": "the cluster compile cache",
    "--spill-budget-gib": "memory over-commit",
    "--metrics-port": "the resilience metrics endpoint",
    # a GPU's id is its NVML UUID; a store's synthetic ids would reach
    # NVIDIA_VISIBLE_DEVICES, which the container runtime cannot resolve
    "--id-store": "the device-id store (a GPU needs none)",
}


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    from vtpu_manager_torch.util import consts

    ap = argparse.ArgumentParser(description="vtpu device plugin (CUDA)")
    ap.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    ap.add_argument("--node-config")
    ap.add_argument("--health-probe-cmd", default="",
                    help="per-device health probe, run as <cmd> <index> "
                    "<uuid>, exit 0 = healthy (default: the device node "
                    "exists)")
    ap.add_argument("--feature-gates", default="")
    ap.add_argument("--plugin-dir", default="/var/lib/kubelet/device-plugins")
    ap.add_argument("--base-dir", default=consts.MANAGER_BASE_DIR)
    ap.add_argument("--vmem-path", default=consts.VMEM_NODE_CONFIG,
                    help="the memory ledger; its directory is what tenants "
                    "mount")
    ap.add_argument("--lock-dir", default=consts.LOCK_DIR)
    ap.add_argument("--watcher-dir", default=consts.WATCHER_DIR)
    ap.add_argument("--driver-dir", default=consts.DRIVER_DIR,
                    help="where the interposer is installed on the node")
    ap.add_argument("--real-libcuda-path", default="libcuda.so.1",
                    help="the card's driver library as the container sees "
                    "it")
    ap.add_argument("--fake-chips", type=int, default=0,
                    help="N synthetic H100s instead of NVML discovery")
    ap.add_argument("--fake-client", action="store_true")
    ap.add_argument("--mesh-domain", default="")
    for flag in NOT_PORTED:
        ap.add_argument(flag, default=None)
    ap.add_argument("-v", "--verbose", action="count", default=0)
    args = ap.parse_args(argv)
    for flag, part in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag}: {part} is not ported yet")
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("vtpu-device-plugin")

    from vtpu_manager_torch.config.node_config import load_node_config
    from vtpu_manager_torch.deviceplugin.base import PluginServer
    from vtpu_manager_torch.deviceplugin.vnum import (VnumPlugin,
                                                      install_interposer)
    from vtpu_manager_torch.manager.device_manager import (
        DeviceManager, HealthWatcher, device_node_probe, make_external_probe)
    from vtpu_manager_torch.tpu import discovery
    from vtpu_manager_torch.util import featuregates as fg

    gates = fg.FeatureGates()
    try:
        gates.parse(args.feature_gates)
    except ValueError as e:
        log.error("bad --feature-gates: %s", e)
        return 2
    if not args.node_name:
        log.error("--node-name or NODE_NAME required")
        return 2
    if not args.fake_client:
        log.error("the in-cluster API client is not ported yet; run with "
                  "--fake-client")
        return 2
    from vtpu_manager_torch.client.fake import FakeKubeClient
    client = FakeKubeClient(upsert_on_patch=True)
    client.add_node({"metadata": {"name": args.node_name,
                                  "annotations": {}}})

    node_config = load_node_config(args.node_config, args.node_name)
    backends = ([discovery.FakeBackend(n_chips=args.fake_chips)]
                if args.fake_chips else [discovery.NvmlBackend()])

    # install the interposer where tenants' driver mount expects it
    shim_src = os.environ.get("VTPU_SHIM_SOURCE",
                              "/app/driver/libvtpu-cuda-control.so")
    if os.path.exists(shim_src):
        try:
            log.info("interposer installed at %s",
                     install_interposer(shim_src, args.driver_dir))
        except OSError as e:
            log.warning("interposer install failed: %s", e)

    manager = DeviceManager(
        args.node_name, client, node_config=node_config,
        backends=backends, mesh_domain=args.mesh_domain)
    chips = manager.init_devices()
    log.info("discovered %d device(s): %s", len(chips),
             [c.uuid for c in chips])
    manager.register_node()
    manager.start_heartbeat()

    vnum = VnumPlugin(manager, client, args.node_name,
                      node_config=node_config, base_dir=args.base_dir,
                      shim_host_dir=args.driver_dir,
                      real_libcuda_path=args.real_libcuda_path,
                      lock_dir=args.lock_dir,
                      vmem_dir=os.path.dirname(args.vmem_path),
                      watcher_dir=args.watcher_dir)
    vnum.preferred_allocation_available = gates.enabled(fg.HONOR_PREALLOC_IDS)
    vnum.step_telemetry_enabled = gates.enabled(fg.STEP_TELEMETRY)
    server = PluginServer(vnum, plugin_dir=args.plugin_dir)
    server.serve()
    try:
        server.register()
    except Exception:  # noqa: BLE001 - no kubelet listening yet
        log.warning("kubelet registration failed for %s (no kubelet?)",
                    vnum.resource_name)
    server.watch_kubelet_restarts()

    if args.health_probe_cmd:
        probe = make_external_probe(args.health_probe_cmd)
    elif args.fake_chips:
        probe = lambda chip: True            # noqa: E731 - no device nodes
    else:
        probe = device_node_probe(manager)
    health = HealthWatcher(manager, probe)
    health.start()

    if gates.enabled(fg.VMEMORY_NODE):
        from vtpu_manager_torch.config.vmem import VmemLedger
        VmemLedger(args.vmem_path, create=True).close()
        log.info("vmem ledger ready at %s", args.vmem_path)
    watcher = None
    if gates.enabled(fg.TC_WATCHER):
        from vtpu_manager_torch.manager import watcher as w
        from vtpu_manager_torch.util import consts
        sampler = w.FakeSampler() if args.fake_chips else w.NvmlSampler()
        watcher = w.TcWatcherDaemon(
            [c.index for c in chips], sampler,
            tc_path=os.path.join(args.watcher_dir,
                                 os.path.basename(consts.TC_UTIL_CONFIG)),
            vmem_path=args.vmem_path)
        watcher.start()

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    log.info("device plugin running on %s", server.socket_path)
    stop.wait()
    log.info("stopping")
    health.stop()
    if watcher is not None:
        watcher.stop()
    server.stop()
    manager.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
