"""The port's DRA kubelet plugin: the node agent on clusters with
DynamicResourceAllocation, in place of the device plugin.

    python -m vtpu_manager_torch.cmd.kubelet_plugin --node-name n1 \\
        [--fake-chips 2] [--node-config node.json] \\
        [--nri-socket /var/run/nri/nri.sock | --feature-gates NRISupport=true]
        [--feature-gates Tracing=true --trace-sampling-rate 0.5
         --trace-spool-dir <dir>]

The port of the JAX package's `cmd/kubelet_plugin.py:20-243`: discovery
(NVML, or `--fake-chips N` synthetic H100s), the node config, the DRA
driver served on `<plugin-dir>/dra.sock`, the registration socket in
kubelet's plugins_registry, the node's ResourceSlice, the health watcher
that publishes it again when a card flips, and /healthz and /readyz on
`--health-port`.

The API server is reached with the pod's service account
(`client.kube.InClusterClient`: KUBERNETES_SERVICE_HOST and _PORT, the
token and CA under `--service-account-dir`). Through it the plugin
publishes its ResourceSlice (PUT, then POST the first time) and fetches
each claim it prepares. Without API access it serves all the same, as the
JAX command does: every claim is then "not found" and no slice is
published. With `--nri-socket` (or the NRISupport gate, which names the
runtime's default socket) the plugin also registers the NRI runtime hook,
which refuses a container that names a claim its pod does not own; when
the socket cannot be reached it goes on without the hook, and /readyz
says so. With the Tracing gate, Prepare records the `dra.prepare` and
`dra.cdi` spans of the claims reserved for pods whose uid the sampling
rate picks (the admission mint's verdict, computed again from the uid),
spooled to `--trace-spool-dir`. With FaultInjection, the failpoint
registry is armed from `VTPU_FAILPOINTS` (seed `VTPU_FAILPOINTS_SEED`);
a malformed spec exits 2.

The flag of a part not ported (the device-id store) is refused. A run
that is not root points `--plugin-dir`, `--registry-dir`, `--base-dir`,
`--cdi-dir`, `--vmem-path`, `--lock-dir`, `--watcher-dir`, `--driver-dir`
and, with Tracing, `--trace-spool-dir` at a directory of its own.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from vtpu_manager_torch.client.kube import (SERVICE_ACCOUNT_DIR,
                                            in_cluster_client)

# JAX flags of parts not ported yet: refused when given
NOT_PORTED = {
    # a GPU's id is its NVML UUID; a store's synthetic ids would reach
    # NVIDIA_VISIBLE_DEVICES, which the container runtime cannot resolve
    "--id-store": "the device-id store (a GPU needs none)",
}


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    from vtpu_manager_torch.util import consts

    ap = argparse.ArgumentParser(description="vtpu DRA kubelet plugin (CUDA)")
    ap.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    ap.add_argument("--plugin-dir", default="/var/lib/kubelet/plugins/vtpu-dra")
    ap.add_argument("--base-dir", default=consts.MANAGER_BASE_DIR)
    ap.add_argument("--cdi-dir", default="/etc/cdi")
    ap.add_argument("--registry-dir",
                    default="/var/lib/kubelet/plugins_registry")
    ap.add_argument("--fake-chips", type=int, default=0,
                    help="N synthetic H100s instead of NVML discovery")
    ap.add_argument("--node-config",
                    help="the device plugin's node config (JSON, or YAML "
                    "where yaml is installed): split count, scaling, "
                    "exclusions shape the ResourceSlice")
    ap.add_argument("--feature-gates", default="")
    ap.add_argument("--health-probe-cmd", default="",
                    help="per-device health probe, run as <cmd> <index> "
                    "<uuid>, exit 0 = healthy (default: the device node "
                    "exists)")
    ap.add_argument("--health-port", type=int, default=-1,
                    help="serve /healthz and /readyz on this port (-1: off)")
    ap.add_argument("--health-host", default="0.0.0.0")
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
    ap.add_argument("--service-account-dir", default=SERVICE_ACCOUNT_DIR,
                    help="the API token and CA (the API server is "
                    "KUBERNETES_SERVICE_HOST:KUBERNETES_SERVICE_PORT)")
    ap.add_argument("--nri-socket", default=None,
                    help="the runtime's NRI socket: register the runtime "
                    "hook there")
    ap.add_argument("--trace-sampling-rate", type=float, default=1.0,
                    help="Tracing: the share of traced pods whose DRA "
                    "spans are recorded")
    ap.add_argument("--trace-spool-dir", default=None,
                    help="Tracing: the span spool dir (default: the node "
                    "trace dir)")
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
    # a SIGTERM while the agent starts stops it once started, cleanly
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("vtpu-kubelet-plugin")

    from vtpu_manager_torch.config.node_config import (load_node_config,
                                                       shape_chips)
    from vtpu_manager_torch.kubeletplugin.allocatable import \
        build_resource_slice
    from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
    from vtpu_manager_torch.kubeletplugin.driver import ClaimSource, DraDriver
    from vtpu_manager_torch.kubeletplugin.health import (DraHealthWatcher,
                                                         device_node_probe)
    from vtpu_manager_torch.kubeletplugin.readiness import (Readiness,
                                                            ReadinessServer)
    from vtpu_manager_torch.kubeletplugin.registration import (
        RegistrationServer, publish_resource_slice)
    from vtpu_manager_torch.manager.device_manager import make_external_probe
    from vtpu_manager_torch.tpu import discovery
    from vtpu_manager_torch.util import featuregates as fg

    gates = fg.FeatureGates()
    try:
        gates.parse(args.feature_gates)
    except ValueError as e:
        log.error("bad --feature-gates: %s", e)
        return 2
    if gates.enabled(fg.TRACING):
        from vtpu_manager_torch import trace
        trace.configure("dra", spool_dir=args.trace_spool_dir,
                        sampling_rate=args.trace_sampling_rate)
        log.info("tracing on: spans to %s at sampling rate %g",
                 trace.recorder().spool_dir, trace.sampling_rate())
    if gates.enabled(fg.FAULT_INJECTION):
        from vtpu_manager_torch.resilience import failpoints
        try:
            failpoints.arm_from_env()
        except ValueError as e:
            log.error("bad failpoint spec: %s", e)
            return 2
        log.info("fault injection on: armed %s", failpoints.armed_sites())
    if not args.node_name:
        log.error("--node-name or NODE_NAME required")
        return 2

    backends = ([discovery.FakeBackend(n_chips=args.fake_chips)]
                if args.fake_chips else [discovery.NvmlBackend()])
    result = discovery.discover(backends)
    if result is None:
        log.error("no devices discovered")
        return 1
    node_config = load_node_config(args.node_config, args.node_name)
    chips = shape_chips(result.chips, node_config, args.node_name)
    log.info("discovered %d device(s): %s", len(chips),
             [c.uuid for c in chips])

    # the card's excess table before serving, as cmd/device_plugin.py does
    # (kubelet_plugin.py:125-150)
    from vtpu_manager_torch.manager.obs_calibrate import maybe_calibrate
    obs_table = maybe_calibrate(real_chips=not args.fake_chips)
    log.info("obs-overhead calibration: %s", obs_table or "unavailable")

    state = DeviceState(args.node_name, chips, base_dir=args.base_dir,
                        cdi_dir=args.cdi_dir, node_config=node_config,
                        minors=result.minors, shim_host_dir=args.driver_dir,
                        lock_dir=args.lock_dir,
                        vmem_dir=os.path.dirname(args.vmem_path),
                        watcher_dir=args.watcher_dir,
                        real_libcuda_path=args.real_libcuda_path,
                        obs_excess_table=obs_table)
    client = in_cluster_client(args.service_account_dir)
    if client is None:
        log.warning("claims cannot be fetched and the slice is not "
                    "published")
    elif obs_table is not None:
        # the annotation the device plugin's path publishes
        from vtpu_manager_torch.util import consts
        try:
            client.patch_node_annotations(
                args.node_name,
                {consts.node_obs_overhead_annotation(): obs_table})
        # the annotation is for observation only
        except Exception as e:  # noqa: BLE001
            log.warning("obs table annotation publish failed: %s", e)
    driver = DraDriver(args.node_name, ClaimSource(client), state,
                       plugin_dir=args.plugin_dir)
    driver.serve()

    readiness = Readiness()
    readiness.set("driver", True)
    readyz = None
    if args.health_port >= 0:
        try:
            readyz = ReadinessServer(readiness, port=args.health_port,
                                     host=args.health_host)
            readyz.start()
        except OSError as e:
            log.warning("readiness endpoint unavailable: %s", e)

    registration = RegistrationServer(driver.socket_path,
                                      registry_dir=args.registry_dir)
    try:
        registration.serve()
        readiness.set("registration", True)
    except Exception as e:  # noqa: BLE001 - reported by /readyz
        log.warning("plugin registration socket unavailable: %s", e)
        readiness.set("registration", False, f"registration socket: {e}")
        registration = None

    nri_session = None
    if args.nri_socket or gates.enabled(fg.NRI_SUPPORT):
        from vtpu_manager_torch.kubeletplugin.nri import RuntimeHook
        from vtpu_manager_torch.kubeletplugin.nri_transport import (
            DEFAULT_SOCKET, NriPlugin)
        from vtpu_manager_torch.util.ttrpc import TtrpcError
        nri_socket = args.nri_socket or DEFAULT_SOCKET
        try:
            nri_session = NriPlugin(
                RuntimeHook(state),
                claim_uids_for_pod=driver.claim_uids_for_pod,
            ).run(nri_socket)
            log.info("NRI runtime hook registered on %s", nri_socket)
            readiness.set("nri", True)
        except (OSError, TtrpcError) as e:
            # the CDI spec still wires tenants; the hook's check is what is
            # missing, and /readyz says so
            log.warning("NRI socket unavailable (%s); going on without the "
                        "runtime hook", e)
            readiness.set("nri", False, f"requested but not attached: {e}")

    def slice_built(updated) -> None:
        rs = build_resource_slice(args.node_name, updated)
        log.info("ResourceSlice: %d devices (%d healthy), %d shared counter "
                 "sets", len(rs["spec"]["devices"]),
                 sum(d["basic"]["attributes"]["healthy"]["bool"]
                     for d in rs["spec"]["devices"]),
                 len(rs["spec"]["sharedCounters"]))
        if client is not None:
            log.info("ResourceSlice published: %s",
                     publish_resource_slice(client, rs))

    slice_built(chips)

    if args.health_probe_cmd:
        probe = make_external_probe(args.health_probe_cmd)
    elif args.fake_chips:
        probe = lambda chip: chip.healthy    # noqa: E731 - no device nodes
    else:
        probe = device_node_probe(result.minors)
    health = DraHealthWatcher(chips, probe, slice_built)
    health.start()

    log.info("DRA driver running on %s", driver.socket_path)
    stop.wait()
    log.info("stopping")
    health.stop()
    if nri_session is not None:
        nri_session.close()
    driver.stop()
    if registration is not None:
        registration.stop()
    if readyz is not None:
        readyz.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
