"""The port's device plugin: the node agent that hands out slices of a card.

    python -m vtpu_manager_torch.cmd.device_plugin --node-name n1 \\
        [--fake-client] [--fake-chips 2] [--feature-gates StepTelemetry=true]
        [--feature-gates StepTelemetry=true,CommTelemetry=true]
        [--feature-gates CompileCache=true --compile-cache-budget-mb 4096]
        [--feature-gates CompileCache=true,ClusterCompileCache=true
         --cache-advertise-endpoint 10.0.0.7:9394 --cache-ad-max-pairs 8]
        [--feature-gates Tracing=true --trace-sampling-rate 0.5
         --trace-spool-dir <dir>]
        [--feature-gates ClientMode=true --registry-socket <path>]
        [--feature-gates FaultInjection=true] [--metrics-port 9395]
        [--feature-gates HBMOvercommit=true --spill-budget-gib 16]
        [--feature-gates UtilizationLedger=true]
        [--feature-gates QuotaMarket=true]

The port of the JAX package's `cmd/device_plugin.py:108-290`, the parts
ported so far: discovery (NVML, or `--fake-chips N` synthetic H100s), the
device manager with the node registration and its heartbeat, the
vtpu-number plugin served to kubelet and registered with it (again after
a kubelet restart), the health watcher, and behind gates the vtpu-cores
and vtpu-memory reporters (CorePlugin, MemoryPlugin), the memory ledger
(VMemoryNode), the node's utilization watcher fed by NVML (TCWatcher), the
step rings' pressure annotation (StepTelemetry; with CommTelemetry as
well, Allocate arms the interposer's copies and collectives into the
rings' comm block, and CommTelemetry without StepTelemetry logs a warning
and stays off) and the node compile
cache (CompileCache: Allocate mounts `<base-dir>/compilecache` into every
tenant, and this agent evicts it to `--compile-cache-budget-mb` every
`--compile-cache-evict-interval` seconds; with ClusterCompileCache as
well, Allocate arms the tenants' peer fetch, and this agent publishes the
node's warm entries with the node exporter's `--cache-advertise-endpoint`
(default `$NODE_IP:9394`) every 15 s and writes the other nodes' into
`<base-dir>/compilecache/peers.json`; ClusterCompileCache without
CompileCache logs a warning and stays off), and allocation-path tracing
(Tracing: Allocate's spans spool to `--trace-spool-dir`, for the pods a
`--trace-sampling-rate` share of which the admission mint sampled, and a
traced pod's tenant gets the trace env and, when sampled, the node trace
dir `/etc/vtpu-manager/trace` mounted read-write), the node registry
(ClientMode: tenants' device clients register their pids over
`--registry-socket`, default the path tenants mount; a socket that cannot
be served logs a warning and the plugin runs without client mode, as the
JAX plugin does) and fault injection (FaultInjection: the failpoint
registry armed from `VTPU_FAILPOINTS`, seed `VTPU_FAILPOINTS_SEED`; a
malformed spec exits 2) and memory over-commit (HBMOvercommit: Allocate
stamps each device's virtual capacity from the node's policy and the
`--spill-budget-gib` budget and arms the host pool under the ledger's
directory, and this agent publishes the policy's per-class ratios in the
node's overcommit annotation every 15 s) and the utilization ledger
(UtilizationLedger: every 15 s this agent folds a utilization ledger of
its own and patches the node's reclaimable-headroom annotation,
`utilization/ledger.HeadroomPublisher`, JAX `cmd/device_plugin.py:532-547`;
the overcommit policy folds another, so no two consumers share a fold's
cursors) and the quota market (QuotaMarket: Allocate stamps each tenant's
workload class, and this agent runs `quota/market.QuotaMarketManager`
over a utilization ledger of its own, a pass every 5 s, rewriting the
parties' configs and publishing the node's lease summary; JAX
`cmd/device_plugin.py:607-625`). Under QuotaMarket or HBMOvercommit this
agent also publishes the victim-cost rollup every 15 s
(`quota/victimcost.VictimCostPublisher`, JAX `cmd/device_plugin.py:
627-646`). `--metrics-port` serves this process's
resilience counters (retries, breakers, failpoint fires) on `/metrics`
and answers 404 on any other path; 0, the default, serves nothing.

The API server is reached with the pod's service account
(`client.kube.InClusterClient`: KUBERNETES_SERVICE_HOST and _PORT, the
token and CA under `--service-account-dir`); `--fake-client` serves from
an in-memory client instead. Without API access and without
`--fake-client` the plugin exits 2.

Flags keep their JAX names. A flag of a part not ported yet is refused. A
run that is not root points `--base-dir`, `--vmem-path`,
`--lock-dir`, `--watcher-dir`, `--driver-dir`, `--plugin-dir`, with
Tracing `--trace-spool-dir` and with ClientMode `--registry-socket` at a
directory of its own.
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
    "--lease-namespace": "the reschedule controller",
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
    ap.add_argument("--registry-socket", default=consts.REGISTRY_SOCKET,
                    help="ClientMode: the registry socket (default: the "
                    "path tenants mount)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve this process's resilience counters on "
                    "/metrics (0: off)")
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
    ap.add_argument("--service-account-dir", default=SERVICE_ACCOUNT_DIR,
                    help="the API token and CA (the API server is "
                    "KUBERNETES_SERVICE_HOST:KUBERNETES_SERVICE_PORT)")
    ap.add_argument("--mesh-domain", default="")
    ap.add_argument("--trace-sampling-rate", type=float, default=1.0,
                    help="Tracing: the share of traced pods whose "
                    "node-side spans are recorded")
    ap.add_argument("--trace-spool-dir", default=None,
                    help="Tracing: the span spool dir (default: the node "
                    "trace dir)")
    ap.add_argument("--compile-cache-budget-mb", type=int, default=4096,
                    help="CompileCache: the node compile cache's LRU byte "
                    "budget; this agent runs the evictor, so tenants never "
                    "pay for eviction")
    ap.add_argument("--compile-cache-evict-interval", type=float,
                    default=60.0,
                    help="seconds between evictor passes (which also reap "
                    "crashed writers' temp files and fold exited tenants' "
                    "counters)")
    ap.add_argument("--cache-advertise-endpoint", default=None,
                    help="ClusterCompileCache: host:port of this node's "
                    "exporter, whose /cache/entry peers fetch from "
                    "(default: $NODE_IP:9394 when NODE_IP is set, else "
                    "no peer can fetch from this node)")
    ap.add_argument("--cache-ad-max-pairs", type=int, default=None,
                    help="ClusterCompileCache: the hottest fp=key pairs "
                    "advertised (default 8, at most 32)")
    ap.add_argument("--spill-budget-gib", type=float, default=16.0,
                    help="HBMOvercommit: the node's host spill budget in "
                    "GiB, the bound on the spilled bytes the memory ledger "
                    "accounts")
    for flag in NOT_PORTED:
        ap.add_argument(flag, default=None)
    ap.add_argument("-v", "--verbose", action="count", default=0)
    args = ap.parse_args(argv)
    for flag, part in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag}: {part} is not ported yet")
    return args


def serve_metrics(port: int, host: str = "0.0.0.0"):
    """This process's resilience counters on `/metrics` (JAX
    `cmd/device_plugin.py:397-452`), 404 on any other path, served from a
    daemon thread; the caller shuts the returned server down. The JAX
    endpoint's link-load, health and fragmentation parts render nothing
    with their gates off, and their planes are not ported."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from vtpu_manager_torch.resilience.policy import render_resilience_metrics

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 - http.server's name
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = (render_resilience_metrics() + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a) -> None:
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="vtpu-plugin-metrics").start()
    return server


def comm_telemetry_on(gates) -> bool:
    """Whether Allocate arms CommTelemetry (JAX `cmd/device_plugin.py:
    236-246`): the step ring is the comm block's wire, so the gate without
    StepTelemetry is a configuration error, said loudly, and stays off."""
    from vtpu_manager_torch.util import featuregates as fg
    on = gates.enabled(fg.COMM_TELEMETRY)
    if on and not gates.enabled(fg.STEP_TELEMETRY):
        logging.getLogger("vtpu-device-plugin").warning(
            "CommTelemetry=true requires StepTelemetry=true (the step ring "
            "is the comm block's wire); the comm plane stays disarmed")
        on = False
    return on


def configure_vnum(vnum, gates) -> None:
    """What the gates arm in the vtpu-number plugin's Allocate (JAX
    `cmd/device_plugin.py:232-261`): honoured preferred ids, the workload
    class stamped under QuotaMarket, the step ring, the comm block, the
    compile cache and its cluster tier. ClusterCompileCache without
    CompileCache is a configuration error, said loudly, and stays off."""
    from vtpu_manager_torch.util import featuregates as fg
    vnum.preferred_allocation_available = gates.enabled(fg.HONOR_PREALLOC_IDS)
    vnum.quota_market_enabled = gates.enabled(fg.QUOTA_MARKET)
    vnum.step_telemetry_enabled = gates.enabled(fg.STEP_TELEMETRY)
    vnum.comm_telemetry_enabled = comm_telemetry_on(gates)
    vnum.compile_cache_enabled = gates.enabled(fg.COMPILE_CACHE)
    # the cluster tier lands its fetches in the node store
    cluster_cache_on = gates.enabled(fg.CLUSTER_COMPILE_CACHE)
    if cluster_cache_on and not vnum.compile_cache_enabled:
        logging.getLogger("vtpu-device-plugin").warning(
            "ClusterCompileCache=true requires CompileCache=true; the "
            "cluster tier stays disarmed")
        cluster_cache_on = False
    vnum.cluster_cache_enabled = cluster_cache_on


def start_overcommit(vnum, client, node_name: str, chips: list,
                     base_dir: str, tc_path: str, budget_gib: float,
                     interval_s: float = 15.0):
    """HBMOvercommit's node half (JAX `cmd/device_plugin.py:262-267,
    549-577`): Allocate stamps virtual capacity from the policy's current
    ratio and the node's spill budget and arms the host pool, and this
    agent, the owner of the node's annotations, publishes the policy's
    rollup every `interval_s`, reaping the pool's files of dead spillers
    first. The policy folds a utilization ledger of its own (its own
    cursors). Returns the started publisher; the caller stops it."""
    from vtpu_manager_torch.overcommit.policy import (OvercommitPolicy,
                                                      OvercommitPublisher)
    from vtpu_manager_torch.utilization import UtilizationLedger
    vnum.hbm_overcommit_enabled = True
    vnum.spill_budget_bytes = int(budget_gib * 2**30)
    vnum.overcommit_policy = OvercommitPolicy(
        UtilizationLedger(node_name, chips, base_dir=base_dir,
                          tc_path=tc_path))
    publisher = OvercommitPublisher(client, node_name, vnum.overcommit_policy,
                                    interval_s=interval_s,
                                    pool_dir=vnum.spill_pool_host_dir())
    publisher.start()
    logging.getLogger("vtpu-device-plugin").info(
        "overcommit policy publisher running (budget %.1f GiB)", budget_gib)
    return publisher


def start_headroom(client, node_name: str, chips: list, base_dir: str,
                   tc_path: str, interval_s: float = 15.0):
    """UtilizationLedger's node half (JAX `cmd/device_plugin.py:532-547`):
    this agent, the owner of the node's annotations, folds a utilization
    ledger of its own and publishes its reclaimable headroom every
    `interval_s`. Returns the started publisher; the caller stops it."""
    from vtpu_manager_torch.utilization import (HeadroomPublisher,
                                                UtilizationLedger)
    publisher = HeadroomPublisher(
        client, node_name,
        UtilizationLedger(node_name, chips, base_dir=base_dir,
                          tc_path=tc_path),
        interval_s=interval_s)
    publisher.start()
    logging.getLogger("vtpu-device-plugin").info(
        "utilization headroom publisher running")
    return publisher


def start_market(client, node_name: str, chips: list, base_dir: str,
                 tc_path: str):
    """QuotaMarket's node half (JAX `cmd/device_plugin.py:607-625`): this
    agent, the writer of the tenants' configs, lends a card's measured
    idle compute between them in bounded, TTL'd leases, over a
    utilization ledger of its own (its own cursors). The restart rule
    (`recover`) runs before the first pass. Returns the started market;
    the caller stops it."""
    from vtpu_manager_torch.quota import QuotaMarketManager
    from vtpu_manager_torch.utilization import UtilizationLedger
    market = QuotaMarketManager(
        node_name, base_dir,
        UtilizationLedger(node_name, chips, base_dir=base_dir,
                          tc_path=tc_path),
        client=client)
    market.start()
    logging.getLogger("vtpu-device-plugin").info(
        "quota market manager running (ledger %s)", market.ledger.path)
    return market


def start_victim_costs(client, node_name: str, base_dir: str,
                       vmem_path: str, leases: bool, spill: bool):
    """The victim-cost rollup (JAX `cmd/device_plugin.py:627-646`), under
    QuotaMarket (`leases`: who holds a borrow lease) or HBMOvercommit
    (`spill`: how much of each tenant is in the host pool). Returns the
    started publisher; the caller stops it."""
    from vtpu_manager_torch.quota.victimcost import VictimCostPublisher
    publisher = VictimCostPublisher(client, node_name, base_dir,
                                    vmem_path=vmem_path,
                                    include_leases=leases,
                                    include_spill=spill)
    publisher.start()
    logging.getLogger("vtpu-device-plugin").info(
        "victim-cost publisher running (leases=%s spill=%s)", leases, spill)
    return publisher


def start_cache_evictor(root: str, budget_bytes: int, interval_s: float,
                        stop: threading.Event) -> bool:
    """The node compile cache's janitor (JAX `cmd/device_plugin.py:
    454-486`): every `interval_s` an LRU pass to the budget, which also
    reaps crashed writers' temp files and folds exited tenants' counters.
    False when the cache root cannot be made."""
    from vtpu_manager_torch.compilecache import CompileCache
    log = logging.getLogger("vtpu-device-plugin")
    try:
        cache = CompileCache(root)
    except OSError as e:
        log.warning("compile cache root %s unavailable (%s); evictor "
                    "disabled", root, e)
        return False

    def loop():
        while not stop.wait(interval_s):
            try:
                cache.evict(budget_bytes)
            except OSError:
                log.warning("compile cache evictor pass failed",
                            exc_info=True)

    threading.Thread(target=loop, daemon=True, name="vtcc-evictor").start()
    log.info("compile cache at %s (budget %d MiB)", root, budget_bytes >> 20)
    return True


def start_cache_advertiser(client, node_name: str, root: str,
                           endpoint: str | None, max_pairs: int | None):
    """The cluster tier's advertiser (JAX `cmd/device_plugin.py:
    485-515`), started; the caller stops it."""
    from vtpu_manager_torch.clustercache import CacheAdvertiser
    from vtpu_manager_torch.clustercache.advertise import (MAX_AD_KEYS,
                                                           MAX_AD_KEYS_LIMIT)
    log = logging.getLogger("vtpu-device-plugin")
    if endpoint is None:
        node_ip = os.environ.get("NODE_IP", "")
        endpoint = f"{node_ip}:9394" if node_ip else ""
    if not endpoint:
        log.warning("no --cache-advertise-endpoint / NODE_IP: no peer can "
                    "fetch from this node")
    if max_pairs is None:
        max_pairs = MAX_AD_KEYS
    elif not 1 <= max_pairs <= MAX_AD_KEYS_LIMIT:
        log.warning("--cache-ad-max-pairs=%d outside 1..%d; clamping",
                    max_pairs, MAX_AD_KEYS_LIMIT)
    advertiser = CacheAdvertiser(client, node_name, root, endpoint=endpoint,
                                 max_keys=max_pairs)
    advertiser.start()
    log.info("cluster cache advertiser running (endpoint %r)", endpoint)
    return advertiser


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    # a SIGTERM while the agent starts stops it once started, cleanly
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("vtpu-device-plugin")

    from vtpu_manager_torch.config.node_config import load_node_config
    from vtpu_manager_torch.deviceplugin.base import PluginServer
    from vtpu_manager_torch.deviceplugin.reporters import (VcorePlugin,
                                                           VmemPlugin)
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
    if gates.enabled(fg.TRACING):
        from vtpu_manager_torch import trace
        trace.configure("plugin", spool_dir=args.trace_spool_dir,
                        sampling_rate=args.trace_sampling_rate)
        log.info("tracing on: spans to %s at sampling rate %g",
                 trace.recorder().spool_dir, trace.sampling_rate())
    if gates.enabled(fg.FAULT_INJECTION):
        # chaos and staging only; with the gate off every site is one
        # dict lookup
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
    if args.fake_client:
        from vtpu_manager_torch.client.fake import FakeKubeClient
        client = FakeKubeClient(upsert_on_patch=True)
        client.add_node({"metadata": {"name": args.node_name,
                                      "annotations": {}}})
    else:
        client = in_cluster_client(args.service_account_dir)
        if client is None:
            log.error("no in-cluster API access; run in a pod with a "
                      "service account, or with --fake-client")
            return 2

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
    # the card's excess table, measured before serving while the card is
    # free (device_plugin.py:212-219); VTPU_OBS_CALIBRATE gates it
    from vtpu_manager_torch.manager.obs_calibrate import maybe_calibrate
    table = maybe_calibrate(real_chips=not args.fake_chips)
    if table is not None:
        manager.calibrate_obs_overhead(table=table)
        log.info("obs excess table calibrated: %s", table)
    else:
        log.info("obs-overhead calibration skipped or unavailable; the "
                 "interposers probe")
    manager.register_node()
    manager.start_heartbeat()

    vnum = VnumPlugin(manager, client, args.node_name,
                      node_config=node_config, base_dir=args.base_dir,
                      shim_host_dir=args.driver_dir,
                      real_libcuda_path=args.real_libcuda_path,
                      lock_dir=args.lock_dir,
                      vmem_dir=os.path.dirname(args.vmem_path),
                      watcher_dir=args.watcher_dir)
    configure_vnum(vnum, gates)
    cluster_cache_on = vnum.cluster_cache_enabled
    plugins = [vnum]
    if gates.enabled(fg.CORE_PLUGIN):
        plugins.append(VcorePlugin(manager))
    if gates.enabled(fg.MEMORY_PLUGIN):
        plugins.append(VmemPlugin(manager))
    servers = []
    for plugin in plugins:
        server = PluginServer(plugin, plugin_dir=args.plugin_dir)
        server.serve()
        try:
            server.register()
        except Exception:  # noqa: BLE001 - no kubelet listening yet
            log.warning("kubelet registration failed for %s (no kubelet?)",
                        plugin.resource_name)
        server.watch_kubelet_restarts()
        servers.append(server)

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
        if manager.obs_excess_table is not None:
            # the live channel: a running interposer adopts the feed's
            # table (device_plugin.py:383-394)
            from vtpu_manager_torch.manager.obs_calibrate import decode_table
            try:
                watcher.publish_calibration(
                    decode_table(manager.obs_excess_table))
            except ValueError:
                log.warning("unparseable excess table; feed not seeded")
        watcher.start()
    pressure = None
    if gates.enabled(fg.STEP_TELEMETRY):
        # this agent owns the node's annotations: it scans the step rings
        # and publishes the pressure the scheduler scores by
        from vtpu_manager_torch.telemetry import TenantStepTelemetry
        from vtpu_manager_torch.telemetry.pressure import PressurePublisher
        pressure = PressurePublisher(
            client, args.node_name, TenantStepTelemetry(args.base_dir),
            node_hbm_total=sum(c.memory for c in chips))
        pressure.start()
        log.info("step-telemetry pressure publisher running")

    headroom = None
    if gates.enabled(fg.UTILIZATION_LEDGER):
        from vtpu_manager_torch.util import consts
        headroom = start_headroom(
            client, args.node_name, chips, args.base_dir,
            os.path.join(args.watcher_dir,
                         os.path.basename(consts.TC_UTIL_CONFIG)))

    overcommit = None
    if gates.enabled(fg.HBM_OVERCOMMIT):
        from vtpu_manager_torch.util import consts
        overcommit = start_overcommit(
            vnum, client, args.node_name, chips, args.base_dir,
            os.path.join(args.watcher_dir,
                         os.path.basename(consts.TC_UTIL_CONFIG)),
            args.spill_budget_gib)

    market = None
    if gates.enabled(fg.QUOTA_MARKET):
        from vtpu_manager_torch.util import consts
        market = start_market(
            client, args.node_name, chips, args.base_dir,
            os.path.join(args.watcher_dir,
                         os.path.basename(consts.TC_UTIL_CONFIG)))
    victim_costs = None
    if gates.enabled(fg.QUOTA_MARKET) or gates.enabled(fg.HBM_OVERCOMMIT):
        victim_costs = start_victim_costs(
            client, args.node_name, args.base_dir, args.vmem_path,
            leases=gates.enabled(fg.QUOTA_MARKET),
            spill=gates.enabled(fg.HBM_OVERCOMMIT))

    registry = None
    if gates.enabled(fg.CLIENT_MODE):
        # tenants' device clients register their pids here (SO_PEERCRED
        # and the cgroup check attest them)
        from vtpu_manager_torch.registry.server import RegistryServer
        registry = RegistryServer(socket_path=args.registry_socket,
                                  base_dir=args.base_dir)
        try:
            registry.start()
        except OSError as e:
            log.warning("registry socket unavailable (%s); client-mode "
                        "pid attribution disabled", e)
            registry = None
    metrics = None
    if args.metrics_port:
        metrics = serve_metrics(args.metrics_port)
        log.info("resilience metrics on :%d/metrics",
                 metrics.server_address[1])

    advertiser = None
    if gates.enabled(fg.COMPILE_CACHE):
        cache_ok = start_cache_evictor(vnum.compile_cache_host_dir(),
                                       args.compile_cache_budget_mb << 20,
                                       args.compile_cache_evict_interval,
                                       stop)
        if cluster_cache_on and cache_ok:
            advertiser = start_cache_advertiser(
                client, args.node_name, vnum.compile_cache_host_dir(),
                args.cache_advertise_endpoint, args.cache_ad_max_pairs)
    log.info("device plugin running on %s",
             ", ".join(s.socket_path for s in servers))
    stop.wait()
    log.info("stopping")
    health.stop()
    if watcher is not None:
        watcher.stop()
    if pressure is not None:
        pressure.stop()
    if headroom is not None:
        headroom.stop()
    if overcommit is not None:
        overcommit.stop()
    if victim_costs is not None:
        victim_costs.stop()
    if market is not None:
        market.stop()
    if advertiser is not None:
        advertiser.stop()
    for server in servers:
        server.stop()
    if metrics is not None:
        metrics.shutdown()
        metrics.server_close()
    if registry is not None:
        registry.stop()
    manager.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
