"""The port's node exporter: each tenant's slice of the node's cards, as
Prometheus metrics.

    python -m vtpu_manager_torch.cmd.device_monitor --node-name n1 \\
        [--port 9394] [--metrics-token-file <file>] [--fake-chips 1]
        [--feature-gates CommTelemetry=true,HBMOvercommit=true]

The port of the JAX package's `cmd/device_monitor.py`, served over the
standard library (`http.server.ThreadingHTTPServer`; the card machine has
no aiohttp, grpc or protobuf):

- `/metrics`: the collector's scrape (`metrics/collector.NodeCollector`),
  then the trace block of the span spools (after reaping dead processes'
  spools), then this process's retry and breaker counters;
- `/traces`: the spools assembled into per-pod timelines, or one pod's
  timeline and critical path with `?pod=<uid or trace id>`;
- `/healthz`: `ok`;
- `/debug/stacks` with `--debug-endpoints`: every thread's stack
  (`util/debug.format_stacks`), behind the same token as `/metrics`;
- `/cache/entry?key=<64 hex>` with ClusterCompileCache: the raw entry
  (24-byte header and payload) of the node compile cache under
  `<base-dir>/compilecache`, verified as it is read, for a cold peer's
  fetch (JAX `cmd/device_monitor.py:574-600, 624-627`), behind the same
  token as `/metrics`. A key that is not 64 lowercase hex gets 400; a
  missing entry 404, and a corrupt one is quarantined and gets 404. With
  the gate off there is no route (404).

CommTelemetry renders the tenants' `vtpu_tenant_comm_*` families from
the step rings' comm block (JAX `metrics/collector.py:78, 111-115`).
HBMOvercommit renders the node's spill series (`vtpu_node_spill_*`, JAX
`metrics/collector.py:580-620`) from the rings' spill block and the host
pool beside the ledger (`<dir of --vmem-path>/spill`).

FaultInjection arms the failpoint registry from `VTPU_FAILPOINTS` (seed
`VTPU_FAILPOINTS_SEED`), as the JAX monitor does; a malformed spec exits
2.

With `--metrics-token-file`, `/metrics` and `/traces` want
`Authorization: Bearer <token>`; the file is read again on every request
(a rotated secret takes effect at once), and an empty file refuses to
start. Discovery is NVML's, or `--fake-chips N` synthetic H100s, shaped
by `--node-config` (the device plugin's file: split count, memory
scaling, exclusions) so the exporter counts the slots the plugin
advertises; the JAX monitor has no such flag and reports the discovery's
default split. Other flags keep their JAX names. Those of parts not
ported yet, and their gates set true, exit 2 naming what is missing; the
routes the JAX monitor serves only behind those gates answer 404, as they
do there with the gates off.
`--port 0` takes a free port; the log line `vtpu-monitor on host:port`
names it.
"""

from __future__ import annotations

import argparse
import hmac
import json
import logging
import os
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

# JAX flags of parts not ported yet: refused when given
NOT_PORTED_FLAGS = {
    "--explain-dir": "the decision-explain spools (DecisionExplain)",
    "--fake-client": "the cluster fan-ins (/utilization, /explain)",
}
# JAX gates of planes not ported yet: refused when set true
NOT_PORTED_GATES = {
    "UtilizationLedger": "the utilization ledger and /utilization",
    "DecisionExplain": "the decision audit and /explain",
    "SLOAttribution": "SLO attribution and /slo",
    "SLOAutopilot": "the SLO autopilot and /autopilot",
    "FragObservatory": "the fragmentation observatory and /fragmentation",
    "QuotaMarket": "the quota market",
    "HealthPlane": "the health plane",
}

log = logging.getLogger("vtpu-device-monitor")


def parse_args(argv: list[str] | None) -> argparse.Namespace:
    from vtpu_manager_torch.util import consts

    ap = argparse.ArgumentParser(description="vtpu metrics exporter (CUDA)")
    ap.add_argument("--port", type=int, default=9394)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""))
    ap.add_argument("--fake-chips", type=int, default=0,
                    help="N synthetic H100s instead of NVML discovery")
    ap.add_argument("--node-config",
                    help="the device plugin's node config file")
    ap.add_argument("--base-dir", default=consts.MANAGER_BASE_DIR,
                    help="container-config root (default: %(default)s)")
    ap.add_argument("--tc-path", default=consts.TC_UTIL_CONFIG)
    ap.add_argument("--vmem-path", default=consts.VMEM_NODE_CONFIG)
    ap.add_argument("--trace-spool-dir", default=consts.TRACE_DIR,
                    help="span spool dir served on /traces and as the "
                    "vtpu_trace_* families (default: %(default)s)")
    ap.add_argument("--pod-resources-socket", default=None,
                    help="kubelet's pod-resources socket (default: its "
                    "well-known path)")
    ap.add_argument("--kubelet-checkpoint", default=None,
                    help="kubelet's device-manager checkpoint, the "
                    "fallback when the socket does not answer")
    ap.add_argument("--feature-gates", default="")
    ap.add_argument("--metrics-token-file", default=None,
                    help="require 'Authorization: Bearer <token>' on "
                    "/metrics and /traces, the token read from this file")
    ap.add_argument("--explain-dir", default=None)
    ap.add_argument("--fake-client", action="store_true")
    ap.add_argument("--debug-endpoints", action="store_true")
    ap.add_argument("-v", "--verbose", action="count", default=0)
    args = ap.parse_args(argv)
    for flag, part in NOT_PORTED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            ap.error(f"{flag}: {part} is not ported yet")
    return args


def split_gates(spec: str) -> tuple[str, list[str]]:
    """(the spec without the unported gates, the unported gates set
    true). An unported gate set false is what the port does anyway."""
    kept, refused = [], []
    for part in spec.split(","):
        name, _, value = part.partition("=")
        if name.strip() in NOT_PORTED_GATES:
            if value.strip().lower() != "false":
                refused.append(name.strip())
        elif part.strip():
            kept.append(part)
    return ",".join(kept), refused


def make_handler(collector, args, read_token, cache_root: str | None = None):
    """The request handler; `cache_root` (ClusterCompileCache) serves
    /cache/entry from that store."""
    from vtpu_manager_torch.resilience.policy import render_resilience_metrics
    from vtpu_manager_torch.trace import assemble
    from vtpu_manager_torch.trace.metrics import render_trace_metrics
    from vtpu_manager_torch.trace.recorder import reap_stale_spools
    from vtpu_manager_torch.util.debug import format_stacks

    # one scrape at a time: the collector's folds keep state across
    # scrapes (ring cursors, peaks, the kubelet-view cache)
    scrape_lock = threading.Lock()

    def metrics_text() -> str:
        with scrape_lock:
            text = collector.render()
            reap_stale_spools(args.trace_spool_dir)
            text += render_trace_metrics(args.trace_spool_dir)
        return text + render_resilience_metrics() + "\n"

    def traces_doc(pod: str) -> tuple[int, dict]:
        reap_stale_spools(args.trace_spool_dir)
        spans, drops = assemble.read_spools(args.trace_spool_dir)
        timelines = assemble.assemble(spans)
        if pod:
            tl = assemble.find_timeline(timelines, pod)
            if tl is None:
                return 404, {"error": f"no trace for pod {pod}"}
            return 200, {"timeline": tl.to_wire(),
                         "critical_path": assemble.critical_path(tl)}
        return 200, {"pods": sorted(timelines),
                     "timelines": [tl.to_wire() for tl in timelines.values()],
                     "outliers": assemble.outliers(spans),
                     "spool_drops": sum(drops.values())}

    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, body: str, ctype: str) -> None:
            raw = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", f"{ctype}; charset=utf-8")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def _json(self, status: int, doc: dict) -> None:
            self._send(status, json.dumps(doc), "application/json")

        def _authorized(self) -> bool:
            if not args.metrics_token_file:
                return True
            auth = self.headers.get("Authorization", "")
            return hmac.compare_digest(auth.encode(),
                                       f"Bearer {read_token()}".encode())

        def do_GET(self) -> None:  # noqa: N802 - http.server's name
            url = urlsplit(self.path)
            try:
                if url.path == "/healthz":
                    self._send(200, "ok", "text/plain")
                elif url.path == "/metrics":
                    if not self._authorized():
                        self._send(401, "unauthorized\n", "text/plain")
                    else:
                        self._send(200, metrics_text(), "text/plain")
                elif url.path == "/traces":
                    if not self._authorized():
                        self._json(401, {"error": "unauthorized"})
                    else:
                        pod = parse_qs(url.query).get("pod", [""])[0]
                        self._json(*traces_doc(pod))
                elif url.path == "/cache/entry" and cache_root is not None:
                    self._cache_entry(parse_qs(url.query).get("key",
                                                              [""])[0])
                elif url.path == "/debug/stacks" and args.debug_endpoints:
                    # stacks disclose internals: opt-in, and behind the
                    # token when one is configured
                    if not self._authorized():
                        self._send(401, "unauthorized\n", "text/plain")
                    else:
                        self._send(200, format_stacks(), "text/plain")
                else:
                    self._send(404, "404: Not Found", "text/plain")
            except Exception:  # noqa: BLE001 - one request, not the server
                log.exception("%s failed", url.path)
                self._send(500, "500: Internal Server Error", "text/plain")

        def _cache_entry(self, key: str) -> None:
            from vtpu_manager_torch.clustercache import (
                advertise, read_entry_for_serving)
            if not self._authorized():
                self._send(401, "unauthorized\n", "text/plain")
            elif not advertise.valid_entry_key(key):
                # the key names a file under entries/: anything else is a
                # protocol error, or a path traversal
                self._send(400, "bad entry key\n", "text/plain")
            elif (raw := read_entry_for_serving(cache_root, key)) is None:
                self._send(404, "no such entry\n", "text/plain")
            else:
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        def log_message(self, fmt, *a) -> None:
            log.debug("%s " + fmt, self.address_string(), *a)

    return Handler


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    from vtpu_manager_torch.config.node_config import (load_node_config,
                                                       shape_chips)
    from vtpu_manager_torch.metrics.collector import NodeCollector
    from vtpu_manager_torch.tpu import discovery
    from vtpu_manager_torch.util import consts
    from vtpu_manager_torch.util import featuregates as fg

    spec, refused = split_gates(args.feature_gates)
    if refused:
        log.error("bad --feature-gates: %s", "; ".join(
            f"{g}: {NOT_PORTED_GATES[g]} is not ported yet" for g in refused))
        return 2
    gates = fg.FeatureGates()
    try:
        gates.parse(spec)
    except ValueError as e:
        log.error("bad --feature-gates: %s", e)
        return 2
    if gates.enabled(fg.FAULT_INJECTION):
        from vtpu_manager_torch.resilience import failpoints
        try:
            failpoints.arm_from_env()
        except ValueError as e:
            log.error("bad failpoint spec: %s", e)
            return 2
        log.info("fault injection on: armed %s", failpoints.armed_sites())

    def read_token() -> str:
        with open(args.metrics_token_file) as f:
            return f.read().strip()

    if args.metrics_token_file and not read_token():
        log.error("metrics token file %s is empty; refusing to start with "
                  "broken auth", args.metrics_token_file)
        return 2

    backends = ([discovery.FakeBackend(n_chips=args.fake_chips)]
                if args.fake_chips else [discovery.NvmlBackend()])
    result = discovery.discover(backends)
    node_name = args.node_name or "unknown"
    chips = shape_chips(result.chips if result else [],
                        load_node_config(args.node_config, node_name),
                        node_name)
    collector = NodeCollector(
        node_name, chips, base_dir=args.base_dir,
        tc_path=args.tc_path, vmem_path=args.vmem_path,
        pod_resources_socket=args.pod_resources_socket,
        kubelet_checkpoint=args.kubelet_checkpoint,
        comm_enabled=gates.enabled(fg.COMM_TELEMETRY),
        overcommit_enabled=gates.enabled(fg.HBM_OVERCOMMIT),
        spill_dir=os.path.join(os.path.dirname(args.vmem_path),
                               os.path.relpath(consts.SPILL_DIR,
                                               consts.VMEM_DIR)))
    cache_root = (os.path.join(args.base_dir, consts.COMPILE_CACHE_SUBDIR)
                  if gates.enabled(fg.CLUSTER_COMPILE_CACHE) else None)
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(collector, args, read_token, cache_root))
    server.daemon_threads = True
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="vtpu-monitor-http").start()
    log.info("vtpu-monitor on %s:%d (%d device(s))", args.host,
             server.server_address[1], len(chips))
    stop.wait()
    server.shutdown()
    server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
