"""The port's node exporter as a process, and the device plugin's new gates.

`python -m vtpu_manager_torch.cmd.device_monitor` on 127.0.0.1 over
`--fake-chips 1` and a temporary node directory, with aiohttp, grpc,
protobuf and yaml blocked (the card machine has none of them), driven with
urllib: the token rules of the JAX monitor, the refusal of what is not
ported, 404 on the routes the JAX monitor serves only behind a gate, and
/metrics equal to the collector's render followed by the trace and
resilience blocks. Then the device plugin's CorePlugin, MemoryPlugin and
StepTelemetry gates.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from vtpu_manager.trace.recorder import Span as JaxSpan
from vtpu_manager.trace.recorder import SpanRecorder
from vtpu_manager_torch.cmd import device_monitor as dm
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.vmem import VmemLedger, fnv64
from vtpu_manager_torch.metrics.collector import NodeCollector
from vtpu_manager_torch.resilience import policy
from vtpu_manager_torch.telemetry import stepring
from vtpu_manager_torch.tpu.discovery import FakeBackend
from vtpu_manager_torch.trace.metrics import render_trace_metrics
from vtpu_manager_torch.util import consts

from test_torch_deviceplugin import fake_kubelet
from test_torch_metrics import masked

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "scrape-token"
# what the card machine lacks: the exporter must not even try to import it
BLOCKED = ("aiohttp", "grpc", "google.protobuf", "yaml")
LAUNCH = ("import sys\n"
          f"for name in {BLOCKED!r}:\n"
          "    sys.modules[name] = None\n"
          "from vtpu_manager_torch.cmd.device_monitor import main\n"
          "sys.exit(main(sys.argv[1:]))\n")


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("VTPU_")}
    env["PYTHONPATH"] = REPO
    env["VTPU_MAP_STARTUP_GRACE_S"] = "0"
    return env


def node_dir(root):
    """Two tenants (one with a step ring and ledger bytes), an orphan, a
    kubelet checkpoint naming the first two, and a JAX recorder's spool."""
    base = root / "mgr"
    chip = FakeBackend(1).discover().chips[0]
    for uid, cores in (("uid-a", 50), ("uid-b", 25), ("bogus-uid", 0)):
        vc.write_config(str(base / f"{uid}_main" / "config" / "vtpu.config"),
                        vc.VtpuConfig(pod_uid=uid, container_name="main",
                                      devices=[vc.DeviceConfig(
                                          uuid=chip.uuid, total_memory=2**30,
                                          real_memory=chip.memory,
                                          hard_core=cores, host_index=0)]))
    led = VmemLedger(str(root / "vmem.config"), create=True)
    led.record(4242, 0, 64 << 20, owner_token=fnv64("uid-a/main"))
    led.close()
    ring = base / "uid-a_main" / consts.TELEMETRY_SUBDIR
    ring.mkdir(parents=True)
    w = stepring.StepRingWriter(str(ring / consts.STEP_RING_NAME),
                                trace_id="tr-a")
    for _ in range(5):
        w.record(duration_ns=10**6, throttle_wait_ns=3 * 10**5)
    w.close()
    with open(root / "ckpt", "w") as f:
        json.dump({"Data": {"PodDeviceEntries": [
            {"PodUID": u, "ContainerName": "main",
             "ResourceName": consts.vtpu_number_resource(),
             "DeviceIDs": {"-1": [f"{chip.uuid}::0"]}}
            for u in ("uid-a", "uid-b")]}}, f)
    rec = SpanRecorder("plugin", str(root / "trace"), capacity=8,
                       flush_at=99)
    for stage, start, dur in (("plugin.allocate", 1.0, 0.004),
                              ("plugin.config", 1.01, 0.001)):
        rec.record(JaxSpan(stage=stage, trace_id="tr-a", pod_uid="uid-a",
                           start_s=start, dur_s=dur))
    rec.flush()
    return chip


def exporter_args(root, *extra):
    return ["--host", "127.0.0.1", "--port", "0", "--node-name", "n1",
            "--fake-chips", "1", "--base-dir", str(root / "mgr"),
            "--tc-path", str(root / "tc.config"),
            "--vmem-path", str(root / "vmem.config"),
            "--trace-spool-dir", str(root / "trace"),
            "--kubelet-checkpoint", str(root / "ckpt"),
            "--pod-resources-socket", str(root / "no-kubelet.sock"), *extra]


class Exporter:
    def __init__(self, root, *extra):
        self.log = root / "exporter.log"
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", LAUNCH,
                 *exporter_args(root, *extra)],
                cwd=REPO, env=_env(), stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 60
        while True:
            assert self.proc.poll() is None, self.log.read_text()
            m = re.search(r"vtpu-monitor on 127\.0\.0\.1:(\d+)",
                          self.log.read_text())
            if m:
                self.url = f"http://127.0.0.1:{m.group(1)}"
                return
            assert time.monotonic() < deadline, self.log.read_text()
            time.sleep(0.05)

    def get(self, path, token=None):
        req = urllib.request.Request(self.url + path)
        if token is not None:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, resp.read().decode(), \
                    resp.headers["Content-Type"]
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode(), e.headers["Content-Type"]

    def stop(self):
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=30)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def _serve(root):
    node_dir(root)
    token = root / "token"
    token.write_text(TOKEN + "\n")
    exp = Exporter(root, "--metrics-token-file", str(token))
    yield exp, root, token
    assert exp.stop() == 0


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One exporter for the module's route tests: each exporter is a
    process, and the suite runs beside timing tests."""
    yield from _serve(tmp_path_factory.mktemp("served"))


@pytest.fixture
def fresh(tmp_path):
    """An exporter whose first scrape is the test's: the collector's folds
    keep state from one scrape to the next."""
    yield from _serve(tmp_path)


def test_token_rules(served):
    exp, _, token = served
    assert exp.get("/metrics")[0] == 401
    assert exp.get("/metrics", token="wrong")[0] == 401
    status, body, ctype = exp.get("/metrics", token=TOKEN)
    assert status == 200 and ctype.startswith("text/plain")
    assert "vtpu_node_info" in body
    assert exp.get("/traces")[:2] == (401, '{"error": "unauthorized"}')
    assert exp.get("/healthz")[:2] == (200, "ok")
    # a rotated secret: the next request reads the file again
    token.write_text("rotated")
    try:
        assert exp.get("/metrics", token=TOKEN)[0] == 401
        assert exp.get("/metrics", token="rotated")[0] == 200
    finally:
        token.write_text(TOKEN + "\n")


def test_metrics_is_the_collector_then_trace_and_resilience(fresh,
                                                           monkeypatch):
    from vtpu_manager_torch.metrics import collector
    monkeypatch.setattr(collector, "STARTUP_GRACE_S", 0.0)   # as served
    exp, root, _ = fresh
    status, body, _ = exp.get("/metrics", token=TOKEN)
    assert status == 200
    chips = FakeBackend(1).discover().chips
    ours = NodeCollector(
        "n1", chips, base_dir=str(root / "mgr"),
        tc_path=str(root / "tc.config"), vmem_path=str(root / "vmem.config"),
        pod_resources_socket=str(root / "no-kubelet.sock"),
        kubelet_checkpoint=str(root / "ckpt")).render()
    saved = dict(policy.COUNTERS.data)
    policy.COUNTERS.data.clear()        # the exporter has made no call
    try:
        tail = render_trace_metrics(str(root / "trace")) + \
            policy.render_resilience_metrics() + "\n"
    finally:
        policy.COUNTERS.data.update(saved)
    assert masked(body) == masked(ours + tail)
    assert body.endswith(tail)
    assert ('vtpu_container_memory_used_bytes{node="n1",pod_uid="uid-a",'
            f'container="main",uuid="{chips[0].uuid}"}} {float(64 << 20)}'
            ) in body
    assert ('vtpu_container_pod_mapping_mismatch{node="n1",'
            'pod_uid="bogus-uid",container="main"} 1.0') in body
    assert 'vtpu_node_pod_mapping_source{node="n1"} 1.0' in body
    assert ('vtpu_tenant_step_duration_seconds_count{node="n1",'
            'pod_uid="uid-a",container="main"} 5') in body
    assert ('vtpu_trace_stage_duration_seconds_count'
            '{stage="plugin.allocate"} 1') in body


def test_traces_route(served):
    exp, root, _ = served
    status, body, ctype = exp.get("/traces", token=TOKEN)
    doc = json.loads(body)
    assert status == 200 and ctype.startswith("application/json")
    assert doc["pods"] == ["uid-a"] and doc["spool_drops"] == 0
    assert [s["stage"] for s in doc["timelines"][0]["spans"]] == [
        "plugin.allocate", "plugin.config"]
    status, body, _ = exp.get("/traces?pod=tr-a", token=TOKEN)
    one = json.loads(body)
    assert status == 200 and one["timeline"]["pod_uid"] == "uid-a"
    assert [r["stage"] for r in one["critical_path"]] == [
        "plugin.allocate", "plugin.config"]
    assert exp.get("/traces?pod=nobody", token=TOKEN)[:2] == (
        404, '{"error": "no trace for pod nobody"}')


@pytest.mark.parametrize("route", ["/utilization", "/explain", "/slo",
                                   "/autopilot", "/fragmentation",
                                   "/cache/entry", "/debug/stacks"])
def test_gated_routes_are_absent(served, route):
    exp, _, _ = served
    assert exp.get(route, token=TOKEN)[0] == 404


# The refusals run `main` in this process (`python -m` exits with what it
# returns): each returns before it discovers, binds or serves anything.

def test_empty_token_file_exits_2(tmp_path, caplog):
    node_dir(tmp_path)
    (tmp_path / "token").write_text("\n")
    assert dm.main(exporter_args(tmp_path, "--metrics-token-file",
                                 str(tmp_path / "token"))) == 2
    assert "is empty" in caplog.text


@pytest.mark.parametrize("flag", sorted(dm.NOT_PORTED_FLAGS))
def test_unported_flags_exit_2(tmp_path, flag, capsys):
    extra = [flag] if flag != "--explain-dir" else [flag, str(tmp_path)]
    with pytest.raises(SystemExit) as exit_:
        dm.main(exporter_args(tmp_path, *extra))
    assert exit_.value.code == 2
    assert f"{flag}: {dm.NOT_PORTED_FLAGS[flag]} is not ported yet" in \
        capsys.readouterr().err


@pytest.mark.parametrize("gate", sorted(dm.NOT_PORTED_GATES))
def test_unported_gates_exit_2(tmp_path, gate, caplog):
    assert dm.main(exporter_args(tmp_path, "--feature-gates",
                                 f"StepTelemetry=true,{gate}=true")) == 2
    assert f"{gate}: {dm.NOT_PORTED_GATES[gate]} is not ported yet" in \
        caplog.text


def test_gates_the_port_knows_or_leaves_off_pass():
    spec, refused = dm.split_gates(
        "StepTelemetry=true, DecisionExplain=false,HealthPlane=true,"
        "UtilizationLedger=true,CommTelemetry=true")
    assert refused == ["HealthPlane"]
    assert spec == "StepTelemetry=true,UtilizationLedger=true," \
        "CommTelemetry=true"
    with pytest.raises(SystemExit):
        dm.parse_args(["--explain-dir", "/tmp"])
    assert dm.parse_args(["--fake-client"]).fake_client


def test_node_config_shapes_the_slots(tmp_path):
    node_dir(tmp_path)
    cfg = tmp_path / "node.json"
    cfg.write_text(json.dumps({"default": {"deviceSplitCount": 4}}))
    exp = Exporter(tmp_path, "--node-config", str(cfg))
    try:
        body = exp.get("/metrics")[1]
    finally:
        assert exp.stop() == 0
    assert 'vtpu_node_slots_total{node="n1"} 4.0' in body
    assert ('vtpu_device_cores_assigned_percent{node="n1",uuid="fake-0",'
            'index="0"} 75.0') in body


# --- the device plugin's new gates -----------------------------------------

def test_device_plugin_serves_reporters_and_starts_the_publisher(tmp_path):
    import grpc

    from vtpu_manager_torch.deviceplugin.api import deviceplugin_pb2 as pb
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    registrations = []
    kubelet = fake_kubelet(str(plugins / "kubelet.sock"), registrations)
    log = tmp_path / "plugin.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vtpu_manager_torch.cmd.device_plugin",
             "--node-name", "node-1", "--plugin-dir", str(plugins),
             "--base-dir", str(tmp_path / "mgr"),
             "--vmem-path", str(tmp_path / "vmem" / "vmem_node.config"),
             "--lock-dir", str(tmp_path / "locks"),
             "--watcher-dir", str(tmp_path / "watcher"),
             "--driver-dir", str(tmp_path / "driver"),
             "--fake-chips", "1", "--fake-client", "--feature-gates",
             "CorePlugin=true,MemoryPlugin=true,StepTelemetry=true"],
            cwd=REPO, env=_env(), stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while len(registrations) < 3 or \
                "pressure publisher running" not in log.read_text():
            assert proc.poll() is None, log.read_text()
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.05)
        assert sorted(r[:2] for r in registrations) == sorted([
            (consts.vtpu_number_resource(), "vtpu-number.sock"),
            (consts.vtpu_cores_resource(), "vtpu-cores.sock"),
            (consts.vtpu_memory_resource(), "vtpu-memory.sock")])
        chip = FakeBackend(1).discover().chips[0]
        for sock, want in (("vtpu-cores.sock", 100),
                           ("vtpu-memory.sock", chip.memory // 2**28)):
            with grpc.insecure_channel(f"unix://{plugins / sock}") as chan:
                law = chan.unary_stream(
                    "/v1beta1.DevicePlugin/ListAndWatch",
                    request_serializer=pb.Empty.SerializeToString,
                    response_deserializer=pb.ListAndWatchResponse.FromString)
                assert len(next(iter(law(pb.Empty(), timeout=10))).devices) \
                    == want
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        kubelet.stop(grace=0)


def test_device_plugin_leaves_reporters_off_by_default(tmp_path):
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    registrations = []
    kubelet = fake_kubelet(str(plugins / "kubelet.sock"), registrations)
    log = tmp_path / "plugin.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vtpu_manager_torch.cmd.device_plugin",
             "--node-name", "node-1", "--plugin-dir", str(plugins),
             "--base-dir", str(tmp_path / "mgr"),
             "--vmem-path", str(tmp_path / "vmem" / "vmem_node.config"),
             "--lock-dir", str(tmp_path / "locks"),
             "--watcher-dir", str(tmp_path / "watcher"),
             "--driver-dir", str(tmp_path / "driver"),
             "--fake-chips", "1", "--fake-client"],
            cwd=REPO, env=_env(), stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while "device plugin running" not in log.read_text():
            assert proc.poll() is None, log.read_text()
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.05)
        assert [r[0] for r in registrations] == [
            consts.vtpu_number_resource()]
        assert "pressure publisher" not in log.read_text()
        assert not (plugins / "vtpu-cores.sock").exists()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        kubelet.stop(grace=0)


def test_debug_stacks_behind_the_flag_and_the_token(tmp_path):
    """`--debug-endpoints` (JAX `cmd/device_monitor.py:628-638`): every
    thread's stack on /debug/stacks, behind the /metrics token."""
    token = tmp_path / "token"
    token.write_text(TOKEN + "\n")
    node_dir(tmp_path)
    exp = Exporter(tmp_path, "--debug-endpoints", "--metrics-token-file",
                   str(token))
    try:
        assert exp.get("/debug/stacks")[0] == 401
        status, body, ctype = exp.get("/debug/stacks", token=TOKEN)
        assert status == 200 and ctype.startswith("text/plain")
        assert "--- thread MainThread" in body
        assert "vtpu-monitor-http" in body
    finally:
        assert exp.stop() == 0


def test_fault_injection_arms_the_monitor(tmp_path, monkeypatch, caplog):
    from vtpu_manager_torch.resilience import failpoints
    monkeypatch.setenv("VTPU_FAILPOINTS", "kube.request=explode")
    try:
        assert dm.main(exporter_args(tmp_path, "--feature-gates",
                                     "FaultInjection=true")) == 2
        assert "bad failpoint spec" in caplog.text
        assert not failpoints.is_enabled()
    finally:
        failpoints.disable()
