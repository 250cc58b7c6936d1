"""The port's device-plugin entry point, and the card path without grpc.

`python -m vtpu_manager_torch.cmd.device_plugin` on fake H100s and a fake
API client, with every node path private, registers with a fake kubelet
and answers Allocate over its socket; it refuses what is not ported. The
modules the card runs load, and allocate, with grpc, protobuf and yaml
blocked (the card machine has none of them). And `bench_allocate`'s
stand-in for the container runtime resolves a response's mounts.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from vtpu_manager_torch import bench_allocate
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.deviceplugin.api import messages as api
from vtpu_manager_torch.deviceplugin.vnum import (VnumPlugin, device_id,
                                                  install_interposer)
from vtpu_manager_torch.manager.device_manager import DeviceManager
from vtpu_manager_torch.tpu.discovery import FakeBackend
from vtpu_manager_torch.util import consts

from test_torch_deviceplugin import fake_kubelet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = [sys.executable, "-m", "vtpu_manager_torch.cmd.device_plugin"]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("VTPU_")}
    env["PYTHONPATH"] = REPO
    return env


def private_flags(root):
    return ["--node-name", "node-1", "--plugin-dir", str(root / "plugins"),
            "--base-dir", str(root / "mgr"),
            "--vmem-path", str(root / "vmem" / "vmem_node.config"),
            "--lock-dir", str(root / "locks"),
            "--watcher-dir", str(root / "watcher"),
            "--driver-dir", str(root / "driver")]


def test_entry_registers_and_answers_allocate(tmp_path):
    import grpc

    from vtpu_manager_torch.deviceplugin.api import deviceplugin_pb2 as pb
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    registrations = []
    kubelet = fake_kubelet(str(plugins / "kubelet.sock"), registrations)
    proc = subprocess.Popen(
        ENTRY + private_flags(tmp_path) + [
            "--fake-chips", "2", "--fake-client", "--feature-gates",
            "StepTelemetry=true,TCWatcher=true,VMemoryNode=true"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while not registrations and time.monotonic() < deadline:
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.05)
        assert registrations[0][:3] == (consts.vtpu_number_resource(),
                                        "vtpu-number.sock", "v1beta1")
        with grpc.insecure_channel(
                f"unix://{plugins / 'vtpu-number.sock'}") as chan:
            law = chan.unary_stream(
                "/v1beta1.DevicePlugin/ListAndWatch",
                request_serializer=pb.Empty.SerializeToString,
                response_deserializer=pb.ListAndWatchResponse.FromString)
            assert len(next(iter(law(pb.Empty(), timeout=10))).devices) == 20
            resp = chan.unary_unary(
                "/v1beta1.DevicePlugin/Allocate",
                request_serializer=pb.AllocateRequest.SerializeToString,
                response_deserializer=pb.AllocateResponse.FromString)(
                    pb.AllocateRequest(container_requests=[
                        pb.ContainerAllocateRequest(
                            devicesIDs=["fake-1::3"])]), timeout=10)
        envs = resp.container_responses[0].envs
        assert envs[consts.ENV_NVIDIA_VISIBLE_DEVICES] == "fake-1"
        assert envs[consts.ENV_VISIBLE_DEVICES] == "1"
        # the gates' files: the ledger, and the watcher's feed
        assert (tmp_path / "vmem" / "vmem_node.config").exists()
        deadline = time.monotonic() + 10
        while not (tmp_path / "watcher" / "tc_util.config").exists():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        kubelet.stop(grace=0)


@pytest.mark.parametrize("args,message", [
    (["--fake-client", "--feature-gates", "ICILinkAware=true"],
     "unknown feature gate"),
    (["--fake-client", "--feature-gates", "StepTelemetry=maybe"],
     "invalid feature gate value"),
    # no service account here: the in-cluster client has no API access
    (["--service-account-dir", "no-such-dir"], "no in-cluster API access"),
    (["--fake-client", "--lease-namespace", "vtpu-system"],
     "--lease-namespace: the reschedule controller is not ported yet"),
    (["--fake-client", "--id-store", "ids.json"],
     "--id-store: the device-id store (a GPU needs none) is not ported yet"),
])
def test_entry_refuses_what_is_not_ported(tmp_path, args, message):
    res = subprocess.run(ENTRY + private_flags(tmp_path) + ["--fake-chips",
                                                            "1"] + args,
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=60)
    assert res.returncode != 0
    assert message in res.stdout + res.stderr
    assert not (tmp_path / "plugins").exists()


BLOCKED_CODE = """
import sys
BLOCKED = ("grpc", "google.protobuf", "yaml")
for name in BLOCKED:
    sys.modules[name] = None
import importlib
for name in ("chip_smoke", "vtpu_manager_torch.bench_allocate",
             "vtpu_manager_torch.deviceplugin.vnum",
             "vtpu_manager_torch.deviceplugin.api",
             "vtpu_manager_torch.deviceplugin.api.messages",
             "vtpu_manager_torch.deviceplugin.base",
             "vtpu_manager_torch.telemetry.stepring",
             "vtpu_manager_torch.cmd.device_plugin",
             "vtpu_manager_torch.manager.device_manager",
             "vtpu_manager_torch.config.node_config"):
    importlib.import_module(name)
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.deviceplugin.api import messages as api
from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin
from vtpu_manager_torch.device.claims import DeviceClaim, PodDeviceClaims
from vtpu_manager_torch.manager.device_manager import DeviceManager
from vtpu_manager_torch.tpu.discovery import FakeBackend
from vtpu_manager_torch.util import consts
c = FakeKubeClient()
c.add_node({"metadata": {"name": "n1"}})
m = DeviceManager("n1", c, NodeConfig(device_split_count=2),
                  backends=[FakeBackend(1)])
m.init_devices()
m.register_node()
claims = PodDeviceClaims()
claims.add("main", DeviceClaim("fake-0", 0, 50, 1 << 30))
c.add_pod({"metadata": {"name": "p", "namespace": "default", "uid": "u",
           "annotations": {consts.pre_allocated_annotation():
                           claims.encode()}},
           "spec": {"nodeName": "n1"}})
root = sys.argv[1]
p = VnumPlugin(m, c, "n1", base_dir=root + "/mgr", lock_dir=root + "/l",
               vmem_dir=root + "/v", watcher_dir=root + "/w",
               shim_host_dir=root + "/d")
p.step_telemetry_enabled = True
r = p.allocate(api.AllocateRequest([api.ContainerAllocateRequest(
    ["fake-0::1"])])).container_responses[0]
p.pre_start_container(api.PreStartContainerRequest(["fake-0::1"]))
assert r.envs["VTPU_CORE_LIMIT_0"] == "50", r.envs
bad = sorted(n for n in sys.modules
             if any(n == b or n.startswith(b + ".") for b in BLOCKED)
             and sys.modules[n] is not None)
print("LOADED", bad)
"""


def test_card_path_runs_without_grpc_protobuf_or_yaml(tmp_path):
    res = subprocess.run([sys.executable, "-c", BLOCKED_CODE, str(tmp_path)],
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def _allocated(tmp_path, telemetry=True):
    client = FakeKubeClient()
    client.add_node({"metadata": {"name": bench_allocate.NODE}})
    mgr = DeviceManager(bench_allocate.NODE, client,
                        NodeConfig(device_split_count=4),
                        backends=[FakeBackend(1)])
    mgr.init_devices()
    driver = tmp_path / "driver"
    shim = tmp_path / "built.so"
    shim.write_bytes(b"\x7fELF")
    install_interposer(str(shim), str(driver))
    p = VnumPlugin(mgr, client, bench_allocate.NODE,
                   base_dir=str(tmp_path / "mgr"), shim_host_dir=str(driver),
                   lock_dir=str(tmp_path / "locks"),
                   vmem_dir=str(tmp_path / "vmem"),
                   watcher_dir=str(tmp_path / "watcher"))
    p.step_telemetry_enabled = telemetry
    chip = mgr.chips[0]
    client.add_pod(bench_allocate.committed_pod("pod-x", chip, 25, 1 << 30))
    return p.allocate(api.AllocateRequest([api.ContainerAllocateRequest(
        [device_id(chip.uuid, 0)])])).container_responses[0], chip


def test_container_env_resolves_the_mounts(tmp_path, monkeypatch):
    monkeypatch.setenv("VTPU_CORE_LIMIT_0", "99")     # the caller's own
    monkeypatch.setenv("LD_PRELOAD", "/elsewhere.so")
    resp, chip = _allocated(tmp_path)
    env = bench_allocate.container_env(resp)
    cont = tmp_path / "mgr" / "uid-pod-x_main"
    assert env[consts.ENV_LD_PRELOAD] == env[consts.ENV_SHIM_PATH] == str(
        tmp_path / "driver" / consts.CONTROL_LIBRARY_NAME)
    assert consts.ENV_TRACE_DIR not in env
    assert env["CUDA_VISIBLE_DEVICES"] == chip.uuid
    assert env[consts.ENV_CONFIG_PATH] == str(cont / "config" /
                                              "vtpu.config")
    assert env[consts.ENV_STEP_RING_PATH] == str(
        cont / consts.TELEMETRY_SUBDIR / consts.STEP_RING_NAME)
    assert env[consts.ENV_LOCK_DIR] == str(tmp_path / "locks")
    assert env[consts.ENV_VMEM_PATH] == str(tmp_path / "vmem" /
                                            "vmem_node.config")
    assert env[consts.ENV_TC_UTIL_PATH] == str(tmp_path / "watcher" /
                                               "tc_util.config")
    assert env["VTPU_CORE_LIMIT_0"] == "25"          # the response's
    assert env[consts.ENV_REAL_CUDA_LIBRARY_PATH] == "libcuda.so.1"
    assert bench_allocate.host_path(resp, "/not/mounted") == "/not/mounted"


def test_container_env_without_the_ring(tmp_path):
    resp, _ = _allocated(tmp_path, telemetry=False)
    env = bench_allocate.container_env(resp)
    assert consts.ENV_STEP_RING_PATH not in env
    assert consts.ENV_STEP_TELEMETRY not in env


# --- the DRA kubelet plugin's entry point -------------------------------------

KUBELET_PLUGIN = [sys.executable, "-m", "vtpu_manager_torch.cmd.kubelet_plugin"]


def kubelet_plugin_flags(root, registry_dir=None):
    return ["--node-name", "node-1", "--plugin-dir", str(root / "plugins"),
            "--registry-dir", registry_dir or str(root / "registry"),
            "--base-dir", str(root / "mgr"), "--cdi-dir", str(root / "cdi"),
            "--vmem-path", str(root / "vmem" / "vmem_node.config"),
            "--lock-dir", str(root / "locks"),
            "--watcher-dir", str(root / "watcher"),
            "--driver-dir", str(root / "driver")]


def test_kubelet_plugin_serves_dra_and_registration(tmp_path):
    import json
    import shutil
    import tempfile
    import urllib.request
    from pathlib import Path

    import grpc

    from vtpu_manager_torch.kubeletplugin.api import dra_pb2 as pb
    from vtpu_manager_torch.kubeletplugin.api import \
        pluginregistration_pb2 as rpb
    # a unix socket's path has at most 107 bytes; the registration
    # socket's name alone takes 33
    registry = tempfile.mkdtemp(prefix="reg-")
    node_config = tmp_path / "node.json"
    node_config.write_text('{"default": {"deviceSplitCount": 4}}')
    proc = subprocess.Popen(
        KUBELET_PLUGIN + kubelet_plugin_flags(tmp_path, registry)
        + ["--fake-chips", "2", "--node-config", str(node_config),
           "--health-port", "0", "--health-host", "127.0.0.1"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    dra_sock = tmp_path / "plugins" / "dra.sock"
    reg_sock = Path(registry) / f"{consts.DRA_DRIVER_NAME}-reg.sock"
    try:
        lines = []
        while not lines or "DRA driver running on" not in lines[-1]:
            line = proc.stdout.readline()
            assert line, "".join(lines)        # exited before serving
            lines.append(line)
        log = "".join(lines)
        assert dra_sock.exists() and reg_sock.exists(), log
        # the node config's split shapes the slice: 2 cards x 4 slots
        assert "ResourceSlice: 8 devices (8 healthy)" in log, log
        port = int(log.split("readiness endpoint on :")[1].split()[0])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/readyz", timeout=10) as r:
            ready = json.loads(r.read())
        assert set(ready["components"]) == {"driver", "registration"}
        with grpc.insecure_channel(f"unix://{reg_sock}") as chan:
            info = chan.unary_unary(
                "/pluginregistration.Registration/GetInfo",
                request_serializer=rpb.InfoRequest.SerializeToString,
                response_deserializer=rpb.PluginInfo.FromString)(
                    rpb.InfoRequest(), timeout=10)
        assert (info.name, info.endpoint) == (consts.DRA_DRIVER_NAME,
                                              str(dra_sock))
        with grpc.insecure_channel(f"unix://{dra_sock}") as chan:
            resp = chan.unary_unary(
                "/v1beta1dra.DRAPlugin/NodePrepareResources",
                request_serializer=
                pb.NodePrepareResourcesRequest.SerializeToString,
                response_deserializer=
                pb.NodePrepareResourcesResponse.FromString)(
                    pb.NodePrepareResourcesRequest(claims=[
                        pb.Claim(uid="u1", name="c1", namespace="ml")]),
                    timeout=10)
        assert "claim ml/c1 not found" in resp.claims["u1"].error
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not reg_sock.exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(registry, ignore_errors=True)


@pytest.mark.parametrize("args,message", [
    (["--id-store", "ids.json"],
     "--id-store: the device-id store (a GPU needs none) is not ported yet"),
    (["--feature-gates", "ICILinkAware=true"],
     "unknown feature gate"),
])
def test_kubelet_plugin_refuses_what_is_not_ported(tmp_path, args, message):
    res = subprocess.run(KUBELET_PLUGIN + kubelet_plugin_flags(tmp_path)
                         + ["--fake-chips", "1"] + args, cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 2
    assert message in res.stdout + res.stderr
    assert not (tmp_path / "plugins").exists()


def _serve_until(cmd: list[str], marker: str, env: dict | None = None
                 ) -> str:
    """Starts an agent (with `env` over a clean environment), reads its log
    until `marker`, stops it with SIGTERM (exit 0) and returns the log."""
    proc = subprocess.Popen(cmd, cwd=REPO, env={**_env(), **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        lines = []
        while not lines or marker not in lines[-1]:
            line = proc.stdout.readline()
            assert line, "".join(lines)        # exited before serving
            lines.append(line)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        return "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# the tracing cases the kubelet plugin refused before slice 10: the gate
# and both flags are taken (the flags alone, as in the JAX command, trace
# nothing). The spool dir is always the test's own: a tracing agent writes
# its meta line at its first flush.
@pytest.mark.parametrize("args,message", [
    (["--feature-gates", "StepTelemetry=true,Tracing=true",
      "--trace-spool-dir", "{spool}"],
     "tracing on: spans to {spool} at sampling rate 1"),
    (["--trace-sampling-rate", "0.5"], None),
    (["--trace-spool-dir", "{spool}"], None),
    (["--feature-gates", "Tracing=true", "--trace-sampling-rate", "0.25",
      "--trace-spool-dir", "{spool}"],
     "tracing on: spans to {spool} at sampling rate 0.25"),
])
def test_kubelet_plugin_takes_tracing(tmp_path, args, message):
    import shutil
    import tempfile
    spool = str(tmp_path / "spool")
    registry = tempfile.mkdtemp(prefix="reg-")
    try:
        log = _serve_until(KUBELET_PLUGIN + kubelet_plugin_flags(
            tmp_path, registry) + ["--fake-chips", "1"] + [
                a.format(spool=spool) for a in args],
            "DRA driver running on")
    finally:
        shutil.rmtree(registry, ignore_errors=True)
    if message is None:
        assert "tracing on" not in log, log
        assert not os.path.exists(spool)
    else:
        assert message.format(spool=spool) in log, log
        # the exit's flush: a meta line and no span
        (name,) = [n for n in os.listdir(spool) if n.endswith(".jsonl")]
        assert name.startswith("dra.")


def test_device_plugin_takes_tracing(tmp_path):
    log = _serve_until(ENTRY + private_flags(tmp_path) + [
        "--fake-chips", "1", "--fake-client", "--feature-gates",
        "Tracing=true", "--trace-sampling-rate", "0.5",
        "--trace-spool-dir", str(tmp_path / "spool")],
        "device plugin running on")
    assert (f"tracing on: spans to {tmp_path / 'spool'} at sampling rate "
            "0.5") in log, log
    (name,) = [n for n in os.listdir(tmp_path / "spool")
               if n.endswith(".jsonl")]
    assert name.startswith("plugin.")


DRA_BLOCKED_CODE = """
import sys
BLOCKED = ("grpc", "google.protobuf", "yaml")
for name in BLOCKED:
    sys.modules[name] = None
import importlib
for name in ("chip_smoke", "vtpu_manager_torch.bench_dra",
             "vtpu_manager_torch.cmd.kubelet_plugin",
             "vtpu_manager_torch.kubeletplugin.api",
             "vtpu_manager_torch.kubeletplugin.api.messages",
             "vtpu_manager_torch.kubeletplugin.driver",
             "vtpu_manager_torch.kubeletplugin.registration",
             "vtpu_manager_torch.kubeletplugin.health",
             "vtpu_manager_torch.kubeletplugin.readiness"):
    importlib.import_module(name)
from vtpu_manager_torch import bench_dra
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.kubeletplugin.allocatable import build_resource_slice
from vtpu_manager_torch.kubeletplugin.api import messages as api
from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
from vtpu_manager_torch.kubeletplugin.driver import ClaimSource, DraDriver
from vtpu_manager_torch.kubeletplugin.registration import \\
    publish_resource_slice
from vtpu_manager_torch.tpu.discovery import FakeBackend
root = sys.argv[1]
found = FakeBackend(1).discover()
client = FakeKubeClient()
assert publish_resource_slice(client, build_resource_slice("n1",
                                                           found.chips))
client.add_resourceclaim(bench_dra.allocated_claim("c1", 0, {"gpu": [0]},
                                                   5, 1024))
state = DeviceState("n1", found.chips, base_dir=root + "/dra",
                    cdi_dir=root + "/cdi", minors=found.minors,
                    shim_host_dir=root + "/d", lock_dir=root + "/l",
                    vmem_dir=root + "/v", watcher_dir=root + "/w")
driver = DraDriver("n1", ClaimSource(client), state)
entry = driver.node_prepare(api.NodePrepareResourcesRequest(
    [api.Claim("uid-c1", "c1", bench_dra.NAMESPACE)])).claims["uid-c1"]
assert not entry.error, entry.error
(device,) = bench_dra.read_spec(root + "/cdi", "uid-c1").values()
env = bench_dra.cdi_env(device)
assert env["VTPU_CORE_LIMIT_0"] == "5" and env["VTPU_POD_UID"] == "uid-c1"
assert env["CUDA_VISIBLE_DEVICES"] == "fake-0", env
bad = sorted(n for n in sys.modules
             if any(n == b or n.startswith(b + ".") for b in BLOCKED)
             and sys.modules[n] is not None)
print("LOADED", bad)
"""


def test_dra_card_path_runs_without_grpc_protobuf_or_yaml(tmp_path):
    res = subprocess.run([sys.executable, "-c", DRA_BLOCKED_CODE,
                          str(tmp_path)], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


# --- the multi-device dry run (graft_entry.dryrun_multichip) ------------

def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    # the JAX entry's checks at its shapes and tolerances, on four gloo
    # ranks: a (data 2, model 2) mesh, the ring over "data", the pipeline
    # and the MoE layer over all four
    from vtpu_manager_torch import graft_entry
    records = graft_entry.dryrun_multichip(4, device="cpu", timeout=240)
    verdict = capsys.readouterr().out
    assert ("dryrun_multichip(4): mesh={'data': 2, 'model': 2}" in verdict
            and "ring-attention OK pipeline OK moe OK" in verdict), verdict
    assert len(records) == 4 and len({r["loss"] for r in records}) == 1
    for r in records:
        assert r["device"] == "cpu"
        assert abs(r["loss"] - r["single_loss"]) < 5e-2     # bf16 bound
        # each error in units of its tolerance: within at <= 1
        assert max(r["ring_err"], r["pipeline_err"], r["moe_err"]) <= 1


def test_dryrun_multichip_never_drops_to_the_cpu():
    # no card here: ranks asked for the card fail, and the run with them
    from vtpu_manager_torch import graft_entry
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2, timeout=120)


def test_rank_device_rule():
    from vtpu_manager_torch.workloads import ranks
    assert ranks.default_backend("cpu") == "gloo"
    assert ranks.rank_device(3, "cpu", "gloo").type == "cpu"
    with pytest.raises(ValueError):
        ranks.rank_device(0, "cpu", "nccl")     # NCCL ranks hold a card
    with pytest.raises(ValueError):
        ranks.rank_device(0, "cpu", "mpi")
