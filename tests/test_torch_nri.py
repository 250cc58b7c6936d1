"""The port's NRI runtime hook, its transport and its proto3 codec, against
the JAX package's.

- RuntimeHook: the cases of tests/test_dra.py:435 TestRuntimeHook run on
  both packages' hooks over the same prepared claims, with equal
  adjustments and equal refusals; and the identity the port's CDI spec
  sets (VTPU_POD_UID, VTPU_CONTAINER_NAME) survives the adjustment.
- The codec (`kubeletplugin/api/nri_messages.py`): its bytes decode under
  the JAX package's `nri_pb2` / `ttrpc_pb2` to equal messages and theirs
  under it, unknown fields included, for every message of the subset; its
  field numbers are tests/test_nri_conformance.py's golden transcription.
- The transport: the loopback cases of tests/test_nri_transport.py over a
  real unix socket, a JAX runtime end talking to the port's plugin, the
  ported nri_probe, and the whole path with protobuf, grpc and yaml
  blocked.
"""

import os
import subprocess
import sys
import tempfile
import threading

import pytest
from test_nri_conformance import (GOLDEN_NRI, GOLDEN_TTRPC, L_OPT, L_REP,
                                  T_BOOL, T_BYTES, T_I32, T_I64, T_MSG,
                                  T_STR)
from test_torch_dra import allocated_claim, fake_chip, multi_request_claim

from vtpu_manager.device.types import fake_chip as jax_fake_chip
from vtpu_manager.kubeletplugin import nri_transport as jnt
from vtpu_manager.kubeletplugin.api import nri_pb2, ttrpc_pb2
from vtpu_manager.kubeletplugin.device_state import \
    DeviceState as JaxDeviceState
from vtpu_manager.kubeletplugin.nri import RuntimeHook as JaxRuntimeHook
from vtpu_manager.util import ttrpc as jttrpc
from vtpu_manager_torch.cmd import nri_probe
from vtpu_manager_torch.kubeletplugin import nri_transport as nt
from vtpu_manager_torch.kubeletplugin.api import nri_messages as nm
from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
from vtpu_manager_torch.kubeletplugin.nri import RuntimeHook
from vtpu_manager_torch.util import consts, ttrpc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- the hook's policy, on both packages ------------------------------------

@pytest.fixture
def hooks(tmp_path):
    """(JAX hook, port hook) over the same prepared claims."""
    def prepare(state):
        state.prepare_claim(allocated_claim())
        state.prepare_claim(multi_request_claim())
        return state

    jax = prepare(JaxDeviceState("node-1", [jax_fake_chip(0),
                                            jax_fake_chip(1)],
                                 base_dir=str(tmp_path / "mgr"),
                                 cdi_dir=str(tmp_path / "jcdi")))
    port = prepare(DeviceState("node-1", [fake_chip(0), fake_chip(1)],
                               base_dir=str(tmp_path / "mgr-port"),
                               cdi_dir=str(tmp_path / "cdi"),
                               minors={0: 0, 1: 1}))
    return JaxRuntimeHook(jax), RuntimeHook(port)


HOOK_CASES = {
    "valid_claim_injected": ({"uid": "pod-1", "claim_uids": ["claim-1"]},
                             ["VTPU_CLAIM_UID=claim-1"], None),
    "spoofed_claim_rejected": ({"uid": "pod-2", "claim_uids": []},
                               ["VTPU_CLAIM_UID=claim-1"], "does not own"),
    "unprepared_claim_rejected": ({"uid": "pod-1", "claim_uids": ["ghost"]},
                                  ["VTPU_CLAIM_UID=ghost"], "unprepared"),
    "non_tenant_untouched": ({"uid": "p", "claim_uids": []}, [], None),
    "multi_request_container_gets_its_requests_config": (
        {"uid": "pod-1", "claim_uids": ["claim-m"]},
        ["VTPU_CLAIM_UID=claim-m", "VTPU_CLAIM_REQUEST=train"], None),
    "multi_request_unknown_request_marker_rejected": (
        {"uid": "pod-1", "claim_uids": ["claim-m"]},
        ["VTPU_CLAIM_UID=claim-m", "VTPU_CLAIM_REQUEST=forged"],
        "no prepared request"),
    "multi_request_without_marker_fails_closed": (
        {"uid": "pod-1", "claim_uids": ["claim-m"]},
        ["VTPU_CLAIM_UID=claim-m"], "VTPU_CLAIM_REQUEST"),
}


def _relative(mounts, base):
    return [{**m, "source": os.path.relpath(m["source"], base)}
            for m in mounts]


@pytest.mark.parametrize("case", sorted(HOOK_CASES))
def test_hook_case_as_jax(hooks, case):
    jax, port = hooks
    pod, env, refusal = HOOK_CASES[case]
    container = {"name": "c", "env": env}
    want = jax.create_container(pod, container)
    got = port.create_container(pod, container)
    assert (got.rejected, got.reason, got.env) == \
        (want.rejected, want.reason, want.env)
    # the same mount, each under its own package's base directory
    assert _relative(got.mounts, port.state.base_dir) == \
        _relative(want.mounts, jax.state.base_dir)
    if refusal is None:
        assert not got.rejected
    else:
        assert got.rejected and refusal in got.reason
    if case == "valid_claim_injected":
        assert got.env == {consts.ENV_REGISTER_UUID: "claim-1"}
        assert got.mounts == [{
            "source": f"{port.state.base_dir}/claim_claim-1/config",
            "destination": f"{consts.MANAGER_BASE_DIR}/config",
            "options": ["ro", "rbind"]}]
    if case == "multi_request_container_gets_its_requests_config":
        assert got.mounts[0]["source"].endswith("claim_claim-m/config_train")


def test_identity_survives_the_hook(hooks):
    """R6: the CDI spec's VTPU_POD_UID / VTPU_CONTAINER_NAME, which keep a
    claim's processes one tenant, come out of the runtime's merge of the
    adjustment unchanged."""
    _, port = hooks
    import json

    from vtpu_manager_torch.kubeletplugin import cdi
    with open(cdi.spec_path("claim-1", port.state.cdi_dir)) as f:
        (device,) = json.load(f)["devices"]
    env = device["containerEdits"]["env"]
    before = dict(e.split("=", 1) for e in env)
    adj = port.create_container({"uid": "pod-1", "claim_uids": ["claim-1"]},
                                {"name": "main", "env": env})
    after = {**before, **adj.env}        # NRI adds and overrides, by key
    assert not adj.rejected
    assert after[consts.ENV_POD_UID] == before[consts.ENV_POD_UID] == \
        "claim-1"
    assert after[consts.ENV_CONTAINER_NAME] == \
        before[consts.ENV_CONTAINER_NAME] == "dra-claim"
    assert consts.ENV_POD_UID not in adj.env
    assert consts.ENV_CONTAINER_NAME not in adj.env
    assert after[consts.ENV_REGISTER_UUID] == "claim-1"


# --- the codec ---------------------------------------------------------------

_KINDS = {"string": T_STR, "bytes": T_BYTES, "int32": T_I32,
          "int64": T_I64, "bool": T_BOOL, "message": T_MSG, "map": T_MSG}


def _shape(cls) -> dict:
    out = {}
    for f in cls.FIELDS:
        type_name = (f"{f.name.capitalize()}Entry" if f.kind == "map"
                     else f.message.__name__ if f.kind == "message" else None)
        label = L_REP if (f.repeated or f.kind == "map") else L_OPT
        out[f.name] = (f.number, label, _KINDS[f.kind], type_name)
    return out


@pytest.mark.parametrize("messages,golden", [
    (nm.NRI_MESSAGES, GOLDEN_NRI), (nm.TTRPC_MESSAGES, GOLDEN_TTRPC)],
    ids=["nri", "ttrpc"])
def test_field_numbers_are_the_golden_ones(messages, golden):
    assert {cls.__name__: _shape(cls) for cls in messages} == golden


def _pod(pb):
    return pb.PodSandbox(id="sb-1", name="p", uid="pod-uid", namespace="ml",
                         labels={"app": "train", "tier": ""},
                         annotations={"a/b": "c"})


def _container(pb):
    return pb.Container(
        id="c-1", pod_sandbox_id="sb-1", name="main", state=-2,
        labels={"k": "v"}, annotations={"x": "y"}, args=["python", "-m"],
        env=["VTPU_CLAIM_UID=claim-1", "PATH=/bin"],
        mounts=[pb.Mount(destination="/d", type="bind", source="/s",
                         options=["ro", "rbind"])])


def _adjustment(pb):
    return pb.ContainerAdjustment(
        annotations={"n": "1"},
        mounts=[pb.Mount(destination="/etc/vtpu-manager/config",
                         source="/x", options=["ro"])],
        env=[pb.KeyValue(key="VTPU_REGISTER_UUID", value="claim-1"),
             pb.KeyValue(key="EMPTY", value="")])


# each message of the subset, built alike from either module (pb is
# nri_pb2 / ttrpc_pb2 or the codec)
SAMPLES = {
    "RegisterPluginRequest": lambda pb: pb.RegisterPluginRequest(
        plugin_name="vtpu-manager", plugin_idx="10"),
    "Empty": lambda pb: pb.Empty(),
    "ConfigureRequest": lambda pb: pb.ConfigureRequest(
        config="{}", runtime_name="containerd", runtime_version="2.0",
        registration_timeout=5_000_000_000, request_timeout=-1),
    "ConfigureResponse": lambda pb: pb.ConfigureResponse(
        events=(1 << 3) | (1 << 9)),
    "Mount": lambda pb: pb.Mount(destination="/d", type="bind", source="/s",
                                 options=["ro", "rbind"]),
    "KeyValue": lambda pb: pb.KeyValue(key="k", value="v=w"),
    "PodSandbox": _pod,
    "Container": _container,
    "CreateContainerRequest": lambda pb: pb.CreateContainerRequest(
        pod=_pod(pb), container=_container(pb)),
    "ContainerAdjustment": _adjustment,
    "ContainerUpdate": lambda pb: pb.ContainerUpdate(container_id="c-1"),
    "CreateContainerResponse": lambda pb: pb.CreateContainerResponse(
        adjust=_adjustment(pb), update=[pb.ContainerUpdate(container_id="a"),
                                        pb.ContainerUpdate()],
        evict=[pb.ContainerUpdate(container_id="b")]),
    "SynchronizeRequest": lambda pb: pb.SynchronizeRequest(
        pods=[_pod(pb), pb.PodSandbox(uid="u2")],
        containers=[_container(pb)], more=True),
    "SynchronizeResponse": lambda pb: pb.SynchronizeResponse(
        update=[pb.ContainerUpdate(container_id="c")], more=True),
    "StateChangeEvent": lambda pb: pb.StateChangeEvent(
        event=4, pod=_pod(pb), container=_container(pb)),
    "StopContainerRequest": lambda pb: pb.StopContainerRequest(
        pod=pb.PodSandbox(), container=_container(pb)),
    "StopContainerResponse": lambda pb: pb.StopContainerResponse(
        update=[pb.ContainerUpdate(container_id="c")]),
}
TTRPC_SAMPLES = {
    "Request": lambda pb: pb.Request(
        service="nri.pkg.api.v1alpha1.Plugin", method="CreateContainer",
        payload=bytes(range(256)), timeout_nano=10**10,
        metadata=[pb.KeyValue(key="k", value="v")]),
    "Status": lambda pb: pb.Status(code=5, message="not found"),
    "Response": lambda pb: pb.Response(
        status=pb.Status(code=2, message="x"), payload=b"\x00\x01"),
    "KeyValue": lambda pb: pb.KeyValue(key="k", value="v"),
}
CASES = ([(name, nri_pb2, make) for name, make in SAMPLES.items()]
         + [(f"ttrpc.{name}", ttrpc_pb2, make)
            for name, make in TTRPC_SAMPLES.items()])


@pytest.mark.parametrize("name,pb2,make", CASES, ids=[c[0] for c in CASES])
def test_codec_round_trips_against_protobuf(name, pb2, make):
    cls = getattr(nm, name.split(".")[-1])
    ours, theirs = make(nm), make(pb2)
    # our bytes decode under protobuf to its message, and its bytes under
    # ours to our message
    assert getattr(pb2, name.split(".")[-1]).FromString(ours.encode()) == \
        theirs
    assert cls.decode(theirs.SerializeToString()) == ours
    assert cls.decode(ours.encode()) == ours


def test_unknown_fields_are_skipped():
    """Fields this subset does not name, of every wire type, as a newer
    containerd sends them."""
    from google.protobuf.internal import encoder
    known = nri_pb2.CreateContainerRequest(
        pod=nri_pb2.PodSandbox(uid="pod-1"),
        container=nri_pb2.Container(name="main", env=["A=1"]))
    extra = b"".join([
        encoder.TagBytes(40, 0) + encoder._VarintBytes(12345),        # varint
        encoder.TagBytes(41, 1) + b"\x01" * 8,                        # fixed64
        encoder.TagBytes(42, 2) + encoder._VarintBytes(3) + b"abc",   # bytes
        encoder.TagBytes(43, 5) + b"\x02" * 4,                        # fixed32
    ])
    # inside the nested Container too (Container's field 10, linux, is one
    # upstream has and this subset leaves out)
    container = known.container.SerializeToString() + \
        encoder.TagBytes(10, 2) + encoder._VarintBytes(2) + b"\x08\x01"
    raw = (encoder.TagBytes(1, 2)
           + encoder._VarintBytes(len(known.pod.SerializeToString()))
           + known.pod.SerializeToString()
           + encoder.TagBytes(2, 2) + encoder._VarintBytes(len(container))
           + container + extra)
    parsed = nri_pb2.CreateContainerRequest.FromString(raw)
    parsed.DiscardUnknownFields()            # protobuf keeps them; we skip
    assert parsed == known
    got = nm.CreateContainerRequest.decode(raw)
    assert got == nm.CreateContainerRequest(
        pod=nm.PodSandbox(uid="pod-1"),
        container=nm.Container(name="main", env=["A=1"]))


def test_a_field_of_another_wire_type_is_skipped():
    # `name` (field 3, a string) arriving as a varint: not ours to read
    raw = b"\x18\x07" + nri_pb2.Container(id="c").SerializeToString()
    assert nm.Container.decode(raw) == nm.Container(id="c")


@pytest.mark.parametrize("raw", [b"\x0a\x05ab", b"\x08", b"\x0b",
                                 b"\x08" + b"\xff" * 11])
def test_truncated_or_malformed_bytes_raise(raw):
    with pytest.raises(ValueError):
        nm.ConfigureRequest.decode(raw)


# --- the transport -------------------------------------------------------------

@pytest.fixture
def loop():
    """(runtime end, plugin, registrations): the port's plugin registered
    with a mux-mode ttrpc server standing in for the runtime, as
    tests/test_nri_transport.py's fixture builds it."""
    tmp = tempfile.mkdtemp(prefix="nri-")        # a short socket path
    state = DeviceState("node-1", [fake_chip(0)], base_dir=f"{tmp}/mgr",
                        cdi_dir=f"{tmp}/cdi", minors={0: 0})
    state.prepare_claim(allocated_claim())
    plugin = nt.NriPlugin(
        RuntimeHook(state), claim_uids_for_pod=lambda pod_uid, claim_uid:
        ["claim-1"] if pod_uid == "pod-1" else [])
    registered = []

    def register(raw: bytes) -> bytes:
        req = nm.RegisterPluginRequest.decode(raw)
        registered.append((req.plugin_name, req.plugin_idx))
        return nm.Empty().encode()

    server = ttrpc.TtrpcServer(f"{tmp}/nri.sock", {
        (nt.RUNTIME_SERVICE, "RegisterPlugin"): register}, mux=True)
    session = plugin.run(f"{tmp}/nri.sock")
    try:
        yield server.wait_for_connection(), plugin, registered
    finally:
        session.close()
        server.stop()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def call(conn, method, message, resp_cls):
    return resp_cls.decode(conn.call(nt.PLUGIN_SERVICE, method,
                                     message.encode()))


class TestLoopback:
    def test_register_and_configure(self, loop):
        runtime, plugin, registered = loop
        assert registered == [("vtpu-manager", "10")]
        resp = call(runtime, "Configure",
                    nm.ConfigureRequest(runtime_name="containerd",
                                        runtime_version="2.0"),
                    nm.ConfigureResponse)
        assert resp.events == nt.EVENT_CREATE_CONTAINER | \
            nt.EVENT_STOP_CONTAINER
        assert plugin.configured

    def test_create_container_injects(self, loop):
        runtime, _, _ = loop
        resp = call(runtime, "CreateContainer", nm.CreateContainerRequest(
            pod=nm.PodSandbox(uid="pod-1", name="p", namespace="ml"),
            container=nm.Container(name="main",
                                   env=["VTPU_CLAIM_UID=claim-1"])),
            nm.CreateContainerResponse)
        env = {e.key: e.value for e in resp.adjust.env}
        assert env == {consts.ENV_REGISTER_UUID: "claim-1"}
        (mount,) = resp.adjust.mounts
        assert mount.destination == f"{consts.MANAGER_BASE_DIR}/config"
        assert mount.options == ["ro", "rbind"] and mount.type == "bind"

    def test_spoofed_claim_fails_closed(self, loop):
        runtime, _, _ = loop
        with pytest.raises(ttrpc.TtrpcError) as e:
            call(runtime, "CreateContainer", nm.CreateContainerRequest(
                pod=nm.PodSandbox(uid="pod-2"),
                container=nm.Container(name="main",
                                       env=["VTPU_CLAIM_UID=claim-1"])),
                nm.CreateContainerResponse)
        assert "does not own" in str(e.value)

    def test_non_tenant_passthrough(self, loop):
        runtime, _, _ = loop
        resp = call(runtime, "CreateContainer", nm.CreateContainerRequest(
            pod=nm.PodSandbox(uid="pod-9"), container=nm.Container(name="app")),
            nm.CreateContainerResponse)
        assert resp.adjust == nm.ContainerAdjustment()

    def test_unknown_method_not_found(self, loop):
        runtime, _, _ = loop
        with pytest.raises(ttrpc.TtrpcError) as e:
            runtime.call(nt.PLUGIN_SERVICE, "NoSuchMethod", b"")
        assert e.value.code == ttrpc.CODE_NOT_FOUND

    def test_synchronize_stop_and_state_change(self, loop):
        runtime, plugin, _ = loop
        call(runtime, "Synchronize", nm.SynchronizeRequest(
            pods=[nm.PodSandbox(uid="u1", name="p", namespace="ns")],
            containers=[nm.Container(name="c", env=["A=1"])]),
            nm.SynchronizeResponse)
        assert plugin.synchronized == (
            [{"uid": "u1", "name": "p", "namespace": "ns"}],
            [{"name": "c", "env": ["A=1"]}])
        assert call(runtime, "StopContainer", nm.StopContainerRequest(
            pod=nm.PodSandbox(uid="u1")), nm.StopContainerResponse) == \
            nm.StopContainerResponse()

    def test_concurrent_calls_multiplex(self, loop):
        runtime, plugin, _ = loop
        threads = [threading.Thread(target=call, args=(
            runtime, "StateChange", nm.StateChangeEvent(event=i), nm.Empty))
            for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert sorted(plugin.events_seen) == list(range(8))


def test_jax_runtime_end_drives_the_port_plugin():
    """The JAX package's ttrpc server and protobuf messages on the runtime's
    end, the port's plugin on the other: the wire is the same."""
    tmp = tempfile.mkdtemp(prefix="nri-")
    state = DeviceState("node-1", [fake_chip(0)], base_dir=f"{tmp}/mgr",
                        cdi_dir=f"{tmp}/cdi", minors={0: 0})
    state.prepare_claim(allocated_claim())
    plugin = nt.NriPlugin(RuntimeHook(state),
                          claim_uids_for_pod=lambda p, c: ["claim-1"])
    server = jttrpc.TtrpcServer(f"{tmp}/nri.sock", {
        (jnt.RUNTIME_SERVICE, "RegisterPlugin"):
            lambda raw: nri_pb2.Empty().SerializeToString()}, mux=True)
    session = plugin.run(f"{tmp}/nri.sock")
    try:
        runtime = server.wait_for_connection()
        raw = runtime.call(jnt.PLUGIN_SERVICE, "CreateContainer",
                           nri_pb2.CreateContainerRequest(
                               pod=nri_pb2.PodSandbox(uid="pod-1"),
                               container=nri_pb2.Container(
                                   name="main",
                                   env=["VTPU_CLAIM_UID=claim-1"]))
                           .SerializeToString())
        resp = nri_pb2.CreateContainerResponse.FromString(raw)
        assert {e.key: e.value for e in resp.adjust.env} == \
            {consts.ENV_REGISTER_UUID: "claim-1"}
        assert list(resp.adjust.mounts[0].options) == ["ro", "rbind"]
    finally:
        session.close()
        server.stop()


def test_resolver_failure_aborts_only_tenants():
    tmp = tempfile.mkdtemp(prefix="nri-")
    state = DeviceState("node-1", [fake_chip(0)], base_dir=f"{tmp}/mgr",
                        cdi_dir=f"{tmp}/cdi", minors={0: 0})
    resolved = []

    def broken(pod_uid, claim_uid):
        resolved.append(pod_uid)
        raise RuntimeError("API server down")

    plugin = nt.NriPlugin(RuntimeHook(state), claim_uids_for_pod=broken)
    server = ttrpc.TtrpcServer(f"{tmp}/nri.sock", {
        (nt.RUNTIME_SERVICE, "RegisterPlugin"):
            lambda raw: nm.Empty().encode()}, mux=True)
    session = plugin.run(f"{tmp}/nri.sock")
    try:
        runtime = server.wait_for_connection()
        resp = call(runtime, "CreateContainer", nm.CreateContainerRequest(
            pod=nm.PodSandbox(uid="p"), container=nm.Container(name="app")),
            nm.CreateContainerResponse)
        assert resp.adjust == nm.ContainerAdjustment() and resolved == []
        with pytest.raises(ttrpc.TtrpcError) as e:
            call(runtime, "CreateContainer", nm.CreateContainerRequest(
                pod=nm.PodSandbox(uid="p"), container=nm.Container(
                    name="t", env=["VTPU_CLAIM_UID=c1"])),
                nm.CreateContainerResponse)
        assert "ownership lookup failed" in str(e.value) and resolved == ["p"]
    finally:
        session.close()
        server.stop()


class TestProbe:
    def test_probe_passes_against_a_fake_runtime(self):
        tmp = tempfile.mkdtemp(prefix="nri-")
        seen = []

        def register(raw: bytes) -> bytes:
            seen.append(nm.RegisterPluginRequest.decode(raw).plugin_name)
            return nm.Empty().encode()

        server = ttrpc.TtrpcServer(f"{tmp}/nri.sock", {
            (nt.RUNTIME_SERVICE, "RegisterPlugin"): register}, mux=True)

        def runtime_side():
            conn = server.wait_for_connection()
            conn.call(nt.PLUGIN_SERVICE, "Configure", nm.ConfigureRequest(
                runtime_name="fake", runtime_version="2.0").encode())
            conn.call(nt.PLUGIN_SERVICE, "Synchronize", nm.SynchronizeRequest(
                pods=[nm.PodSandbox(uid="u1", name="p", namespace="ns")]
            ).encode())

        t = threading.Thread(target=runtime_side, daemon=True)
        t.start()
        try:
            rc = nri_probe.main(["--socket", f"{tmp}/nri.sock", "--hold",
                                 "0.5", "--timeout", "5"])
        finally:
            t.join(timeout=5)
            server.stop()
        assert rc == 0 and seen == ["vtpu-nri-probe"]

    def test_probe_fails_without_socket(self, tmp_path):
        assert nri_probe.main(["--socket", str(tmp_path / "missing.sock"),
                               "--hold", "0.1", "--timeout", "1"]) == 1


BLOCKED_CODE = """
import sys
BLOCKED = ("grpc", "google.protobuf", "yaml")
for name in BLOCKED:
    sys.modules[name] = None
import tempfile
from vtpu_manager_torch.device.types import ChipSpec
from vtpu_manager_torch.kubeletplugin import nri_transport as nt
from vtpu_manager_torch.kubeletplugin.api import nri_messages as nm
from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
from vtpu_manager_torch.kubeletplugin.nri import RuntimeHook
from vtpu_manager_torch.util import ttrpc
tmp = tempfile.mkdtemp(prefix="nri-")
chip = ChipSpec(uuid="GPU-0", index=0, chip_type="h100", memory=1 << 34)
state = DeviceState("n1", [chip], base_dir=tmp + "/mgr", cdi_dir=tmp + "/cdi",
                    minors={0: 0})
server = ttrpc.TtrpcServer(tmp + "/nri.sock", {
    (nt.RUNTIME_SERVICE, "RegisterPlugin"): lambda raw: nm.Empty().encode()},
    mux=True)
session = nt.NriPlugin(RuntimeHook(state)).run(tmp + "/nri.sock")
runtime = server.wait_for_connection()
raw = runtime.call(nt.PLUGIN_SERVICE, "CreateContainer",
                   nm.CreateContainerRequest(
                       pod=nm.PodSandbox(uid="p"),
                       container=nm.Container(name="app")).encode())
assert nm.CreateContainerResponse.decode(raw).adjust is not None
session.close()
server.stop()
bad = sorted(n for n in sys.modules
             if any(n == b or n.startswith(b + ".") for b in BLOCKED)
             and sys.modules[n] is not None)
print("LOADED", bad)
"""


def test_hook_path_runs_without_grpc_protobuf_or_yaml():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", BLOCKED_CODE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


# --- the command ------------------------------------------------------------------

def _kubelet_plugin(root: str, *extra: str) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if not k.startswith("VTPU_")}
    env["PYTHONPATH"] = REPO
    return subprocess.Popen(
        [sys.executable, "-m", "vtpu_manager_torch.cmd.kubelet_plugin",
         "--node-name", "node-1", "--fake-chips", "1",
         "--plugin-dir", f"{root}/plugins", "--registry-dir", f"{root}/reg",
         "--base-dir", f"{root}/mgr", "--cdi-dir", f"{root}/cdi",
         "--vmem-path", f"{root}/vmem/vmem_node.config",
         "--lock-dir", f"{root}/locks", "--watcher-dir", f"{root}/watcher",
         "--driver-dir", f"{root}/driver", "--service-account-dir",
         f"{root}/no-sa", "--health-port", "0", "--health-host", "127.0.0.1",
         *extra], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _served(proc) -> str:
    lines = []
    while not lines or "DRA driver running on" not in lines[-1]:
        line = proc.stdout.readline()
        assert line, "".join(lines)            # exited before serving
        lines.append(line)
    return "".join(lines)


def _readyz(log: str) -> dict:
    import json
    import urllib.error
    import urllib.request
    port = int(log.split("readiness endpoint on :")[1].split()[0])
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz",
                                    timeout=10) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:       # 503 while a part is down
        return json.loads(e.read())


def test_kubelet_plugin_registers_the_hook_on_its_socket():
    import signal
    root = tempfile.mkdtemp(prefix="nri-")
    registered = []

    def register(raw: bytes) -> bytes:
        registered.append(nm.RegisterPluginRequest.decode(raw).plugin_name)
        return nm.Empty().encode()

    server = ttrpc.TtrpcServer(f"{root}/nri.sock", {
        (nt.RUNTIME_SERVICE, "RegisterPlugin"): register}, mux=True)
    proc = _kubelet_plugin(root, "--nri-socket", f"{root}/nri.sock")
    try:
        log = _served(proc)
        assert registered == ["vtpu-manager"], log
        assert _readyz(log)["components"]["nri"]["ready"] is True
        # a container naming a claim nothing prepared is refused
        runtime = server.wait_for_connection()
        with pytest.raises(ttrpc.TtrpcError) as e:
            runtime.call(nt.PLUGIN_SERVICE, "CreateContainer",
                         nm.CreateContainerRequest(
                             pod=nm.PodSandbox(uid="p"),
                             container=nm.Container(
                                 name="t", env=["VTPU_CLAIM_UID=c9"]))
                         .encode())
        assert "unprepared claim" in str(e.value)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()


def test_nri_gate_without_a_runtime_goes_on_without_the_hook():
    import signal
    root = tempfile.mkdtemp(prefix="nri-")
    proc = _kubelet_plugin(root, "--feature-gates", "NRISupport=true")
    try:
        log = _served(proc)
        assert "going on without the runtime hook" in log, log
        nri_state = _readyz(log)["components"]["nri"]
        assert nri_state["ready"] is False
        assert "requested but not attached" in nri_state["reason"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
