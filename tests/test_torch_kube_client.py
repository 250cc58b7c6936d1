"""The port's in-cluster API client against the JAX package's.

Both clients talk to the same kind of stub API server
(`vtpu_manager_torch/client/apistub.py`) over TLS with the committed test
CA (tests/data/kube-stub), each to a stub of its own seeded alike. For
every verb they must send the same requests (method, path and query,
Authorization / Accept / Content-Type, body) and give back the same
results or the same KubeError status: the ResourceSlice's PUT 404 then
POST, Retry-After on a 429, a watch whose last line is torn, an in-stream
410, a refused connection (status 0). Then the commands: the port's
kubelet plugin publishes its slice to the stub and prepares a claim it
fetched there, and the device plugin without --fake-client registers its
node through the stub.
"""

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

from vtpu_manager.client import kube as jkube
from vtpu_manager_torch.client import kube
from vtpu_manager_torch.client.apistub import ApiStub
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.util import consts

REPO = Path(__file__).resolve().parents[1]
CERTS = REPO / "tests" / "data" / "kube-stub"
CA = str(CERTS / "ca.crt")
TOKEN = "test-token"


def seeded() -> FakeKubeClient:
    store = FakeKubeClient()
    store.add_node({"metadata": {"name": "n1", "annotations": {"x": "1"}}})
    store.add_node({"metadata": {"name": "n2"}})
    store.add_pod({"metadata": {"name": "p1", "namespace": "ml",
                                "uid": "u1", "annotations": {}},
                   "spec": {"nodeName": "n1"}})
    store.add_pod({"metadata": {"name": "p2", "namespace": "default",
                                "uid": "u2"}, "spec": {}})
    store.add_resourceclaim({"metadata": {"name": "c1", "namespace": "ml",
                                          "uid": "cu1"},
                             "status": {"reservedFor": [{"uid": "u1"}]}})
    return store


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "token"
    path.write_text(TOKEN + "\n")
    return str(path)


@pytest.fixture
def pair(token_file):
    """[(JAX client, its stub), (port client, its stub)]."""
    out = []
    for pkg in (jkube, kube):
        stub = ApiStub(str(CERTS / "server.crt"), str(CERTS / "server.key"),
                       token=TOKEN, store=seeded())
        stub.start()
        out.append((pkg.InClusterClient(stub.url, token_file, CA), stub))
    yield out
    for _, stub in out:
        stub.stop()


def outcome(fn):
    """A verb's result, or its KubeError as (status, retry_after, text)."""
    try:
        result = fn()
        return ("ok", list(result) if hasattr(result, "__next__")
                else result)
    except (jkube.KubeError, kube.KubeError) as e:
        return ("error", e.status, e.retry_after, str(e))


SLICE = {"apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceSlice",
         "metadata": {"name": "n1-vtpu"}, "spec": {"driver": "d"}}
LEASE_ANNS = {"holder": "a"}

VERBS = {
    "list_nodes": lambda c: c.list_nodes(),
    "get_node": lambda c: c.get_node("n1"),
    "get_node_missing": lambda c: c.get_node("nope"),
    "patch_node_annotations": lambda c: c.patch_node_annotations(
        "n1", {"a": "1", "x": None}),
    "list_pods": lambda c: c.list_pods(),
    "list_pods_namespace": lambda c: c.list_pods("ml"),
    "list_pods_node": lambda c: c.list_pods(node_name="n1"),
    "list_pods_selector": lambda c: c.list_pods(
        field_selector="spec.nodeName!="),
    "list_pods_all_filters": lambda c: c.list_pods(
        "ml", "n1", "spec.nodeName!="),
    "list_pods_with_version": lambda c: c.list_pods_with_version(),
    "list_nodes_with_version": lambda c: c.list_nodes_with_version(),
    "get_pod": lambda c: c.get_pod("ml", "p1"),
    "get_pod_missing": lambda c: c.get_pod("ml", "nope"),
    "patch_pod_annotations": lambda c: c.patch_pod_annotations(
        "ml", "p1", {"vtpu/real": "x"}),
    "bind_pod": lambda c: (c.bind_pod("default", "p2", "n2"),
                           c.get_pod("default", "p2")),
    "delete_pod": lambda c: (c.delete_pod("ml", "p1"), c.list_pods()),
    "delete_pod_grace": lambda c: c.delete_pod("ml", "p1", grace_seconds=0),
    "evict_pod": lambda c: c.evict_pod("ml", "p1"),
    "create_event": lambda c: c.create_event(
        "ml", {"metadata": {"name": "e1"}, "reason": "Allocated"}),
    "list_pdbs": lambda c: (c.list_pdbs(), c.list_pdbs("ml")),
    "get_lease_missing": lambda c: c.get_lease("kube-system", "l1"),
    "create_and_get_lease": lambda c: (
        c.create_lease("kube-system", "l1", LEASE_ANNS),
        c.get_lease("kube-system", "l1")),
    "update_lease": lambda c: (
        c.create_lease("kube-system", "l1", LEASE_ANNS),
        c.update_lease("kube-system", "l1", {"holder": "b"}, "1")),
    "update_lease_stale": lambda c: (
        c.create_lease("kube-system", "l1", LEASE_ANNS),
        c.update_lease("kube-system", "l1", {"holder": "b"}, "7")),
    "get_resourceclaim": lambda c: c.get_resourceclaim("ml", "c1"),
    "get_resourceclaim_missing": lambda c: c.get_resourceclaim("ml", "c9"),
    "create_resourceclaim_template": lambda c: (
        c.create_resourceclaim_template(
            {"metadata": {"name": "t1", "namespace": "ml"}, "spec": {}})),
    "apply_resourceslice_twice": lambda c: (
        c.apply_resourceslice(SLICE),
        c.apply_resourceslice({**SLICE, "spec": {"driver": "e"}})),
    "watch_pods": lambda c: list(c.watch_pods("0", timeout_s=5)),
    "watch_nodes_from_version": lambda c: list(c.watch_nodes("1",
                                                             timeout_s=5)),
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_verb_as_jax(pair, verb):
    (jclient, jstub), (client, stub) = pair
    want = outcome(lambda: VERBS[verb](jclient))
    got = outcome(lambda: VERBS[verb](client))
    assert got == want
    assert stub.requests == jstub.requests
    assert stub.requests and all(
        r["authorization"] == f"Bearer {TOKEN}"
        and r["accept"] == "application/json" for r in stub.requests)
    if verb == "apply_resourceslice_twice":
        assert [(r["method"], r["path"]) for r in stub.requests] == [
            ("PUT", "/apis/resource.k8s.io/v1beta1/resourceslices/n1-vtpu"),
            ("POST", "/apis/resource.k8s.io/v1beta1/resourceslices"),
            ("PUT", "/apis/resource.k8s.io/v1beta1/resourceslices/n1-vtpu")]
        assert stub.store.resourceslices["n1-vtpu"]["spec"] == {"driver": "e"}
    if verb.startswith("patch"):
        assert stub.requests[0]["content_type"] == \
            "application/merge-patch+json"
    if verb.endswith("missing"):
        assert got[:2] == ("error", 404)
    if verb == "update_lease_stale":
        assert got[:2] == ("error", 409)


def _ev(i):
    return (b'{"type": "ADDED", "object": {"metadata": {"name": "p%d"}}}\n'
            % i)


SCRIPTS = {
    "retry_after_429": (("GET", "/api/v1/nodes/n1", 429),
                        {"headers": {"Retry-After": "3"}},
                        lambda c: c.get_node("n1")),
    "retry_after_not_a_number": (("GET", "/api/v1/nodes/n1", 503),
                                 {"headers": {"Retry-After": "soon"}},
                                 lambda c: c.get_node("n1")),
    "server_error": (("POST", "/apis/resource.k8s.io/v1beta1/resourceslices",
                      500), {}, lambda c: c.apply_resourceslice(SLICE)),
    "watch_torn_last_line": (("GET", "/api/v1/pods", 200),
                             {"frames": [_ev(1), _ev(2), b'{"type": "MOD']},
                             lambda c: list(c.watch_pods("5", 5))),
    "watch_in_stream_410": (("GET", "/api/v1/pods", 200),
                            {"frames": [_ev(1), b'{"type": "ERROR", '
                                        b'"object": {"code": 410, '
                                        b'"message": "too old"}}\n']},
                            lambda c: list(c.watch_pods("5", 5))),
    "watch_http_410": (("GET", "/api/v1/nodes", 410), {},
                       lambda c: list(c.watch_nodes("5", 5))),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_scripted_answer_as_jax(pair, case):
    (method, path, status), extra, fn = SCRIPTS[case]
    outs = []
    for client, stub in pair:
        stub.script(method, path, status, **extra)
        outs.append(outcome(lambda: fn(client)))
    (jstub_reqs, stub_reqs) = [stub.requests for _, stub in pair]
    assert outs[1] == outs[0] and stub_reqs == jstub_reqs
    got = outs[1]
    expect = {"retry_after_429": ("error", 429, 3.0),
              "retry_after_not_a_number": ("error", 503, None),
              "server_error": ("error", 500, None),
              "watch_in_stream_410": ("error", 410, None),
              "watch_http_410": ("error", 410, None)}
    if case == "watch_torn_last_line":
        assert [e["object"]["metadata"]["name"] for e in got[1]] == \
            ["p1", "p2"]
    else:
        assert got[:3] == expect[case]


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("verb", ["get_node", "watch"])
def test_refused_connection_is_status_0(token_file, verb):
    url = f"https://127.0.0.1:{_closed_port()}"
    outs = []
    for pkg in (jkube, kube):
        client = pkg.InClusterClient(url, token_file, CA)
        fn = ((lambda: client.get_node("n1")) if verb == "get_node"
              else (lambda: list(client.watch_pods("0", 1))))
        outs.append(outcome(fn))
    assert outs[1][:3] == outs[0][:3] == ("error", 0, None)


def test_wrong_token_is_401(tmp_path):
    bad = tmp_path / "bad-token"
    bad.write_text("other")
    stub = ApiStub(str(CERTS / "server.crt"), str(CERTS / "server.key"),
                   token=TOKEN, store=seeded())
    stub.start()
    try:
        with pytest.raises(kube.KubeError) as e:
            kube.InClusterClient(stub.url, str(bad), CA).get_node("n1")
        assert e.value.status == 401
    finally:
        stub.stop()


def test_a_server_outside_the_ca_is_refused(token_file):
    # trusting the server's own certificate, which is not a CA, verifies
    # nothing: the handshake fails, a transport failure
    stub = ApiStub(str(CERTS / "server.crt"), str(CERTS / "server.key"),
                   token=TOKEN)
    stub.start()
    try:
        with pytest.raises(kube.KubeError) as e:
            kube.InClusterClient(stub.url, token_file,
                                 str(CERTS / "server.crt")).get_node("n1")
        assert e.value.status == 0 and "CERTIFICATE_VERIFY_FAILED" in \
            str(e.value)
        assert stub.requests == []
    finally:
        stub.stop()


# --- the commands ---------------------------------------------------------------

def _command_env(stub_url: str) -> dict:
    host, port = stub_url.rsplit("//", 1)[1].split(":")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "KUBERNETES_"))}
    env.update(KUBERNETES_SERVICE_HOST=host, KUBERNETES_SERVICE_PORT=port,
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return env


def _service_account(root: Path) -> str:
    sa = root / "sa"
    sa.mkdir()
    (sa / "token").write_text(TOKEN)
    (sa / "ca.crt").write_text(Path(CA).read_text())
    return str(sa)


def _wait_for_line(proc, marker: str, timeout_s: float = 60) -> str:
    lines = []
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        assert line, "".join(lines)             # exited before serving
        lines.append(line)
        if marker in line:
            return "".join(lines)
    raise AssertionError("".join(lines))


def test_kubelet_plugin_publishes_and_fetches_through_the_api(tmp_path):
    import grpc

    from vtpu_manager_torch.kubeletplugin.api import dra_pb2 as pb
    store = FakeKubeClient()
    claim = {
        "metadata": {"uid": "uid-c1", "name": "c1", "namespace": "ml"},
        "status": {"allocation": {"devices": {
            "results": [{"request": "gpu", "driver": consts.DRA_DRIVER_NAME,
                         "pool": "node-1", "device": "vtpu-0-0"}],
            "config": [{"requests": ["gpu"], "opaque": {
                "driver": consts.DRA_DRIVER_NAME,
                "parameters": {"cores": 10, "memoryMiB": 1024}}}]}},
            "reservedFor": [{"resource": "pods", "name": "p", "uid": "pu"}]}}
    store.add_resourceclaim(claim)
    stub = ApiStub(str(CERTS / "server.crt"), str(CERTS / "server.key"),
                   token=TOKEN, store=store)
    stub.start()
    registry = tempfile.mkdtemp(prefix="reg-")
    root = tmp_path
    proc = subprocess.Popen(
        [sys.executable, "-m", "vtpu_manager_torch.cmd.kubelet_plugin",
         "--node-name", "node-1", "--fake-chips", "1",
         "--plugin-dir", str(root / "plugins"), "--registry-dir", registry,
         "--base-dir", str(root / "mgr"), "--cdi-dir", str(root / "cdi"),
         "--vmem-path", str(root / "vmem" / "vmem_node.config"),
         "--lock-dir", str(root / "locks"),
         "--watcher-dir", str(root / "watcher"),
         "--driver-dir", str(root / "driver"),
         "--service-account-dir", _service_account(root)],
        cwd=REPO, env=_command_env(stub.url), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        log = _wait_for_line(proc, "DRA driver running on")
        assert "ResourceSlice published: True" in log, log
        assert [(r["method"], r["path"]) for r in stub.requests[:2]] == [
            ("PUT", "/apis/resource.k8s.io/v1beta1/resourceslices/"
                    "node-1-vtpu"),
            ("POST", "/apis/resource.k8s.io/v1beta1/resourceslices")]
        published = stub.store.resourceslices["node-1-vtpu"]
        assert published["spec"]["nodeName"] == "node-1"
        with grpc.insecure_channel(
                f"unix://{root / 'plugins' / 'dra.sock'}") as chan:
            resp = chan.unary_unary(
                "/v1beta1dra.DRAPlugin/NodePrepareResources",
                request_serializer=
                pb.NodePrepareResourcesRequest.SerializeToString,
                response_deserializer=
                pb.NodePrepareResourcesResponse.FromString)(
                    pb.NodePrepareResourcesRequest(claims=[
                        pb.Claim(uid="uid-c1", name="c1", namespace="ml")]),
                    timeout=20)
        entry = resp.claims["uid-c1"]
        assert not entry.error, entry.error
        assert stub.requests_to(
            "GET", "/apis/resource.k8s.io/v1beta1/namespaces/ml/"
                   "resourceclaims/c1")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stub.stop()
        import shutil
        shutil.rmtree(registry, ignore_errors=True)


def test_device_plugin_without_fake_client_uses_the_api(tmp_path):
    store = FakeKubeClient()
    store.add_node({"metadata": {"name": "node-1", "annotations": {}}})
    stub = ApiStub(str(CERTS / "server.crt"), str(CERTS / "server.key"),
                   token=TOKEN, store=store)
    stub.start()
    root = tmp_path
    proc = subprocess.Popen(
        [sys.executable, "-m", "vtpu_manager_torch.cmd.device_plugin",
         "--node-name", "node-1", "--fake-chips", "1",
         "--plugin-dir", str(root / "plugins"),
         "--base-dir", str(root / "mgr"),
         "--vmem-path", str(root / "vmem" / "vmem_node.config"),
         "--lock-dir", str(root / "locks"),
         "--watcher-dir", str(root / "watcher"),
         "--driver-dir", str(root / "driver"),
         "--service-account-dir", _service_account(root)],
        cwd=REPO, env=_command_env(stub.url), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait_for_line(proc, "device plugin running on")
        patches = stub.requests_to("PATCH", "/api/v1/nodes/node-1")
        assert patches and patches[0]["content_type"] == \
            "application/merge-patch+json"
        anns = stub.store.get_node("node-1")["metadata"]["annotations"]
        assert consts.node_device_register_annotation() in anns
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stub.stop()
