"""The port's node registry (ClientMode) against the JAX package's.

`tests/test_registry.py`'s cases run through both packages (`pkg`: the
server, the runtime client's `register_client` and `consts`), each
package's client against the other's server, `handle_request`'s verdict
on a grid of identities equal in both, `pids.config` from each writer
read by each reader byte for byte, `reap_orphans`' two-strike rule, and
the device plugin's `--registry-socket` and `--metrics-port`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import vtpu_manager.runtime.client as jclient
from vtpu_manager import trace as jtrace
from vtpu_manager.registry import server as jserver
from vtpu_manager.resilience import failpoints as jfp
from vtpu_manager.resilience.policy import \
    render_resilience_metrics as jrender
from vtpu_manager.util import consts as jconsts
import vtpu_manager_torch.runtime.client as tclient
from vtpu_manager_torch import trace as ttrace
from vtpu_manager_torch.cmd import device_plugin
from vtpu_manager_torch.registry import server as tserver
from vtpu_manager_torch.resilience import failpoints as tfp
from vtpu_manager_torch.resilience.policy import \
    render_resilience_metrics as trender
from vtpu_manager_torch.util import consts as tconsts

UID_GOOD = "11111111-2222-3333-4444-555555555555"
UID_OTHER = "aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": SimpleNamespace(server=jserver, client=jclient, consts=jconsts,
                           trace=jtrace),
    "torch": SimpleNamespace(server=tserver, client=tclient, consts=tconsts,
                             trace=ttrace),
}


@pytest.fixture(autouse=True)
def _clean():
    jfp.disable()
    tfp.disable()
    yield
    jfp.disable()
    tfp.disable()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _cgroup_of_pid(pid):
    return ("/kubepods.slice/kubepods-burstable.slice/"
            f"kubepods-burstable-pod{UID_GOOD.replace('-', '_')}.slice/"
            f"cri-containerd-leaf{pid}.scope")


@pytest.fixture
def short_dir():
    d = tempfile.mkdtemp(prefix="vreg")   # a unix socket path stays short
    yield d
    for name in os.listdir(d):
        os.unlink(os.path.join(d, name))
    os.rmdir(d)


def _serve(server_mod, tmp_path, sock):
    base = tmp_path / "mgr"
    base.mkdir(exist_ok=True)
    server = server_mod.RegistryServer(
        socket_path=sock, base_dir=str(base), cgroup_of_pid=_cgroup_of_pid,
        pids_in_cgroup=lambda cgroup: [os.getpid(), 4242])
    server.start()
    return server, base


@pytest.fixture
def registry(pkg, tmp_path, short_dir):
    server, base = _serve(pkg.server, tmp_path,
                          os.path.join(short_dir, "r.sock"))
    yield server, base, server.socket_path
    server.stop()


def register(client_pkg, sock, pod_uid, container, monkeypatch):
    monkeypatch.setenv("VTPU_POD_UID", pod_uid)
    monkeypatch.setenv("VTPU_CONTAINER_NAME", container)
    monkeypatch.setenv("VTPU_POD_NAME", "p")
    monkeypatch.setenv("VTPU_POD_NAMESPACE", "ns")
    monkeypatch.delenv("VTPU_REGISTRY_SOCKET", raising=False)
    monkeypatch.setattr(client_pkg.consts, "REGISTRY_SOCKET", sock)
    return client_pkg.client.register_client(timeout_s=5)


class TestRegistry:
    """`tests/test_registry.py::TestRegistry`, through either package."""

    def test_successful_registration(self, pkg, registry, monkeypatch):
        server, base, sock = registry
        (base / f"{UID_GOOD}_main" / "config").mkdir(parents=True)
        assert register(pkg, sock, UID_GOOD, "main", monkeypatch)
        pids = pkg.server.read_pids_config(
            str(base / f"{UID_GOOD}_main" / "config"
                / pkg.consts.PIDS_CONFIG_NAME))
        assert os.getpid() in pids and 4242 in pids
        assert server.registrations[0]["pod_uid"] == UID_GOOD

    def test_spoofed_identity_rejected(self, pkg, registry, monkeypatch):
        server, base, sock = registry
        (base / f"{UID_OTHER}_main" / "config").mkdir(parents=True)
        assert not register(pkg, sock, UID_OTHER, "main", monkeypatch)
        assert not (base / f"{UID_OTHER}_main" / "config" /
                    pkg.consts.PIDS_CONFIG_NAME).exists()

    def test_generic_uid_claim_rejected(self, pkg, registry, monkeypatch):
        server, base, sock = registry
        (base / "kubepods_main" / "config").mkdir(parents=True)
        assert not register(pkg, sock, "kubepods", "main", monkeypatch)

    def test_traversal_container_rejected(self, pkg, registry, monkeypatch):
        server, base, sock = registry
        victim = base / f"{UID_OTHER}_main" / "config"
        victim.mkdir(parents=True)
        pkg.server.write_pids_config(
            str(victim / pkg.consts.PIDS_CONFIG_NAME), [7])
        (base / f"{UID_GOOD}_c" / "config").mkdir(parents=True)
        evil = f"c/../../{UID_OTHER}_main"
        assert not register(pkg, sock, UID_GOOD, evil, monkeypatch)
        assert pkg.server.read_pids_config(
            str(victim / pkg.consts.PIDS_CONFIG_NAME)) == [7]

    def test_unallocated_container_rejected(self, pkg, registry,
                                            monkeypatch):
        server, base, sock = registry
        assert not register(pkg, sock, UID_GOOD, "ghost", monkeypatch)

    def test_malformed_payload(self, pkg, registry, monkeypatch):
        server, base, sock = registry
        assert not register(pkg, sock, "", "", monkeypatch)

    def test_leaf_cannot_claim_second_container(self, pkg, registry,
                                                monkeypatch):
        server, base, sock = registry
        (base / f"{UID_GOOD}_main" / "config").mkdir(parents=True)
        (base / f"{UID_GOOD}_side" / "config").mkdir(parents=True)
        assert register(pkg, sock, UID_GOOD, "main", monkeypatch)
        assert not register(pkg, sock, UID_GOOD, "side", monkeypatch)
        assert register(pkg, sock, UID_GOOD, "main", monkeypatch)


class TestPodUidExtraction:
    def test_systemd_style(self, pkg):
        cg = ("/kubepods.slice/kubepods-burstable.slice/kubepods-burstable-"
              "pod11111111_2222_3333_4444_555555555555.slice/x.scope")
        assert pkg.server.pod_uid_from_cgroup(cg) == UID_GOOD

    def test_cgroupfs_style(self, pkg):
        cg = f"/kubepods/burstable/pod{UID_GOOD}/abcdef"
        assert pkg.server.pod_uid_from_cgroup(cg) == UID_GOOD

    def test_no_uid(self, pkg):
        assert pkg.server.pod_uid_from_cgroup("/user.slice/user-0.slice") \
            == ""


class TestPidsConfig:
    def test_roundtrip(self, pkg, tmp_path):
        path = str(tmp_path / "pids.config")
        pkg.server.write_pids_config(path, [1, 99, 100000])
        assert pkg.server.read_pids_config(path) == [1, 99, 100000]

    def test_corrupt(self, pkg, tmp_path):
        path = str(tmp_path / "pids.config")
        with open(path, "wb") as f:
            f.write(b"\0" * 16)
        with pytest.raises(ValueError):
            pkg.server.read_pids_config(path)


class TestLeafRebinding:
    def _server(self, pkg, tmp_path, cgroups, live):
        base = tmp_path / "mgr"
        base.mkdir(exist_ok=True)
        (base / f"{UID_GOOD}_main" / "config").mkdir(parents=True,
                                                     exist_ok=True)
        return pkg.server.RegistryServer(
            socket_path=str(tmp_path / "r.sock"), base_dir=str(base),
            cgroup_of_pid=lambda pid: cgroups[pid],
            pids_in_cgroup=lambda cg: live.get(cg, [])), base

    def test_restart_rebinds_after_old_leaf_dies(self, pkg, tmp_path):
        pod_slice = f"/kubepods/pod{UID_GOOD}"
        cg1, cg2 = f"{pod_slice}/leaf1", f"{pod_slice}/leaf2"
        live = {cg1: [100]}
        server, _ = self._server(pkg, tmp_path, {100: cg1, 200: cg2}, live)
        assert server.handle_request(
            {"pod_uid": UID_GOOD, "container": "main"}, 100) == 0
        live.pop(cg1)
        live[cg2] = [200]
        assert server.handle_request(
            {"pod_uid": UID_GOOD, "container": "main"}, 200) == 0
        assert server._bind[(UID_GOOD, "main")] == cg2

    def test_live_binding_not_stolen(self, pkg, tmp_path):
        pod_slice = f"/kubepods/pod{UID_GOOD}"
        cg1, cg2 = f"{pod_slice}/leaf1", f"{pod_slice}/leaf2"
        live = {cg1: [100], cg2: [200]}
        server, _ = self._server(pkg, tmp_path, {100: cg1, 200: cg2}, live)
        assert server.handle_request(
            {"pod_uid": UID_GOOD, "container": "main"}, 100) == 0
        assert server.handle_request(
            {"pod_uid": UID_GOOD, "container": "main"}, 200) == 3

    def test_failed_attempt_does_not_poison_slot(self, pkg, tmp_path):
        pod_slice = f"/kubepods/pod{UID_GOOD}"
        cg1, cg2 = f"{pod_slice}/leaf1", f"{pod_slice}/leaf2"
        live = {cg1: [100], cg2: [200]}
        server, _ = self._server(pkg, tmp_path, {100: cg1, 200: cg2}, live)
        assert server.handle_request(
            {"pod_uid": UID_GOOD, "container": "side"}, 100) == 4
        assert (UID_GOOD, "side") not in server._bind
        assert server.handle_request(
            {"pod_uid": UID_GOOD, "container": "main"}, 100) == 0

    def test_dead_pod_bindings_reaped(self, pkg, tmp_path):
        cg_old = f"/kubepods/pod{UID_OTHER}/leafX"
        cg_new = f"/kubepods/pod{UID_GOOD}/leaf1"
        live = {cg_old: [100], cg_new: [200]}
        server, base = self._server(pkg, tmp_path,
                                    {100: cg_old, 200: cg_new}, live)
        (base / f"{UID_OTHER}_main" / "config").mkdir(parents=True)
        assert server.handle_request(
            {"pod_uid": UID_OTHER, "container": "main"}, 100) == 0
        live.pop(cg_old)
        assert server.handle_request(
            {"pod_uid": UID_GOOD, "container": "main"}, 200) == 0
        assert (UID_OTHER, "main") not in server._bind

    def test_reap_orphans_needs_two_strikes(self, pkg, tmp_path):
        cg = f"/kubepods/pod{UID_GOOD}/leaf1"
        server, _ = self._server(pkg, tmp_path, {100: cg}, {cg: [100]})
        assert server.handle_request(
            {"pod_uid": UID_GOOD, "container": "main"}, 100) == 0
        assert server.reap_orphans(set()) == 0          # first strike
        assert server.reap_orphans({UID_GOOD}) == 0     # vindicated
        assert server.reap_orphans(set()) == 0
        assert server.reap_orphans(set()) == 1          # two in a row
        assert (UID_GOOD, "main") not in server._bind


# --- the port against the JAX package on the same inputs ----------------------

@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "torch"), ("torch", "jax")])
def test_each_client_registers_with_the_other_server(
        tmp_path, short_dir, monkeypatch, server_pkg, client_pkg):
    server, base = _serve(PKGS[server_pkg].server, tmp_path,
                          os.path.join(short_dir, "x.sock"))
    try:
        (base / f"{UID_GOOD}_main" / "config").mkdir(parents=True)
        assert register(PKGS[client_pkg], server.socket_path, UID_GOOD,
                        "main", monkeypatch)
        assert not register(PKGS[client_pkg], server.socket_path, UID_OTHER,
                            "main", monkeypatch)
    finally:
        server.stop()
    assert [r["pod_uid"] for r in server.registrations] == [UID_GOOD]


IDENTITIES = [
    {"pod_uid": UID_GOOD, "container": "main"},
    {"pod_uid": UID_GOOD.upper(), "container": "main"},
    {"pod_uid": UID_OTHER, "container": "main"},
    {"pod_uid": UID_GOOD, "container": "Main"},
    {"pod_uid": UID_GOOD, "container": "a" * 64},
    {"pod_uid": UID_GOOD, "container": "-x"},
    {"pod_uid": UID_GOOD, "container": "../x"},
    {"pod_uid": "kubepods", "container": "main"},
    {"pod_uid": UID_GOOD},
    {"container": "main"},
    {"pod_uid": UID_GOOD, "container": "ghost"},
    {"pod_uid": 7, "container": "main"},
]


def test_handle_request_gives_the_jax_verdicts(tmp_path):
    verdicts = {}
    for name, p in PKGS.items():
        base = tmp_path / name
        (base / f"{UID_GOOD}_main" / "config").mkdir(parents=True)
        server = p.server.RegistryServer(
            socket_path=str(tmp_path / f"{name}.sock"), base_dir=str(base),
            cgroup_of_pid=_cgroup_of_pid,
            pids_in_cgroup=lambda cg: [100, 101])
        verdicts[name] = [server.handle_request(dict(i), 100)
                          for i in IDENTITIES]
        verdicts[name].append(p.server.read_pids_config(
            str(base / f"{UID_GOOD}_main" / "config" / "pids.config")))
    assert verdicts["torch"] == verdicts["jax"]
    assert verdicts["torch"][0] == 0


@pytest.mark.parametrize("pids", [[], [1], [3, 1, 2], [2**31 - 1, 1, 4242],
                                  list(range(1000, 1300))])
def test_pids_config_bytes_and_readers_agree(tmp_path, pids):
    mine, theirs = str(tmp_path / "t"), str(tmp_path / "j")
    tserver.write_pids_config(mine, pids)
    jserver.write_pids_config(theirs, pids)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for reader in (tserver.read_pids_config, jserver.read_pids_config):
        assert reader(mine) == reader(theirs) == pids


def test_concurrent_registrations_of_one_container_both_land(
        tmp_path, short_dir):
    """Each tenant process's device client registers at its start, so one
    container's registrations come at once, each on a server thread. The
    port's writer names its temp file by thread (the JAX writer's
    `.tmp.<pid>` is shared by the threads, and one replace then fails)."""
    import threading
    uid = UID_GOOD
    base = tmp_path / "mgr"
    (base / f"{uid}_main" / "config").mkdir(parents=True)
    server = tserver.RegistryServer(
        socket_path=os.path.join(short_dir, "c.sock"), base_dir=str(base),
        cgroup_of_pid=lambda pid: f"/kubepods/pod{uid}/main",
        pids_in_cgroup=lambda cg: [1, 2])
    statuses = []
    barrier = threading.Barrier(8)

    def register(pid):
        barrier.wait()
        for _ in range(20):
            statuses.append(server.handle_request(
                {"pod_uid": uid, "container": "main"}, pid))

    threads = [threading.Thread(target=register, args=(100 + i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert statuses == [0] * 160
    assert len(server.registrations) == 160
    pids = tserver.read_pids_config(
        str(base / f"{uid}_main" / "config" / "pids.config"))
    assert pids[:2] == [1, 2] and len(pids) == 3
    assert not [n for n in os.listdir(base / f"{uid}_main" / "config")
                if ".tmp." in n]


def test_spans_of_a_registration(tmp_path, short_dir, monkeypatch):
    """A traced tenant's `shim.register` and the node's
    `registry.register`, joined by pod uid in one spool dir."""
    spool = str(tmp_path / "spool")
    monkeypatch.setenv("VTPU_TRACE_ID", "t-1")
    monkeypatch.setenv("VTPU_TRACE_SAMPLED", "true")
    monkeypatch.setenv("VTPU_TRACE_DIR", spool)
    ttrace.configure("plugin", spool_dir=spool, sampling_rate=1.0)
    try:
        server, base = _serve(tserver, tmp_path,
                              os.path.join(short_dir, "s.sock"))
        (base / f"{UID_GOOD}_main" / "config").mkdir(parents=True)
        try:
            assert register(PKGS["torch"], server.socket_path, UID_GOOD,
                            "main", monkeypatch)
        finally:
            server.stop()
        ttrace.flush()
        from vtpu_manager_torch.trace import assemble
        spans, _ = assemble.read_spools(spool)
        stages = sorted(s.stage for s in spans)
        assert stages == ["registry.register", "shim.register"], stages
    finally:
        ttrace.reset()


# --- the device plugin's --registry-socket and --metrics-port ------------------

def _scrape(port: int, path: str = "/metrics") -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


def _families(text: str) -> list[str]:
    return [ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE")]


def test_metrics_port_serves_the_jax_families_with_the_gates_off():
    server = device_plugin.serve_metrics(0, host="127.0.0.1")
    try:
        port = server.server_address[1]
        status, text = _scrape(port)
        assert status == 200
        # the JAX endpoint's body with its gates off: the resilience
        # block, the link-load audit empty until its publisher runs
        assert _families(text) == _families(jrender())
        assert text == trender() + "\n"
        assert _scrape(port, "/")[0] == 404
        assert _scrape(port, "/metrics/x")[0] == 404
    finally:
        server.shutdown()
        server.server_close()


def test_metrics_port_counts_the_fires_of_its_process():
    tfp.enable(seed=1)
    tfp.arm("plugin.allocate", "latency", latency_s=0.0)
    tfp.arm("dra.cdi_write", "latency", latency_s=0.0)
    for _ in range(3):
        tfp.fire("plugin.allocate", pod_uid="u", container="main")
    tfp.fire("dra.cdi_write", claim="c", path="/x")
    server = device_plugin.serve_metrics(0, host="127.0.0.1")
    try:
        _, text = _scrape(server.server_address[1])
    finally:
        server.shutdown()
        server.server_close()
    assert 'vtpu_failpoint_fires_total{site="plugin.allocate"} 3' in text
    assert 'vtpu_failpoint_fires_total{site="dra.cdi_write"} 1' in text


def _plugin_args(tmp_path, sock, *extra):
    return [sys.executable, "-m", "vtpu_manager_torch.cmd.device_plugin",
            "--node-name", "n1", "--fake-client", "--fake-chips", "1",
            "--plugin-dir", str(tmp_path / "plugins"),
            "--base-dir", str(tmp_path / "mgr"),
            "--vmem-path", str(tmp_path / "vmem" / "vmem_node.config"),
            "--lock-dir", str(tmp_path / "locks"),
            "--watcher-dir", str(tmp_path / "watcher"),
            "--driver-dir", str(tmp_path / "driver"),
            "--registry-socket", sock, *extra]


def test_plugin_serves_the_registry_under_client_mode(tmp_path, short_dir):
    sock = os.path.join(short_dir, "p.sock")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("VTPU_")}
    env.update(PYTHONPATH=REPO, VTPU_FAILPOINTS="plugin.allocate=crash",
               VTPU_FAILPOINTS_SEED="2")
    proc = subprocess.Popen(
        _plugin_args(tmp_path, sock, "--feature-gates",
                     "ClientMode=true,FaultInjection=true"),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 30
        while not os.path.exists(sock):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    assert f"registry serving on {sock}" in out
    assert "fault injection on: armed ['plugin.allocate']" in out
    assert not os.path.exists(sock)       # stopped with the plugin


def test_plugin_runs_on_when_the_registry_cannot_be_served(tmp_path):
    # a socket path under a file: the registry cannot bind it
    (tmp_path / "f").write_text("")
    proc = subprocess.Popen(
        _plugin_args(tmp_path, str(tmp_path / "f" / "s.sock"),
                     "--feature-gates", "ClientMode=true"),
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 30
        while not (tmp_path / "plugins").exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(0.5)
        assert proc.poll() is None
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert "client-mode pid attribution disabled" in out, out


@pytest.mark.parametrize("spec", ["plugin.allocate=explode",
                                  "no.such=crash", "kube.request=error(x)"])
def test_plugin_exits_on_a_malformed_failpoint_spec(tmp_path, spec):
    res = subprocess.run(
        _plugin_args(tmp_path, str(tmp_path / "r.sock"), "--feature-gates",
                     "FaultInjection=true"),
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO,
                       "VTPU_FAILPOINTS": spec},
        capture_output=True, text=True, timeout=60)
    assert res.returncode == 2
    assert "bad failpoint spec" in res.stdout + res.stderr
    assert spec in res.stdout + res.stderr


def test_gate_off_ignores_the_spec(tmp_path):
    """FaultInjection off: VTPU_FAILPOINTS is not read, as in JAX."""
    proc = subprocess.Popen(
        _plugin_args(tmp_path, str(tmp_path / "r.sock"), "--metrics-port",
                     "0"),
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO,
                       "VTPU_FAILPOINTS": "bogus"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 30
        while not (tmp_path / "plugins").exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    assert "fault injection" not in out and "registry serving" not in out
