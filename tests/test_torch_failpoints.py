"""The port's failpoint registry against the JAX package's.

`tests/test_resilience.py::TestFailpoints`' cases run through both
packages (`pkg`); the same seed, arms and calls give the same fire
sequence, torn sizes, stats and `render_failpoint_metrics` text in both;
the two node-side DRA chaos cases of `tests/test_chaos.py` run on the
port's DeviceState; each site the port fires (the twelve of its ported
modules and `registry.register`) fires when its operation runs, with the
context keys of the JAX site; and the commands arm the registry from
`VTPU_FAILPOINTS`, refusing a malformed spec.
"""

from __future__ import annotations

import ast
import json
import os
import threading
import time
from random import Random
from types import SimpleNamespace

import pytest

from vtpu_manager import trace as jtrace
from vtpu_manager.client.kube import KubeError as JKubeError
from vtpu_manager.resilience import failpoints as jfp
from vtpu_manager.resilience.policy import RetryPolicy as JRetryPolicy
from vtpu_manager.trace import assemble as jassemble
from vtpu_manager.util.flock import LockTimeout as JLockTimeout
from vtpu_manager_torch import trace as ttrace
from vtpu_manager_torch.client.kube import KubeError
from vtpu_manager_torch.resilience import failpoints as tfp
from vtpu_manager_torch.resilience.policy import (RetryPolicy,
                                                  render_resilience_metrics)
from vtpu_manager_torch.trace import assemble as tassemble
from vtpu_manager_torch.util import consts
from vtpu_manager_torch.util.flock import LockTimeout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": SimpleNamespace(failpoints=jfp, KubeError=JKubeError,
                           LockTimeout=JLockTimeout, RetryPolicy=JRetryPolicy,
                           trace=jtrace, assemble=jassemble),
    "torch": SimpleNamespace(failpoints=tfp, KubeError=KubeError,
                             LockTimeout=LockTimeout, RetryPolicy=RetryPolicy,
                             trace=ttrace, assemble=tassemble),
}


@pytest.fixture(autouse=True)
def _clean_failpoints():
    jfp.disable()
    tfp.disable()
    yield
    jfp.disable()
    tfp.disable()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class TestFailpoints:
    """`tests/test_resilience.py:193-377`, through either package."""

    def test_disabled_fast_path_is_one_dict_lookup(self, pkg):
        fp = pkg.failpoints

        class CountingDict(dict):
            gets = 0

            def get(self, key, default=None):
                CountingDict.gets += 1
                return super().get(key, default)

        original = fp._ARMED
        fp._ARMED = CountingDict()
        try:
            for _ in range(100):
                assert fp.fire("kube.request", op="x") is None
            assert CountingDict.gets == 100
        finally:
            fp._ARMED = original
        assert fp.stats()["total"] == 0
        assert fp.stats()["evaluations"] == 0

    def test_arm_requires_enable(self, pkg):
        with pytest.raises(RuntimeError):
            pkg.failpoints.arm("kube.request", "error")

    def test_unknown_site_and_action_rejected(self, pkg):
        pkg.failpoints.enable(seed=1)
        with pytest.raises(KeyError):
            pkg.failpoints.arm("no.such.site", "error")
        with pytest.raises(ValueError):
            pkg.failpoints.arm("kube.request", "explode")

    def test_error_action_raises_kube_error_with_status(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm("kube.request", "error", status=429)
        with pytest.raises(pkg.KubeError) as exc:
            fp.fire("kube.request", op="x")
        assert exc.value.status == 429
        assert fp.stats()["fires"]["kube.request"] == 1

    def test_error_action_custom_exception(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm("flock.acquire", "error", exc=pkg.LockTimeout)
        with pytest.raises(pkg.LockTimeout):
            fp.fire("flock.acquire", path="/x")

    def test_crash_action_is_base_exception(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm("plugin.allocate", "crash")
        try:
            fp.fire("plugin.allocate", pod_uid="u")
        except Exception:  # noqa: BLE001 - the point under test
            pytest.fail("CrashFailpoint must not be catchable as Exception")
        except BaseException as e:
            assert isinstance(e, fp.CrashFailpoint)

    def test_count_bounds_total_fires(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm("kube.request", "error", count=2)
        for _ in range(2):
            with pytest.raises(pkg.KubeError):
                fp.fire("kube.request", op="x")
        fp.fire("kube.request", op="x")   # exhausted: no raise
        assert fp.stats()["fires"]["kube.request"] == 2

    def test_probability_is_seeded_and_deterministic(self, pkg):
        fp = pkg.failpoints

        def run(seed):
            fp.disable()
            fp.enable(seed=seed)
            fp.arm("kube.request", "error", p=0.5)
            fired = []
            for _ in range(40):
                try:
                    fp.fire("kube.request", op="x")
                    fired.append(False)
                except pkg.KubeError:
                    fired.append(True)
            return fired

        a, b, c = run(11), run(11), run(12)
        assert a == b
        assert a != c
        assert any(a) and not all(a)

    def test_match_targets_one_op(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm("kube.request", "error", match={"op": "bind_pod"})
        fp.fire("kube.request", op="list_pods")   # no-op
        with pytest.raises(pkg.KubeError):
            fp.fire("kube.request", op="bind_pod")

    def test_latency_action_sleeps_and_returns(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm("flock.acquire", "latency", latency_s=0.0)
        assert fp.fire("flock.acquire", path="/x") is None
        assert fp.stats()["fires"]["flock.acquire"] == 1

    def test_partial_write_truncates_then_crashes(self, pkg, tmp_path):
        fp = pkg.failpoints
        victim = tmp_path / "vtpu.config"
        victim.write_bytes(b"A" * 1000)
        fp.enable(seed=5)
        fp.arm("plugin.config_write", "partial-write")
        with pytest.raises(fp.CrashFailpoint):
            fp.fire("plugin.config_write", path=str(victim))
        assert 0 < len(victim.read_bytes()) < 1000

    def test_arm_spec_grammar(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm_spec("kube.request=error(429,p=0.5,count=3);"
                    "flock.acquire=latency(0.002);"
                    "plugin.allocate=crash(p=0.25)")
        assert set(fp.armed_sites()) == {
            "kube.request", "flock.acquire", "plugin.allocate"}
        spec = fp._ARMED["kube.request"]
        assert (spec.status, spec.p, spec.count) == (429, 0.5, 3)
        assert fp._ARMED["flock.acquire"].latency_s == 0.002
        with pytest.raises(ValueError):
            fp.arm_spec("kube.request=error(503,bogus=1)")

    def test_error_carries_retry_after(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm("kube.request", "error", status=429, retry_after=7.5)
        with pytest.raises(pkg.KubeError) as exc_info:
            fp.fire("kube.request", op="list_pods")
        assert exc_info.value.status == 429
        assert exc_info.value.retry_after == 7.5

    def test_arm_spec_retry_after(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm_spec("kube.request=error(429,retry_after=2.5)")
        spec = fp._ARMED["kube.request"]
        assert (spec.status, spec.retry_after) == (429, 2.5)
        with pytest.raises(ValueError):
            fp.arm_spec("flock.acquire=latency(0.1,retry_after=1)")

    def test_injected_retry_after_floors_policy_backoff(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=3)
        fp.arm("kube.request", "error", status=429, retry_after=4.0,
               count=2)
        sleeps: list[float] = []
        policy = pkg.RetryPolicy(max_attempts=5, base_delay_s=0.01,
                                 max_delay_s=0.05, deadline_s=60.0,
                                 rng=Random(7), sleep=sleeps.append)

        def op():
            fp.fire("kube.request", op="get_pod")
            return "ok"

        assert policy.run(op, op="retry_after.e2e") == "ok"
        assert len(sleeps) == 2
        assert all(delay >= 4.0 for delay in sleeps)

    def test_fires_recorded_as_vtrace_events(self, pkg, tmp_path):
        pkg.trace.configure("chaos", str(tmp_path), sampling_rate=1.0)
        try:
            pkg.failpoints.enable(seed=1)
            pkg.failpoints.arm("plugin.allocate", "latency", latency_s=0.0)
            pkg.failpoints.fire("plugin.allocate", pod_uid="pod-uid-1")
            pkg.trace.flush()
            spans, _ = pkg.assemble.read_spools(str(tmp_path))
            assert "failpoint.plugin.allocate" in [s.stage for s in spans]
        finally:
            pkg.trace.reset()

    def test_render_failpoint_metrics(self, pkg):
        fp = pkg.failpoints
        fp.enable(seed=1)
        fp.arm("snapshot.apply", "latency", latency_s=0.0)
        fp.fire("snapshot.apply", kind="pods")
        assert 'vtpu_failpoint_fires_total{site="snapshot.apply"} 1' in \
            fp.render_failpoint_metrics()


# --- the same registry on the same inputs -------------------------------------

def test_catalog_equals_the_jax_catalog():
    assert tfp.SITES == jfp.SITES
    assert tfp.ACTIONS == jfp.ACTIONS


def _script(fp, kube_error, root: str) -> list:
    """One scripted run: arms, then a mixed call sequence; what each call
    did (fired action, torn size), then stats and metrics."""
    fp.arm("kube.request", "error", p=0.4, status=503)
    fp.arm("flock.acquire", "latency", p=0.5, latency_s=0.0, count=7)
    fp.arm("kube.watch", "error", status=410, match={"op": "pods"})
    fp.arm("plugin.config_write", "partial-write", p=0.3)
    fp.arm("dra.prepare", "crash", p=0.2)
    out = []
    for i in range(60):
        path = os.path.join(root, f"f{i}")
        with open(path, "wb") as f:
            f.write(b"x" * 4096)
        for site, ctx in (("kube.request", {"op": "get_pod"}),
                          ("flock.acquire", {"path": path}),
                          ("kube.watch", {"op": "pods" if i % 3 else "nodes"}),
                          ("plugin.config_write",
                           {"pod_uid": "u", "path": path}),
                          ("dra.prepare", {"claim": f"c{i}"})):
            before = fp.stats()["total"]
            try:
                fp.fire(site, **ctx)
                what = "latency" if fp.stats()["total"] > before else "-"
            except kube_error as e:
                what = f"error {e.status}"
            except fp.CrashFailpoint:
                what = f"crash {os.path.getsize(path)}"
            out.append((i, site, what))
    return out + [fp.stats(), fp.render_failpoint_metrics()]


@pytest.mark.parametrize("seed", [0, 7, 2026])
def test_same_seed_same_fire_sequence_stats_and_metrics(tmp_path, seed):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jfp.enable(seed=seed)
    theirs = _script(jfp, JKubeError, str(tmp_path / "j"))
    tfp.enable(seed=seed)
    mine = _script(tfp, KubeError, str(tmp_path / "t"))
    assert mine == theirs
    assert mine[-2]["total"] > 0


@pytest.mark.parametrize("spec", [
    "kube.request=error(429,p=0.5,count=3);flock.acquire=latency(0.002)",
    "plugin.config_write=partial-write(count=1)",
    "dra.cdi_write=partial-write(count=1);dra.prepare=crash(p=0.25)",
    " ; kube.watch=error(410) ;",
    "no.such.site=error(503)",
    "kube.request=explode",
    "kube.request",
    "kube.request=error(503,bogus=1)",
    "flock.acquire=latency(0.1,retry_after=1)",
    "plugin.allocate=crash(7)",
])
def test_arm_spec_gives_the_jax_verdict(spec):
    verdicts = []
    for fp in (jfp, tfp):
        fp.enable(seed=1)
        try:
            fp.arm_spec(spec)
            verdicts.append(("ok", fp.armed_sites(),
                             {s: vars(v) for s, v in fp._ARMED.items()}))
        except (KeyError, ValueError) as e:
            verdicts.append((type(e).__name__,))
    assert verdicts[0] == verdicts[1]


def test_metrics_block_is_rendered_by_the_resilience_metrics():
    tfp.enable(seed=1)
    tfp.arm("health.probe", "latency", latency_s=0.0)
    tfp.fire("health.probe", chip="GPU-0")
    text = render_resilience_metrics()
    assert 'vtpu_failpoint_fires_total{site="health.probe"} 1' in text
    assert "vtpu_failpoint_evaluations_total 1" in text


def test_arm_from_env_arms_and_refuses_a_malformed_spec():
    tfp.arm_from_env({"VTPU_FAILPOINTS": "plugin.allocate=crash(count=1)",
                      "VTPU_FAILPOINTS_SEED": "3"})
    assert tfp.armed_sites() == ["plugin.allocate"]
    for bad in ("plugin.allocate=explode", "nope=crash",
                "kube.request=error(x)"):
        with pytest.raises(ValueError, match="VTPU_FAILPOINTS"):
            tfp.arm_from_env({"VTPU_FAILPOINTS": bad})
        assert not tfp.is_enabled() and tfp.armed_sites() == []


@pytest.mark.parametrize("agent", ["device_plugin", "kubelet_plugin",
                                   "device_monitor"])
def test_each_agent_refuses_a_malformed_spec(tmp_path, agent):
    """Under FaultInjection a malformed `VTPU_FAILPOINTS` exits 2 and names
    the spec before the agent discovers or serves anything."""
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("VTPU_")}
    env.update(PYTHONPATH=REPO, VTPU_FAILPOINTS="plugin.allocate=explode")
    res = subprocess.run(
        [sys.executable, "-m", f"vtpu_manager_torch.cmd.{agent}",
         "--node-name", "n1", "--fake-chips", "1",
         "--feature-gates", "FaultInjection=true"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=60)
    assert res.returncode == 2, res.stdout + res.stderr
    out = res.stdout + res.stderr
    assert "bad failpoint spec" in out and "plugin.allocate=explode" in out


# --- tests/test_chaos.py's DRA cases, on the port's DeviceState --------------

def _dra_claim(uid, config):
    return {
        "metadata": {"uid": uid, "name": "c1", "namespace": "ml"},
        "status": {"allocation": {"devices": {
            "results": [{"request": "tpu", "driver": consts.DRA_DRIVER_NAME,
                         "pool": "node-1", "device": "vtpu-0"}],
            "config": config}}},
    }


def _dra_state(tmp_path):
    from vtpu_manager_torch.device.types import ChipSpec
    from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
    chip = ChipSpec(uuid="GPU-FAKE-0000", index=0, chip_type="h100",
                    memory=16 * 2**30, split_count=10)
    return lambda: DeviceState(
        "node-1", [chip], base_dir=str(tmp_path / "mgr"),
        cdi_dir=str(tmp_path / "cdi"), minors={0: 0})


def test_chaos_dra_torn_cdi_spec_does_not_leak_claim(tmp_path):
    from vtpu_manager_torch.kubeletplugin import cdi
    claim = _dra_claim("claim-torn", [{"requests": ["tpu"], "opaque": {
        "driver": consts.DRA_DRIVER_NAME,
        "parameters": {"cores": 50, "memoryMiB": 1024}}}])
    new_state = _dra_state(tmp_path)
    state = new_state()
    tfp.enable(seed=7)
    tfp.arm("dra.cdi_write", "partial-write", p=1.0, count=1)
    with pytest.raises(tfp.CrashFailpoint):
        state.prepare_claim(claim)
    spec_path = cdi.spec_path("claim-torn", state.cdi_dir)
    assert os.path.exists(spec_path)
    with pytest.raises(json.JSONDecodeError):
        with open(spec_path) as f:
            json.load(f)
    assert "claim-torn" not in state.prepared_uids()
    # a restart, then the kubelet's retry: prepared whole
    tfp.disable()
    state2 = new_state()
    assert state2.prepare_claim(claim) == [cdi.cdi_device_name("claim-torn")]
    with open(spec_path) as f:
        assert json.load(f)["devices"]
    assert "claim-torn" in state2.prepared_uids()


def test_chaos_dra_prepare_error_is_clean_retry(tmp_path):
    from vtpu_manager_torch.kubeletplugin import cdi
    claim = _dra_claim("claim-err", [])
    state = _dra_state(tmp_path)()
    tfp.enable(seed=11)
    tfp.arm("dra.prepare", "error", p=1.0, count=1)
    with pytest.raises(KubeError):
        state.prepare_claim(claim)
    assert not os.path.exists(cdi.spec_path("claim-err", state.cdi_dir))
    assert "claim-err" not in state.prepared_uids()
    tfp.disable()
    assert state.prepare_claim(claim) == [cdi.cdi_device_name("claim-err")]


# --- every ported site fires, with the JAX site's context keys ----------------

JAX_SITE_FILES = ("client/kube.py", "client/fake.py", "util/flock.py",
                  "deviceplugin/vnum.py", "manager/device_manager.py",
                  "kubeletplugin/device_state.py", "compilecache/cache.py",
                  "trace/recorder.py", "registry/server.py")
PORTED_SITES = ("kube.request", "kube.watch", "flock.acquire",
                "plugin.allocate", "plugin.config_write",
                "plugin.record_devices", "health.probe", "dra.prepare",
                "dra.cdi_write", "cache.write", "cache.lease",
                "trace.spool_flush", "registry.register")


def _fire_calls(pkg_dir: str) -> dict[str, set[frozenset]]:
    """site -> the keyword sets of its `failpoints.fire` calls in the
    package's files above."""
    out: dict[str, set[frozenset]] = {}
    for rel in JAX_SITE_FILES:
        with open(os.path.join(REPO, pkg_dir, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fire"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "failpoints"):
                site = node.args[0].value
                out.setdefault(site, set()).add(
                    frozenset(k.arg for k in node.keywords))
    return out


def test_the_port_fires_the_jax_sites_with_their_keys():
    theirs = _fire_calls("vtpu_manager")
    mine = _fire_calls("vtpu_manager_torch")
    assert set(theirs) == set(mine) == set(PORTED_SITES)
    for site in PORTED_SITES:
        assert mine[site] <= theirs[site], site


@pytest.fixture
def recorded(monkeypatch):
    """Every `failpoints.fire` call of the port: (site, its ctx keys)."""
    calls: list[tuple[str, frozenset]] = []
    original = tfp.fire

    def fire(site, **ctx):
        calls.append((site, frozenset(ctx)))
        return original(site, **ctx)

    monkeypatch.setattr(tfp, "fire", fire)
    return calls


def test_each_ported_site_fires_when_its_operation_runs(tmp_path, recorded,
                                                        monkeypatch):
    from test_torch_deviceplugin import alloc, committed_pod, make_manager
    from vtpu_manager_torch.client.fake import FakeKubeClient
    from vtpu_manager_torch.client.kube import InClusterClient
    from vtpu_manager_torch.compilecache import CompileCache
    from vtpu_manager_torch.config.node_config import NodeConfig
    from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin, device_id
    from vtpu_manager_torch.manager.device_manager import HealthWatcher
    from vtpu_manager_torch.registry.server import RegistryServer
    from vtpu_manager_torch.trace.recorder import Span, SpanRecorder
    from vtpu_manager_torch.util.flock import FileLock

    theirs = _fire_calls("vtpu_manager")
    # the in-cluster client: the sites fire before any I/O, so an armed
    # error stands in for the API server
    tfp.enable(seed=1)
    tfp.arm("kube.request", "error", status=503)
    tfp.arm("kube.watch", "error", status=503)
    (tmp_path / "token").write_text("t")
    client = InClusterClient(
        "https://127.0.0.1:1", token_path=str(tmp_path / "token"),
        ca_path=os.path.join(REPO, "tests/data/kube-stub/ca.crt"))
    with pytest.raises(KubeError):
        client.get_node("n1")
    with pytest.raises(KubeError):
        next(iter(client.watch_pods("0")))
    tfp.disable()
    # the fake client, the plugin, its health watcher
    fake = FakeKubeClient()
    mgr = make_manager(fake)
    plugin = VnumPlugin(mgr, fake, "node-1", node_config=NodeConfig(),
                        base_dir=str(tmp_path / "mgr"),
                        lock_dir=str(tmp_path / "locks"),
                        vmem_dir=str(tmp_path / "vmem"),
                        watcher_dir=str(tmp_path / "watcher"),
                        shim_host_dir=str(tmp_path / "driver"))
    fake.add_pod(committed_pod(mgr))
    fake.watch_pods("0")
    alloc(plugin, device_id(mgr.chips[0].uuid, 0))
    HealthWatcher(mgr, lambda chip: True).check_once()
    FileLock(str(tmp_path / "l.lock")).acquire()
    # DRA
    state = _dra_state(tmp_path)()
    state.prepare_claim(_dra_claim("claim-k", []))
    # the compile cache
    CompileCache(str(tmp_path / "cc")).get_or_compile("a" * 64,
                                                      lambda: b"payload")
    # the span spool
    rec = SpanRecorder("svc", str(tmp_path / "spool"))
    rec.record(Span(stage="x", trace_id="t", start_s=time.time()))
    rec.flush()
    # the registry
    uid = "11111111-2222-3333-4444-555555555555"
    (tmp_path / "reg" / f"{uid}_main" / "config").mkdir(parents=True)
    reg = RegistryServer(socket_path=str(tmp_path / "r.sock"),
                         base_dir=str(tmp_path / "reg"),
                         cgroup_of_pid=lambda pid: f"/kubepods/pod{uid}/a",
                         pids_in_cgroup=lambda cg: [1])
    assert reg.handle_request({"pod_uid": uid, "container": "main"}, 1) == 0

    seen: dict[str, set[frozenset]] = {}
    for site, keys in recorded:
        seen.setdefault(site, set()).add(keys)
    assert set(seen) == set(PORTED_SITES)
    for site, keysets in seen.items():
        assert keysets <= theirs[site], (site, keysets, theirs[site])


def test_registry_register_fires_inside_attestation(tmp_path):
    """`registry.register` fires after attestation and before the write
    (an armed error then leaves no pids.config), as in JAX."""
    from vtpu_manager_torch.registry.server import RegistryServer
    uid = "11111111-2222-3333-4444-555555555555"
    cfg = tmp_path / f"{uid}_main" / "config"
    cfg.mkdir(parents=True)
    reg = RegistryServer(socket_path=str(tmp_path / "r.sock"),
                         base_dir=str(tmp_path),
                         cgroup_of_pid=lambda pid: f"/kubepods/pod{uid}/a",
                         pids_in_cgroup=lambda cg: [1])
    tfp.enable(seed=1)
    tfp.arm("registry.register", "error", status=503, count=1)
    with pytest.raises(KubeError):
        reg.handle_request({"pod_uid": uid, "container": "main"}, 1)
    assert not (cfg / consts.PIDS_CONFIG_NAME).exists()
    # a spoofed uid is refused before the site
    other = "aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee"
    assert reg.handle_request({"pod_uid": other, "container": "main"},
                              1) == 3
    assert tfp.stats()["fires"] == {"registry.register": 1}
    assert reg.handle_request({"pod_uid": uid, "container": "main"}, 1) == 0


def test_a_torn_config_is_written_whole_by_the_retried_allocate(tmp_path):
    """`plugin.config_write=partial-write(count=1)`: the Allocate crashes
    with the config torn, and the kubelet's retry writes it whole."""
    from test_torch_deviceplugin import (alloc, committed_pod, config_of,
                                         make_manager, node_dirs)
    from vtpu_manager_torch.client.fake import FakeKubeClient
    from vtpu_manager_torch.config import vtpu_config as vc
    from vtpu_manager_torch.config.node_config import NodeConfig
    from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin, device_id
    fake = FakeKubeClient()
    mgr = make_manager(fake)
    plugin = VnumPlugin(mgr, fake, "node-1", node_config=NodeConfig(),
                        **node_dirs(tmp_path))
    pod = committed_pod(mgr, cores=25, memory=8 * 2**30)
    fake.add_pod(pod)
    dev = device_id(mgr.chips[0].uuid, 0)
    tfp.arm_from_env(
        {"VTPU_FAILPOINTS": "plugin.config_write=partial-write(count=1)"})
    with pytest.raises(tfp.CrashFailpoint):
        alloc(plugin, dev)
    path = os.path.join(str(tmp_path / "mgr"), "uid-p1_main", "config",
                        "vtpu.config")
    assert 0 < os.path.getsize(path) < vc.CONFIG_SIZE
    cfg = config_of(alloc(plugin, dev))
    assert cfg.devices[0].total_memory == 8 * 2**30
    assert cfg.devices[0].hard_core == 25
    assert tfp.stats()["fires"] == {"plugin.config_write": 1}


def test_gate_off_counts_nothing_across_threads(tmp_path):
    """With the registry off, the sites cost one lookup each and count
    nothing, however many threads cross them."""
    from vtpu_manager_torch.util.flock import FileLock
    errors = []

    def worker(i):
        try:
            for j in range(50):
                with FileLock(str(tmp_path / f"{i}.lock")):
                    pass
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert tfp.stats() == {"fires": {}, "total": 0, "evaluations": 0}
