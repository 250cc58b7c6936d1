"""The node compile cache, the port's against the JAX package's.

Every key, store, lease, torture, chaos, Allocate and runtime-client case
of tests/test_compilecache.py (:39-354, :617-706) runs through both
packages (`pkg`), and across them: the keys are equal, each store reads
the other's entries and respects the other's leases, and Allocate writes
the same environment, mounts and `vtpu.config` with the gate on and off.
The JAX store's failpoints are not ported, so the port's crash cases crash
the same way by hand: an exception before the rename, a process that
exits holding its lease. The scheduler's anti-storm term and the webhook
(:410-567) are not queued.

Then the kernel's operator: `torch.ops.vtpu.attn_block` in a compiled
graph with no break, equal to eager and to the JAX `attention_block`
(interpret mode) within 2e-5; and `workloads/compiled_step.py` through
the store on the CPU: a process that compiles with Inductor and stores
its artifacts (a miss), then one in empty directories that loads them
(a hit) and gets the same outputs.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from vtpu_manager.compilecache import cache as jcache
from vtpu_manager.compilecache import keys as jkeys
from vtpu_manager.resilience import failpoints
from vtpu_manager.resilience.failpoints import CrashFailpoint
from vtpu_manager_torch.compilecache import cache as tcache
from vtpu_manager_torch.compilecache import keys as tkeys
from vtpu_manager_torch.util import consts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jcache, jkeys, "vtpu_manager"),
        "port": (tcache, tkeys, "vtpu_manager_torch")}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """(cache module, keys module, package name) of one package."""
    return PKGS[request.param]


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

class TestKeys:
    def test_sanitize(self, pkg):
        _, keys, _ = pkg
        assert keys.sanitize_fingerprint("model-v3.2_abc") == \
            "model-v3.2_abc"
        assert keys.sanitize_fingerprint('x"\n/../etc{}') == "x..etc"
        assert keys.sanitize_fingerprint(None) == ""
        assert len(keys.sanitize_fingerprint("a" * 200)) == \
            keys.FINGERPRINT_MAX_LEN

    def test_entry_key_deterministic_and_component_isolated(self, pkg):
        _, keys, _ = pkg
        base = keys.entry_key("fp", "n4:0/0/0/0", "0.4.37", "1.0")
        assert base == keys.entry_key("fp", "n4:0/0/0/0", "0.4.37", "1.0")
        assert keys.entry_key("fp2", "n4:0/0/0/0", "0.4.37", "1.0") != base
        assert keys.entry_key("fp", "n8:0/0/0/0", "0.4.37", "1.0") != base
        assert keys.entry_key("fp", "n4:0/0/0/0", "0.4.38", "1.0") != base
        assert keys.entry_key("fp", "n4:0/0/0/0", "0.4.37", "1.1") != base
        assert keys.entry_key("ab", "c", "d", "e") != \
            keys.entry_key("a", "bc", "d", "e")

    def test_topology_fingerprint(self, pkg):
        _, keys, name = pkg
        vc = __import__(f"{name}.config.vtpu_config", fromlist=["x"])
        devs = [vc.DeviceConfig(uuid="a", total_memory=1, real_memory=1,
                                host_index=1, mesh=(1, 0, 0)),
                vc.DeviceConfig(uuid="b", total_memory=1, real_memory=1,
                                host_index=0, mesh=(0, 0, 0))]
        assert keys.topology_fingerprint(devs) == \
            keys.topology_fingerprint(list(reversed(devs)))
        assert keys.topology_fingerprint(devs).startswith("n2:")

    def test_runtime_versions_env_override(self, pkg, monkeypatch):
        _, keys, name = pkg
        runtime, compiler = (("VTPU_JAX_VERSION", "VTPU_LIBTPU_VERSION")
                             if name == "vtpu_manager" else
                             ("VTPU_TORCH_VERSION", "VTPU_TRITON_VERSION"))
        monkeypatch.setenv(runtime, "9.9.9")
        monkeypatch.setenv(compiler, "8.8.8")
        assert keys.runtime_versions() == ("9.9.9", "8.8.8")


@pytest.mark.parametrize("raw", ["model-v3.2_abc", 'x"\n/../etc{}', None, "",
                                 "a" * 200, "ünïcode-fp"])
def test_sanitized_fingerprints_equal_jax(raw):
    assert tkeys.sanitize_fingerprint(raw) == jkeys.sanitize_fingerprint(raw)


@pytest.mark.parametrize("parts", [
    ("fp", "n4:0/0/0/0", "0.4.37", "1.0"), ("ab", "c", "d", "e"),
    ("", "", "", ""), ("compiled-step-8192", "n1:0/0/0/0@sm_90:NVIDIA H100",
                       "2.11.0+cu128;cuda=12.8", "3.3.0")])
def test_entry_keys_equal_jax(parts):
    assert tkeys.entry_key(*parts) == jkeys.entry_key(*parts)


def test_topology_equals_jax_and_names_the_card():
    from vtpu_manager.config import vtpu_config as jvc
    from vtpu_manager_torch.config import vtpu_config as tvc
    cells = [(3, (1, 0, 0)), (0, (0, 0, 0)), (2, (0, 1, 0))]
    mine = [tvc.DeviceConfig(uuid=f"u{i}", total_memory=1, real_memory=1,
                             host_index=i, mesh=m) for i, m in cells]
    theirs = [jvc.DeviceConfig(uuid=f"u{i}", total_memory=1, real_memory=1,
                               host_index=i, mesh=m) for i, m in cells]
    topo = tkeys.topology_fingerprint(mine)
    assert topo == jkeys.topology_fingerprint(theirs)
    card = tkeys.topology_fingerprint(mine, card="sm_90:NVIDIA H100")
    assert card == f"{topo}@sm_90:NVIDIA H100"


def test_runtime_versions_from_metadata_without_importing(monkeypatch):
    monkeypatch.delenv("VTPU_TORCH_VERSION", raising=False)
    monkeypatch.delenv("VTPU_TRITON_VERSION", raising=False)
    torch_v, triton_v = tkeys.runtime_versions()
    assert torch_v.split(";")[0] == torch.__version__
    assert (";cuda=" in torch_v) == (torch.version.cuda is not None)
    assert triton_v == (tkeys._dist_version("triton")
                        or tkeys._dist_version("pytorch-triton") or "none")
    # a process that never imported torch or triton reads the same
    code = ("import sys\n"
            "from vtpu_manager_torch.compilecache import keys\n"
            "print(keys.runtime_versions())\n"
            "assert 'triton' not in sys.modules and 'torch' not in "
            "sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str((torch_v, triton_v))


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------

class TestStore:
    def test_put_get_roundtrip_and_stats(self, pkg, tmp_path):
        cache, keys, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        key = keys.entry_key("fp", "t", "j", "l")
        assert cc.get(key) is None
        cc.put(key, b"EXECUTABLE" * 100)
        assert cc.get(key) == b"EXECUTABLE" * 100
        assert cc.stats.hits == 1 and cc.stats.misses == 1
        assert json.loads(open(cc._stats_path()).read())["hits"] == 1
        assert os.path.exists(cc._stats_sentinel_path())

    def test_corrupt_entry_quarantined_never_loaded(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        key = "k" * 64
        cc.put(key, b"payload-bytes")
        path = cc.entry_path(key)
        raw = bytearray(open(path, "rb").read())
        raw[cache.ENTRY_HEADER_SIZE + 3] ^= 0xFF
        with open(path, "wb") as f:
            f.write(raw)
        assert cc.get(key) is None
        assert not os.path.exists(path)
        assert len(os.listdir(cc.quarantine_dir)) == 1
        assert cc.stats.quarantined == 1

    def test_truncated_entry_quarantined(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        key = "t" * 64
        cc.put(key, b"x" * 4096)
        with open(cc.entry_path(key), "r+b") as f:
            f.truncate(cache.ENTRY_HEADER_SIZE + 100)
        assert cc.get(key) is None
        assert len(os.listdir(cc.quarantine_dir)) == 1

    def test_lru_eviction_under_tight_budget(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        for i in range(4):
            cc.put(f"key-{i}" + "0" * 58, b"z" * 100)
            os.utime(cc.entry_path(f"key-{i}" + "0" * 58),
                     (1000.0 + i, 1000.0 + i))
        os.utime(cc.entry_path("key-0" + "0" * 58), (2000.0, 2000.0))
        entry_size = 100 + cache.ENTRY_HEADER_SIZE
        evicted = cc.evict(budget_bytes=2 * entry_size)
        assert evicted == 2 and cc.stats.evictions == 2
        left = set(os.listdir(cc.entries_dir))
        assert "key-0" + "0" * 58 in left and "key-3" + "0" * 58 in left

    def test_evict_reaps_stale_tmp(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"), stale_lease_s=0.5)
        stale = os.path.join(cc.tmp_dir, "dead.123")
        with open(stale, "w") as f:
            f.write("torn")
        os.utime(stale, (1.0, 1.0))
        cc.evict(budget_bytes=1 << 30)
        assert not os.path.exists(stale)

    def test_evict_reaps_old_quarantine(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        old = os.path.join(cc.quarantine_dir, "k.1")
        young = os.path.join(cc.quarantine_dir, "k.2")
        for path in (old, young):
            with open(path, "w") as f:
                f.write("corpse")
        now = time.time()
        os.utime(old, (now - cache.QUARANTINE_RETENTION_S - 10,) * 2)
        cc.evict(budget_bytes=1 << 30, now=now)
        assert os.listdir(cc.quarantine_dir) == ["k.2"]

    def test_node_totals_and_render(self, pkg, tmp_path):
        cache, _, _ = pkg
        root = str(tmp_path / "cc")
        cc = cache.CompileCache(root)
        cc.put("e" * 64, b"data")
        cc.get("e" * 64)
        cc.get("missing" + "0" * 57)
        dead_path = os.path.join(cc.stats_dir, "999999-beef.json")
        with open(dead_path, "w") as f:
            json.dump({"hits": 5, "misses": 2, "single_flight_waits": 1,
                       "evictions": 0, "quarantined": 0}, f)
        os.utime(dead_path, (1.0, 1.0))
        totals, count, size = cache.node_totals(root)
        assert totals["hits"] == 6 and totals["misses"] == 3
        assert count == 1 and size > len(b"data")
        text = cache.render_node_metrics(root, "node-1")
        assert 'vtpu_compile_cache_hits_total{node="node-1"} 6' in text
        assert 'vtpu_compile_cache_entries{node="node-1"} 1' in text
        cc._fold_dead_stats()
        assert not os.path.exists(dead_path)
        totals2, _, _ = cache.node_totals(root)
        assert totals2["hits"] == 6

    def test_absent_root_renders_headers_only(self, pkg, tmp_path):
        cache, _, _ = pkg
        text = cache.render_node_metrics(str(tmp_path / "nope"), "n")
        assert "# TYPE vtpu_compile_cache_hits_total counter" in text
        assert 'node="n"' not in text


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_stores_read_each_others_entries(tmp_path, writer, reader):
    root = str(tmp_path / "cc")
    payload = bytes(range(256)) * 40 + b"tail"
    key = jkeys.entry_key("fp", "n1:0/0/0/0", "a", "b")
    PKGS[writer][0].CompileCache(root).put(key, payload)
    assert PKGS[reader][0].CompileCache(root).get(key) == payload
    # and the bytes on disk are one format
    other = str(tmp_path / "other")
    PKGS[reader][0].CompileCache(other).put(key, payload)
    with open(os.path.join(root, "entries", key), "rb") as f:
        mine = f.read()
    with open(os.path.join(other, "entries", key), "rb") as f:
        assert f.read() == mine


def test_renders_equal_jax_over_one_root(tmp_path):
    root = str(tmp_path / "cc")
    tc = tcache.CompileCache(root)
    jc = jcache.CompileCache(root)
    tc.put("a" * 64, b"x" * 10)
    jc.get("a" * 64)
    tc.get("b" * 64)
    assert tcache.render_node_metrics(root, "n1") == \
        jcache.render_node_metrics(root, "n1")
    assert tcache.node_totals(root) == jcache.node_totals(root)


# ---------------------------------------------------------------------------
# one compile per key
# ---------------------------------------------------------------------------

class TestSingleFlight:
    def test_lease_excludes_live_holder(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        assert cc.try_acquire_lease("k1")
        assert not cc.try_acquire_lease("k1")
        cc.release_lease("k1")
        assert cc.try_acquire_lease("k1")

    def test_stale_age_takeover(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"), stale_lease_s=0.2)
        with open(cc._lease_path("k"), "w") as f:
            f.write(f"{os.getpid()}@{time.time() - 10}")
        assert cc.try_acquire_lease("k")

    def test_dead_pid_takeover(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        with open(cc._lease_path("k"), "w") as f:
            f.write(f"4000000@{time.time()}")
        assert cc.try_acquire_lease("k")

    def test_garbage_lease_is_takeover_able(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        with open(cc._lease_path("k"), "w") as f:
            f.write("not-a-lease")
        assert cc.try_acquire_lease("k")

    def test_release_only_own_lease(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        with open(cc._lease_path("k"), "w") as f:
            f.write(f"4000000@{time.time()}")
        cc.release_lease("k")
        assert os.path.exists(cc._lease_path("k"))

    def test_get_or_compile_miss_then_hit(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        calls = []
        payload, outcome = cc.get_or_compile(
            "k" * 64, lambda: calls.append(1) or b"exe")
        assert (payload, outcome) == (b"exe", "miss")
        payload, outcome = cc.get_or_compile(
            "k" * 64, lambda: calls.append(1) or b"exe")
        assert (payload, outcome) == (b"exe", "hit")
        assert len(calls) == 1
        assert not os.listdir(cc.lease_dir)

    def test_wedged_holder_fails_open_at_deadline(self, pkg, tmp_path):
        import fcntl
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"), stale_lease_s=60.0)
        with open(cc._lease_path("k"), "w") as f:
            f.write(f"999999@{time.time()}")
            f.flush()
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            payload, outcome = cc.get_or_compile("k", lambda: b"local",
                                                 timeout_s=0.3)
        assert (payload, outcome) == (b"local", "timeout")
        assert cc.get("k") is None

    def test_unflocked_fresh_lease_is_dead(self, pkg, tmp_path):
        cache, _, _ = pkg
        cc = cache.CompileCache(str(tmp_path / "cc"))
        with open(cc._lease_path("k"), "w") as f:
            f.write(f"{os.getpid()}@{time.time()}")
        assert cc.try_acquire_lease("k")


@pytest.mark.parametrize("holder,waiter", [("jax", "port"), ("port", "jax")])
def test_leases_hold_across_the_packages(tmp_path, holder, waiter):
    root = str(tmp_path / "cc")
    a = PKGS[holder][0].CompileCache(root)
    b = PKGS[waiter][0].CompileCache(root)
    assert a.try_acquire_lease("k")
    assert not b.try_acquire_lease("k")
    a.release_lease("k")
    assert b.try_acquire_lease("k")


TORTURE_WORKER = """
import importlib, os, sys, time
cache = importlib.import_module(sys.argv[1] + ".compilecache.cache")
root, key, marker_dir = sys.argv[2:5]
payload = (b"EXEC" * 1000) + b"tail"
cc = cache.CompileCache(root)
def compile_fn():
    open(os.path.join(marker_dir, str(os.getpid())), "w").close()
    time.sleep(0.4)
    return payload
data, outcome = cc.get_or_compile(key, compile_fn, timeout_s=30)
assert data == payload, "TORN READ"
print(outcome)
"""


@pytest.mark.parametrize("mix", ["jax", "port", "both"])
def test_multiprocess_torture_one_compile_zero_torn(tmp_path, mix):
    """Six processes race one key (three of each package in `both`):
    exactly one compiles, every one reads the exact payload back, and the
    late arrivals count single-flight waits."""
    root = str(tmp_path / "cc")
    key = jkeys.entry_key("gang-prog", "n4", "j", "l")
    marker_dir = tmp_path / "compiles"
    marker_dir.mkdir()
    names = {"jax": ["vtpu_manager"] * 6,
             "port": ["vtpu_manager_torch"] * 6,
             "both": ["vtpu_manager", "vtpu_manager_torch"] * 3}[mix]
    procs = [subprocess.Popen(
        [sys.executable, "-c", TORTURE_WORKER, name, root, key,
         str(marker_dir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(), cwd=REPO) for name in names]
    outcomes = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, out + err
        outcomes.append(out.strip())
    assert len(os.listdir(marker_dir)) == 1, outcomes
    assert outcomes.count("miss") == 1
    assert all(o in ("miss", "wait", "hit") for o in outcomes)
    totals, count, _ = tcache.node_totals(root)
    assert count == 1
    assert totals["single_flight_waits"] >= 1
    assert totals == jcache.node_totals(root)[0]


# ---------------------------------------------------------------------------
# crashes
# ---------------------------------------------------------------------------

class _Crash(BaseException):
    """A process death at a point of the port's choosing (the JAX store's
    CrashFailpoint)."""


@pytest.fixture
def armed_failpoints():
    failpoints.enable(seed=7)
    yield
    failpoints.disable()


def _crash_before_rename(pkg_name, cc, monkeypatch):
    """The write is torn and the writer dies before its rename."""
    if pkg_name == "vtpu_manager":
        failpoints.arm("cache.write", "partial-write", count=1)
        return CrashFailpoint
    real_fsync = os.fsync

    def torn(fd):
        os.ftruncate(fd, 30)
        real_fsync(fd)
        raise _Crash()
    monkeypatch.setattr(tcache.os, "fsync", torn)
    return _Crash


def test_torn_write_mid_rename_never_served(pkg, tmp_path, armed_failpoints,
                                           monkeypatch):
    cache, _, name = pkg
    cc = cache.CompileCache(str(tmp_path / "cc"))
    crash = _crash_before_rename(name, cc, monkeypatch)
    with pytest.raises(crash):
        cc.get_or_compile("k" * 64, lambda: b"X" * 2048)
    monkeypatch.undo()
    assert os.listdir(cc.entries_dir) == []
    assert cc.get("k" * 64) is None
    cc2 = cache.CompileCache(str(tmp_path / "cc"), stale_lease_s=0.0)
    payload, outcome = cc2.get_or_compile("k" * 64, lambda: b"fresh")
    assert (payload, outcome) == (b"fresh", "miss")
    cc2.evict(budget_bytes=1 << 30, now=time.time() + 10)
    assert os.listdir(cc2.tmp_dir) == []


CRASHER = {
    "vtpu_manager": """
import os, sys
from vtpu_manager.resilience import failpoints
from vtpu_manager.compilecache.cache import CompileCache
failpoints.enable(seed=1)
failpoints.arm('cache.lease', 'crash', count=1)
cc = CompileCache(sys.argv[1])
try:
    cc.get_or_compile('K', lambda: b'never')
except BaseException:
    os._exit(0)
os._exit(3)
""",
    "vtpu_manager_torch": """
import os, sys
from vtpu_manager_torch.compilecache.cache import CompileCache
cc = CompileCache(sys.argv[1])
def compile_fn():
    os._exit(0)      # dies holding the lease: no release runs
cc.get_or_compile('K', compile_fn)
os._exit(3)
"""}


@pytest.mark.parametrize("crasher", sorted(CRASHER))
def test_crash_holding_lease_taken_over_within_budget(pkg, tmp_path,
                                                      crasher):
    cache, _, _ = pkg
    root = str(tmp_path / "cc")
    stale_s = 1.0
    res = subprocess.run([sys.executable, "-c", CRASHER[crasher], root],
                         env=_env(), cwd=REPO, timeout=60)
    assert res.returncode == 0
    cc = cache.CompileCache(root, stale_lease_s=stale_s)
    assert os.listdir(cc.lease_dir)
    t0 = time.monotonic()
    payload, outcome = cc.get_or_compile("K", lambda: b"recovered",
                                         timeout_s=30)
    assert (payload, outcome) == (b"recovered", "miss")
    assert time.monotonic() - t0 < stale_s + 5.0


def test_forced_torn_entry_on_disk_is_quarantined(pkg, tmp_path):
    cache, _, _ = pkg
    cc = cache.CompileCache(str(tmp_path / "cc"))
    with open(cc.entry_path("bad"), "wb") as f:
        f.write(b"\x01\x02garbage-that-is-not-an-entry")
    assert cc.get("bad") is None
    assert os.listdir(cc.entries_dir) == []
    assert len(os.listdir(cc.quarantine_dir)) == 1


# ---------------------------------------------------------------------------
# Allocate: the gate contract, against the JAX plugin
# ---------------------------------------------------------------------------

GIB = 2**30


def _allocate_both(tmp_path, gate_on: bool):
    """The same committed pod allocated by the port's plugin and the JAX
    plugin, over the same chips: (port response, port plugin, JAX
    response, JAX plugin)."""
    from test_torch_deviceplugin import (alloc, committed_pod, jax_plugin,
                                         make_manager, node_dirs)

    from vtpu_manager.deviceplugin.api import deviceplugin_pb2 as jpb
    from vtpu_manager_torch.client.fake import FakeKubeClient
    from vtpu_manager_torch.config.node_config import NodeConfig
    from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin, device_id
    client = FakeKubeClient()
    mgr = make_manager(client)
    plugin = VnumPlugin(mgr, client, "node-1", node_config=NodeConfig(),
                        **node_dirs(tmp_path / "port"))
    plugin.compile_cache_enabled = gate_on
    jp, jclient = jax_plugin(mgr, tmp_path / "jax")
    jp.compile_cache_enabled = gate_on
    pod = committed_pod(mgr, cores=50, memory=2 * GIB)
    client.add_pod(copy.deepcopy(pod))
    jclient.add_pod(copy.deepcopy(pod))
    ids = [device_id(mgr.chips[0].uuid, 0)]
    mine = alloc(plugin, *ids)
    theirs = jp.allocate(jpb.AllocateRequest(container_requests=[
        jpb.ContainerAllocateRequest(devicesIDs=ids)])).container_responses[0]
    return mine, plugin, theirs, jp


def _config_bytes(base_dir):
    with open(os.path.join(base_dir, "uid-p1_main", "config",
                           "vtpu.config"), "rb") as f:
        return f.read()


class TestPluginGate:
    def test_gate_on_mounts_and_arms(self, tmp_path):
        from vtpu_manager_torch.config import vtpu_config as vc
        cresp, plugin, _, _ = _allocate_both(tmp_path, True)
        assert cresp.envs[consts.ENV_COMPILE_CACHE] == "true"
        assert cresp.envs[consts.ENV_COMPILE_CACHE_DIR] == \
            consts.COMPILE_CACHE_DIR
        mounts = {m.container_path: m for m in cresp.mounts}
        m = mounts[consts.COMPILE_CACHE_DIR]
        assert not m.read_only
        assert m.host_path == os.path.join(plugin.base_dir,
                                           consts.COMPILE_CACHE_SUBDIR)
        assert os.path.isdir(m.host_path)
        cfg = vc.read_config(os.path.join(
            plugin.base_dir, "uid-p1_main", "config", "vtpu.config"))
        assert cfg.compile_cache_dir == consts.COMPILE_CACHE_DIR

    def test_gate_off_no_mount_no_env_no_dir(self, tmp_path):
        from vtpu_manager_torch.config import vtpu_config as vc
        cresp, plugin, _, _ = _allocate_both(tmp_path, False)
        assert consts.ENV_COMPILE_CACHE not in cresp.envs
        assert consts.ENV_COMPILE_CACHE_DIR not in cresp.envs
        assert consts.COMPILE_CACHE_DIR not in \
            {m.container_path for m in cresp.mounts}
        assert not os.path.exists(os.path.join(
            plugin.base_dir, consts.COMPILE_CACHE_SUBDIR))
        cfg = vc.read_config(os.path.join(
            plugin.base_dir, "uid-p1_main", "config", "vtpu.config"))
        assert cfg.compile_cache_dir == ""

    def test_unmakeable_dir_arms_nothing(self, tmp_path):
        """The dir first: when it cannot be made, neither the config nor
        the mount nor the env arms the tenant (JAX `vnum.py:436-449`)."""
        from vtpu_manager_torch.config import vtpu_config as vc
        (tmp_path / "port" / "mgr").mkdir(parents=True)
        (tmp_path / "port" / "mgr" / consts.COMPILE_CACHE_SUBDIR).write_text(
            "a file where the dir would go")
        cresp, plugin, _, _ = _allocate_both(tmp_path, True)
        assert consts.ENV_COMPILE_CACHE not in cresp.envs
        assert consts.COMPILE_CACHE_DIR not in \
            {m.container_path for m in cresp.mounts}
        cfg = vc.read_config(os.path.join(
            plugin.base_dir, "uid-p1_main", "config", "vtpu.config"))
        assert cfg.compile_cache_dir == ""


@pytest.mark.parametrize("gate_on", [True, False])
def test_allocate_is_the_jax_plugins_byte_for_byte(tmp_path, gate_on):
    """The config file byte for byte; the compile cache's env and mount
    the JAX plugin's (its other names differ only by the CUDA names, as
    test_torch_deviceplugin holds them)."""
    mine, plugin, theirs, jp = _allocate_both(tmp_path, gate_on)
    assert _config_bytes(plugin.base_dir) == _config_bytes(jp.base_dir)
    names = (consts.ENV_COMPILE_CACHE, consts.ENV_COMPILE_CACHE_DIR,
             consts.ENV_CLUSTER_CACHE)
    assert {k: mine.envs.get(k) for k in names} == \
        {k: dict(theirs.envs).get(k) for k in names}

    def cache_mounts(resp, base):
        return [(m.container_path, os.path.relpath(m.host_path, base),
                 m.read_only) for m in resp.mounts
                if m.container_path == consts.COMPILE_CACHE_DIR]
    assert cache_mounts(mine, plugin.base_dir) == \
        cache_mounts(theirs, jp.base_dir)
    assert {m.container_path for m in mine.mounts} == \
        {m.container_path for m in theirs.mounts} | {consts.LD_SO_PRELOAD}


# ---------------------------------------------------------------------------
# the device plugin's command
# ---------------------------------------------------------------------------

def test_feature_gate_default_is_jax():
    from vtpu_manager.util import featuregates as jfg
    from vtpu_manager_torch.util import featuregates as tfg
    assert tfg.COMPILE_CACHE == jfg.COMPILE_CACHE
    assert tfg.FeatureGates().enabled(tfg.COMPILE_CACHE) == \
        jfg.FeatureGates().enabled(jfg.COMPILE_CACHE)
    assert tfg.CLUSTER_COMPILE_CACHE == jfg.CLUSTER_COMPILE_CACHE
    assert tfg.FeatureGates().enabled(tfg.CLUSTER_COMPILE_CACHE) == \
        jfg.FeatureGates().enabled(jfg.CLUSTER_COMPILE_CACHE)


def test_flags_are_the_jax_flags():
    from vtpu_manager_torch.cmd import device_plugin as dp
    args = dp.parse_args(["--node-name", "n1", "--compile-cache-budget-mb",
                          "64", "--compile-cache-evict-interval", "0.5"])
    assert (args.compile_cache_budget_mb,
            args.compile_cache_evict_interval) == (64, 0.5)
    defaults = dp.parse_args(["--node-name", "n1"])
    assert (defaults.compile_cache_budget_mb,
            defaults.compile_cache_evict_interval) == (4096, 60.0)
    # the cluster tier's flags (JAX `cmd/device_plugin.py:70-84`)
    args = dp.parse_args(["--node-name", "n1", "--cache-advertise-endpoint",
                          "10.0.0.7:9394", "--cache-ad-max-pairs", "12"])
    assert (args.cache_advertise_endpoint, args.cache_ad_max_pairs) == \
        ("10.0.0.7:9394", 12)
    assert (defaults.cache_advertise_endpoint,
            defaults.cache_ad_max_pairs) == (None, None)


def test_evictor_runs_to_the_budget(tmp_path):
    import threading

    from vtpu_manager_torch.cmd import device_plugin as dp
    root = str(tmp_path / "cc")
    cc = tcache.CompileCache(root)
    for i in range(3):
        cc.put(f"{i}" * 64, b"z" * 1000)
    stop = threading.Event()
    try:
        assert dp.start_cache_evictor(root, 1100, 0.05, stop)
        deadline = time.monotonic() + 10
        while len(os.listdir(cc.entries_dir)) > 1 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        stop.set()
    assert len(os.listdir(cc.entries_dir)) == 1


# ---------------------------------------------------------------------------
# the runtime client
# ---------------------------------------------------------------------------

class TestRuntimeClientGate:
    def test_gate_off_zero_cache_io(self, tmp_path, monkeypatch):
        from vtpu_manager_torch.runtime import client as rt
        monkeypatch.delenv(consts.ENV_COMPILE_CACHE, raising=False)
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE_DIR, str(tmp_path))
        rt._reset_compile_cache()
        try:
            assert rt.compile_cache() is None
            monkeypatch.setenv(consts.ENV_COMPILE_CACHE, "true")
            assert rt.compile_cache() is None
            assert not os.listdir(tmp_path)
        finally:
            rt._reset_compile_cache()

    def test_gate_on_arms_and_caches(self, tmp_path, monkeypatch):
        from vtpu_manager_torch.runtime import client as rt
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE, "true")
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE_DIR,
                           str(tmp_path / "cc"))
        rt._reset_compile_cache()
        try:
            cc = rt.compile_cache()
            assert cc is not None and rt.compile_cache() is cc
            payload, outcome = cc.get_or_compile("k", lambda: b"exe")
            assert (payload, outcome) == (b"exe", "miss")
            assert cc.get_or_compile("k", lambda: b"exe")[1] == "hit"
        finally:
            rt._reset_compile_cache()

    def test_cluster_tier_is_served_by_the_node_tier(self, tmp_path,
                                                     monkeypatch, caplog):
        """The cluster tier is the node store with the peer fetch on its
        miss path (JAX `runtime/client.py:407-420`)."""
        from vtpu_manager_torch.clustercache import ClusterCompileCache
        from vtpu_manager_torch.compilecache import CompileCache
        from vtpu_manager_torch.runtime import client as rt
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE, "true")
        monkeypatch.setenv(consts.ENV_CLUSTER_CACHE, "true")
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE_DIR,
                           str(tmp_path / "cc"))
        rt._reset_compile_cache()
        try:
            cc = rt.compile_cache()
            assert type(cc) is ClusterCompileCache
            assert isinstance(cc, CompileCache)
            assert cc.root == str(tmp_path / "cc")
            assert "not ported" not in caplog.text
        finally:
            rt._reset_compile_cache()

    def test_install_arms_inductor_and_triton_dirs(self, tmp_path,
                                                   monkeypatch):
        from vtpu_manager_torch.runtime import client as rt
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE, "true")
        monkeypatch.setenv(consts.ENV_COMPILE_CACHE_DIR,
                           str(tmp_path / "cc"))
        monkeypatch.delenv(consts.ENV_INDUCTOR_CACHE_DIR, raising=False)
        monkeypatch.delenv(consts.ENV_TRITON_CACHE_DIR, raising=False)
        monkeypatch.setenv(consts.ENV_SHIM_PATH, str(tmp_path / "no-shim"))
        assert rt.install() is None       # no interposer here...
        # ...and the cache armed all the same
        assert os.environ[consts.ENV_INDUCTOR_CACHE_DIR] == \
            str(tmp_path / "cc" / "inductor")
        assert os.environ[consts.ENV_TRITON_CACHE_DIR] == \
            str(tmp_path / "cc" / "triton")
        monkeypatch.setenv(consts.ENV_INDUCTOR_CACHE_DIR, "/custom")
        rt.install()
        assert os.environ[consts.ENV_INDUCTOR_CACHE_DIR] == "/custom"

    def test_gate_off_dirs_untouched(self, tmp_path, monkeypatch):
        from vtpu_manager_torch.runtime import client as rt
        monkeypatch.delenv(consts.ENV_COMPILE_CACHE, raising=False)
        monkeypatch.delenv(consts.ENV_INDUCTOR_CACHE_DIR, raising=False)
        monkeypatch.delenv(consts.ENV_TRITON_CACHE_DIR, raising=False)
        monkeypatch.setenv(consts.ENV_SHIM_PATH, str(tmp_path / "no-shim"))
        rt.install()
        assert consts.ENV_INDUCTOR_CACHE_DIR not in os.environ
        assert consts.ENV_TRITON_CACHE_DIR not in os.environ


def test_jax_and_port_arm_the_same_mount(tmp_path, monkeypatch):
    """Both clients default their compilers' caches under the one mount."""
    from vtpu_manager.runtime import client as jrt
    from vtpu_manager_torch.runtime import client as rt
    monkeypatch.setenv(consts.ENV_COMPILE_CACHE, "true")
    monkeypatch.setenv(consts.ENV_COMPILE_CACHE_DIR, str(tmp_path / "cc"))
    for var in ("JAX_COMPILATION_CACHE_DIR", consts.ENV_INDUCTOR_CACHE_DIR,
                consts.ENV_TRITON_CACHE_DIR):
        monkeypatch.delenv(var, raising=False)
    jrt._arm_jax_compile_cache()
    rt._arm_torch_compile_cache()
    dirs = [os.environ[v] for v in ("JAX_COMPILATION_CACHE_DIR",
                                    consts.ENV_INDUCTOR_CACHE_DIR,
                                    consts.ENV_TRITON_CACHE_DIR)]
    assert {os.path.dirname(d) for d in dirs} == {str(tmp_path / "cc")}


# ---------------------------------------------------------------------------
# the kernel's operator in a compiled graph
# ---------------------------------------------------------------------------

def _attn_inputs(seed=0, b=2, h=2, s=16, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    rows = np.arange(s)[:, None]
    bias = np.where(rows >= np.arange(s)[None, :], 0.0,
                    -np.inf).astype(np.float32)
    return q, k, v, bias


def test_custom_op_compiles_whole_and_matches_pallas():
    import jax.numpy as jnp

    from vtpu_manager.workloads import pallas_attention as jpa
    from vtpu_manager_torch.workloads import block_attention as ba
    q, k, v, bias = _attn_inputs()
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]

    def fn(q, k, v, bias):
        o, m, l = ba.attn_block_op(q, k, v, bias)
        return ba.combine_blocks([(o, m, l)])

    torch._dynamo.reset()
    explained = torch._dynamo.explain(fn)(*args)
    assert explained.graph_break_count == 0
    assert explained.graph_count == 1
    compiled = torch.compile(fn, backend="aot_eager")(*args)
    eager = fn(*args)
    jo, jm, jl = jpa.attention_block(*map(jnp.asarray, (q, k, v, bias)),
                                     interpret=True)
    want = np.asarray(jpa.combine_blocks([(jo, jm, jl)]))
    np.testing.assert_allclose(compiled.numpy(), eager.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(compiled.numpy(), want, atol=2e-5, rtol=2e-5)
    torch._dynamo.reset()


def test_custom_op_fake_checks_shapes():
    from vtpu_manager_torch.workloads import block_attention as ba
    q, k, v, bias = (torch.from_numpy(a) for a in _attn_inputs())
    # the fake raises the wrapper's own error while Dynamo traces
    with pytest.raises(Exception, match=r"is not \[Sq, Sk\]"):
        torch.compile(lambda *a: ba.attn_block_op(*a), backend="aot_eager")(
            q, k, v, bias[:, :3])


# ---------------------------------------------------------------------------
# the compiled step through the store, on the CPU
# ---------------------------------------------------------------------------

STEP_WORKER = """
import json, os, sys, time
import torch
from vtpu_manager_torch.compilecache import CompileCache
from vtpu_manager_torch.workloads import compiled_step as cs
inputs = cs.make_inputs(dim=32, attn_shape=(1, 2, 16, 8), device="cpu")
cache = CompileCache(sys.argv[1])
key = cs.entry_key(inputs)
(y, a), outcome, seconds = cs.first_step(inputs, cache, key)
torch.save([y.float(), a], sys.argv[2])
print(json.dumps({"outcome": outcome, "seconds": seconds,
                  "key": key, **cs.compile_counters()}))
"""


def test_compiled_step_through_the_store_miss_then_hit(tmp_path):
    """One Inductor compile: the first process compiles and stores
    `save_cache_artifacts()`; the second, with empty Inductor and Triton
    directories of its own, loads the entry and hits Inductor's cache."""
    root = str(tmp_path / "cc")
    rows = []
    for i in range(2):
        env = _env()
        env.update({consts.ENV_INDUCTOR_CACHE_DIR: str(tmp_path / f"i{i}"),
                    consts.ENV_TRITON_CACHE_DIR: str(tmp_path / f"t{i}"),
                    "TORCHINDUCTOR_COMPILE_THREADS": "1",
                    "OMP_NUM_THREADS": "1"})
        res = subprocess.run(
            [sys.executable, "-c", STEP_WORKER, root,
             str(tmp_path / f"out{i}.pt")], env=env, cwd=REPO,
            capture_output=True, text=True, timeout=240)
        assert res.returncode == 0, res.stderr[-3000:]
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
    miss, hit = rows
    assert miss["outcome"] == "miss" and miss["fxgraph_cache_miss"] >= 1
    assert hit["outcome"] == "hit" and hit["fxgraph_cache_miss"] == 0
    assert hit["fxgraph_cache_hit"] >= 1
    assert miss["key"] == hit["key"]
    totals, count, _ = tcache.node_totals(root)
    assert (totals["hits"], totals["misses"], count) == (1, 1, 1)
    (y0, a0), (y1, a1) = (torch.load(tmp_path / f"out{i}.pt")
                          for i in range(2))
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


def test_compiled_step_matches_eager_and_jax_block():
    """The step's arithmetic: its graph (compiled with aot_eager here; the
    store case above runs Inductor) equals the eager step, and its
    attention is the JAX block's, normalised."""
    import jax.numpy as jnp

    from vtpu_manager.workloads import pallas_attention as jpa
    from vtpu_manager_torch.workloads import compiled_step as cs
    inputs = cs.make_inputs(dim=32, attn_shape=(1, 2, 16, 8), device="cpu")
    torch._dynamo.reset()
    y, a = torch.compile(cs.step, backend="aot_eager")(*inputs)
    ey, ea = cs.step(*inputs)
    assert torch.equal(y, ey)
    np.testing.assert_allclose(a.numpy(), ea.numpy(), atol=2e-5, rtol=2e-5)
    q, k, v, bias = (t.numpy() for t in inputs[1:])
    jo, jm, jl = jpa.attention_block(*map(jnp.asarray, (q, k, v, bias)),
                                     interpret=True)
    want = np.asarray(jpa.combine_blocks([(jo, jm, jl)]))
    np.testing.assert_allclose(a.numpy(), want, atol=2e-5, rtol=2e-5)
    torch._dynamo.reset()


def test_program_fingerprint_and_key():
    from vtpu_manager_torch.workloads import compiled_step as cs
    small = cs.make_inputs(dim=32, attn_shape=(1, 2, 16, 8), device="cpu")
    other = cs.make_inputs(dim=64, attn_shape=(1, 2, 16, 8), device="cpu")
    fp = cs.program_fingerprint(small)
    assert fp == tkeys.sanitize_fingerprint(fp)
    assert fp.startswith("compiled-step-32-")
    assert fp == cs.program_fingerprint(cs.make_inputs(
        dim=32, attn_shape=(1, 2, 16, 8), device="cpu", seed=5))
    assert cs.entry_key(small) != cs.entry_key(other)
    assert cs.entry_key(small) == tkeys.entry_key(
        fp, "n0:", *tkeys.runtime_versions())
