"""HBMOvercommit in the port against the JAX package.

The node half held to the JAX package on the same inputs: the overcommit
annotation's codec (`overcommit/ratio.py`), the policy over one node's
rings, configs and feed (`overcommit/policy.py` over the port's
utilization ledger, `utilization/ledger.py`, against the JAX policy over
its own), the host pool (`overcommit/spill.py`: `tests/test_overcommit.py`'s
TestSpillPool cases through both packages, then both pools on one
directory and one ledger), Allocate's config bytes and environment, the
exporter's spill series, and a pod past the node's physical memory that
the JAX scheduler admits against the port's annotation. Then the
interposer's overflow tier on the fake driver, verdict by verdict.
"""

from __future__ import annotations

import copy
import os
import signal
import subprocess
import time
from types import SimpleNamespace

import pytest

from test_torch_deviceplugin import (alloc, committed_pod, config_of,
                                     jax_plugin, make_manager, node_dirs)
from test_torch_metrics import masked, render_both
from vtpu_manager.config import vmem as jvmem
from vtpu_manager.device.types import fake_chip
from vtpu_manager.deviceplugin.api import deviceplugin_pb2 as jpb
from vtpu_manager.overcommit import policy as jpolicy
from vtpu_manager.overcommit import ratio as jratio
from vtpu_manager.overcommit import spill as jspill
from vtpu_manager.resilience import failpoints as jfp
from vtpu_manager.resilience.failpoints import \
    CrashFailpoint as JCrashFailpoint
from vtpu_manager.util import consts as jc
from vtpu_manager.utilization.ledger import UtilizationLedger
from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.config import tc_watcher, vmem
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin, device_id
from vtpu_manager_torch.overcommit import policy as tpolicy
from vtpu_manager_torch.overcommit import ratio as tratio
from vtpu_manager_torch.overcommit import spill as tspill
from vtpu_manager_torch.resilience import failpoints as tfp
from vtpu_manager_torch.resilience.failpoints import CrashFailpoint
from vtpu_manager_torch.telemetry import stepring
from vtpu_manager_torch.utilization import ledger as tledger
from vtpu_manager_torch.util import consts

GIB = 2**30
MIB = 2**20
NOW = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _clean_failpoints():
    jfp.disable()
    tfp.disable()
    yield
    jfp.disable()
    tfp.disable()


# --- the codec ---------------------------------------------------------------

ROLLUPS = [
    {"ratios": {"lat": 1.0, "thr": 1.5, "def": 2.25}, "spill_frac": 0.125,
     "spilled_bytes": 3 * GIB, "ts": NOW},
    {"ratios": {"def": 3.999}, "spill_frac": 0.0, "spilled_bytes": 0,
     "ts": NOW + 0.0004},
    {"ratios": {}, "spill_frac": 1.0, "spilled_bytes": 1, "ts": 12.5},
    {"ratios": {"thr": 1.005, "lat": 1.015}, "spill_frac": 0.33333,
     "spilled_bytes": 7, "ts": NOW - 0.0005},
]


@pytest.mark.parametrize("rollup", ROLLUPS)
def test_encode_is_the_jax_bytes(rollup):
    mine = tratio.NodeOvercommit(**rollup)
    theirs = jratio.NodeOvercommit(**rollup)
    assert mine.encode() == theirs.encode()


RAW = [
    None, "", "garbage", "@", "|@1", f"def:1.5|0.1:5@{NOW}",
    f"lat:1.20;thr:2.00;def:1.35|0.2500:1024@{NOW}",
    f"def:9.0|0.5:1@{NOW}", f"def:0.5|2.0:-7@{NOW}",
    f"def:nan|0.1:1@{NOW}", f"def:1.5|nan:1@{NOW}", f"def:1.5|inf:1@{NOW}",
    f"def:x|0.1:1@{NOW}", f"def:1.5|0.1:x@{NOW}", f"def:1.5|0.1@{NOW}",
    f"def:1.5@{NOW}", f"def:1.5|0.1:1@{NOW - 121}",
    f"def:1.5|0.1:1@{NOW - 119}", f"def:1.5|0.1:1@{NOW + 4}",
    f"def:1.5|0.1:1@{NOW + 6}", f"def:1.5|0.1:1@nan", "def:1.5|0.1:1@inf",
    f";;def:2|0:0@{NOW}", f"lat:1.1|a|0.1:1@{NOW}",
    f"a@b|def:2|0:0@{NOW}",
]


@pytest.mark.parametrize("raw", RAW)
def test_parse_gives_the_jax_verdict(raw):
    mine = tratio.parse_overcommit(raw, now=NOW)
    theirs = jratio.parse_overcommit(raw, now=NOW)
    if theirs is None:
        assert mine is None
        return
    assert (mine.ratios, mine.spill_frac, mine.spilled_bytes, mine.ts) == \
        (theirs.ratios, theirs.spill_frac, theirs.spilled_bytes, theirs.ts)


@pytest.mark.parametrize("age", [0.0, 60.0, 119.0, 121.0, -4.0, -6.0])
@pytest.mark.parametrize("cls", ["", consts.WORKLOAD_CLASS_LATENCY_CRITICAL,
                                 consts.WORKLOAD_CLASS_THROUGHPUT,
                                 "best-effort"])
@pytest.mark.parametrize("ratios", [{"lat": 1.2, "thr": 2.5, "def": 1.75},
                                    {"def": 3.0}, {"thr": 0.5}, {}])
def test_ratio_for_class_and_spill_penalty_as_jax(age, cls, ratios):
    raw = {"ratios": ratios, "spill_frac": 0.4, "spilled_bytes": 9,
           "ts": NOW}
    mine, theirs = tratio.NodeOvercommit(**raw), jratio.NodeOvercommit(**raw)
    now = NOW + age
    assert tratio.ratio_for_class(mine, cls, now) == \
        jratio.ratio_for_class(theirs, cls, now)
    assert tratio.spill_penalty(mine, now) == \
        jratio.spill_penalty(theirs, now)
    assert tratio.ratio_for_class(None, cls, now) == 1.0


def test_constants_are_the_jax_packages():
    assert (tratio.MAX_RATIO, tratio.MAX_OVERCOMMIT_AGE_S,
            tratio.SPILL_SCORE_WEIGHT, tratio.CLASS_KEYS) == \
        (jratio.MAX_RATIO, jratio.MAX_OVERCOMMIT_AGE_S,
         jratio.SPILL_SCORE_WEIGHT, jratio.CLASS_KEYS)
    assert (tpolicy.HIGHWATER_PERCENTILE, tpolicy.SAFETY_FACTOR,
            tpolicy.MIN_ENVELOPE_FRACTION, tpolicy.MIN_CLASS_TENANTS) == \
        (jpolicy.HIGHWATER_PERCENTILE, jpolicy.SAFETY_FACTOR,
         jpolicy.MIN_ENVELOPE_FRACTION, jpolicy.MIN_CLASS_TENANTS)
    assert tledger.STALENESS_S == 120.0
    assert consts.node_overcommit_annotation() == \
        jc.node_overcommit_annotation()
    assert (consts.SPILL_DIR, consts.ENV_SPILL_POOL_DIR) == \
        (jc.SPILL_DIR, jc.ENV_SPILL_POOL_DIR)


# --- the policy over one node -----------------------------------------------

# tenants: (uid, workload class, cap per device, host indices, high-waters
# of the ring's records, (spill, fill, spilled) of its records or None)
SCENARIOS = {
    "classes": [
        ("t1", vc.WORKLOAD_CLASS_THROUGHPUT, 16 * GIB, [0], [GIB, GIB // 2],
         None),
        ("t2", vc.WORKLOAD_CLASS_THROUGHPUT, 16 * GIB, [1], [3 * GIB], None),
        ("l1", vc.WORKLOAD_CLASS_LATENCY, 8 * GIB, [0], [6 * GIB], None),
        ("d1", vc.WORKLOAD_CLASS_NONE, 4 * GIB, [0, 1], [2 * GIB],
         (1, 0, 512 * MIB)),
        ("d2", vc.WORKLOAD_CLASS_NONE, 4 * GIB, [1], [3 * GIB], None),
        ("d3", vc.WORKLOAD_CLASS_NONE, 2 * GIB, [0], [GIB], (0, 1, 0)),
    ],
    "one_per_class": [
        ("t1", vc.WORKLOAD_CLASS_THROUGHPUT, 16 * GIB, [0], [GIB], None),
        ("l1", vc.WORKLOAD_CLASS_LATENCY, 8 * GIB, [1], [GIB], None),
    ],
    "spilling": [
        ("s1", vc.WORKLOAD_CLASS_NONE, 32 * GIB, [0], [30 * GIB],
         (2, 0, 6 * GIB)),
        ("s2", vc.WORKLOAD_CLASS_NONE, 32 * GIB, [0], [GIB], None),
    ],
    # a tenant whose ring has no records: the feed's use samples it
    "feed_only": [
        ("f1", vc.WORKLOAD_CLASS_NONE, 16 * GIB, [0], [], None),
        ("f2", vc.WORKLOAD_CLASS_NONE, 16 * GIB, [1], [2 * GIB], None),
    ],
}


def _write_node(base: str, tc_path: str, tenants, round_: int) -> None:
    """Configs with the port's writer, and `round_`'s ring records."""
    for uid, cls, cap, hosts, hws, spill in tenants:
        cfg_path = os.path.join(base, f"{uid}_main", "config", "vtpu.config")
        if round_ == 0:
            vc.write_config(cfg_path, vc.VtpuConfig(
                pod_uid=uid, container_name="main", workload_class=cls,
                devices=[vc.DeviceConfig(uuid=f"GPU-{h}", total_memory=cap,
                                         real_memory=80 * GIB, hard_core=25,
                                         memory_limit=True, host_index=h)
                         for h in hosts]))
        if not hws:
            continue
        ring_dir = os.path.join(base, f"{uid}_main", consts.TELEMETRY_SUBDIR)
        os.makedirs(ring_dir, exist_ok=True)
        w = stepring.StepRingWriter(os.path.join(ring_dir,
                                                 consts.STEP_RING_NAME))
        for i, hw in enumerate(hws):
            s, f, b = spill if spill and i == 0 else (0, 0, 0)
            w.record(duration_ns=5_000_000, hbm_highwater_bytes=hw * (
                round_ + 1) // 2, spill_events=s, fill_events=f,
                spilled_bytes=b)
        w.close()
    tc = tc_watcher.TcUtilFile(tc_path, create=True)
    for host in (0, 1):
        tc.write_device(host, tc_watcher.DeviceUtil(
            timestamp_ns=1, device_util=50, procs=[tc_watcher.ProcUtil(
                pid=10, util=30, mem_used=0,
                owner_token=vmem.fnv64(f"{uid}/main"))
                for uid, _, _, hosts, hws, _ in tenants
                if not hws and host in hosts]))
    tc.close()


@pytest.mark.parametrize("age", [0.0, 45.0, 119.0, 130.0])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_policy_equals_the_jax_policy(tmp_path, scenario, age):
    base, tc_path = str(tmp_path / "mgr"), str(tmp_path / "tc_util.config")
    tenants = SCENARIOS[scenario]
    chips = [SimpleNamespace(index=0), SimpleNamespace(index=1)]
    theirs = UtilizationLedger("n1", chips, base_dir=base, tc_path=tc_path)
    mine = tledger.UtilizationLedger("n1", chips, base_dir=base,
                                    tc_path=tc_path)
    for round_, (mono, wall) in enumerate(((100.0, NOW), (105.0, NOW + 5))):
        _write_node(base, tc_path, tenants, round_)
        theirs.fold(now_mono=mono, now_wall=wall)
        mine.fold(now_mono=mono, now_wall=wall)
    now = NOW + 5 + age
    assert mine.hbm_fraction_samples(now) == \
        theirs.hbm_fraction_samples(now)
    a = tpolicy.OvercommitPolicy(mine).compute(now)
    b = jpolicy.OvercommitPolicy(theirs).compute(now)
    assert {k: f"{r:.2f}" for k, r in a.ratios.items()} == \
        {k: f"{r:.2f}" for k, r in b.ratios.items()}
    assert abs(a.spill_frac - b.spill_frac) <= 1e-12
    assert a.spilled_bytes == b.spilled_bytes
    assert a.encode() == b.encode()
    assert (mine.spill_events_total, mine.fill_events_total) == \
        (theirs.spill_events_total, theirs.fill_events_total)
    # the claim decays with its evidence: no fresh sample, no ratio
    if age > tledger.STALENESS_S:
        assert a.ratios == {"lat": 1.0, "thr": 1.0, "def": 1.0}


def test_the_policy_formula_on_two_tenants(tmp_path):
    """Two tenants of one class, each allocated 16 GiB and touching 1 GiB:
    the envelope is floored at 1/MAX_RATIO, so the ratio is 1 + 3 x the
    least confidence."""
    base, tc_path = str(tmp_path / "mgr"), str(tmp_path / "tc_util.config")
    tenants = [(u, vc.WORKLOAD_CLASS_NONE, 16 * GIB, [0], [2 * GIB], None)
               for u in ("a", "b")]
    led = tledger.UtilizationLedger("n1", [SimpleNamespace(index=0)],
                                    base_dir=base, tc_path=tc_path)
    for round_, (mono, wall) in enumerate(((1.0, NOW), (2.0, NOW + 1))):
        _write_node(base, tc_path, tenants, round_)
        led.fold(now_mono=mono, now_wall=wall)
    oc = tpolicy.OvercommitPolicy(led).compute(NOW + 31)
    assert oc.ratios["def"] == round(1 + 3 * (1 - 30 / 120), 2) == 3.25
    assert jratio.parse_overcommit(oc.encode(), now=NOW + 31).ratios[
        "def"] == 3.25


def test_publisher_patches_the_node_and_reaps_the_pool(tmp_path):
    client = FakeKubeClient()
    client.add_node({"metadata": {"name": "n1", "annotations": {}}})
    pool = tmp_path / "spill"
    pool.mkdir()
    (pool / f"{1:016x}-4000000-0-buf.spill").write_bytes(b"x" * 10)
    led = tledger.UtilizationLedger("n1", [],
                                    base_dir=str(tmp_path / "mgr"))
    pub = tpolicy.OvercommitPublisher(client, "n1",
                                      tpolicy.OvercommitPolicy(led),
                                      pool_dir=str(pool))
    os.utime(next(pool.iterdir()), (1, 1))
    oc = pub.publish_once()
    raw = client.get_node("n1")["metadata"]["annotations"][
        consts.node_overcommit_annotation()]
    assert raw == oc.encode()
    assert jratio.parse_overcommit(raw).ratios == {"lat": 1.0, "thr": 1.0,
                                                   "def": 1.0}
    assert list(pool.iterdir()) == []


# --- the host pool: tests/test_overcommit.py's TestSpillPool, both sides ----

PKGS = {
    "jax": SimpleNamespace(spill=jspill, vmem=jvmem, failpoints=jfp,
                           Crash=JCrashFailpoint),
    "torch": SimpleNamespace(spill=tspill, vmem=vmem, failpoints=tfp,
                             Crash=CrashFailpoint),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class TestSpillPool:
    def _pool(self, pkg, tmp_path, budget=100 * 1024):
        led = pkg.vmem.VmemLedger(str(tmp_path / "vmem.config"), create=True)
        pool = pkg.spill.SpillPool(str(tmp_path / "spill"),
                                   budget_bytes=budget, ledger=led,
                                   owner_token=0xABC)
        return pool, led

    def test_spill_fill_roundtrip_and_ledger(self, pkg, tmp_path):
        pool, led = self._pool(pkg, tmp_path)
        payload = b"w" * 4096
        pool.spill(0, "weights", payload)
        assert led.node_spilled_total() == 4096
        assert pool.spill_events == 1
        assert pool.fill(0, "weights") == payload
        assert led.node_spilled_total() == 0
        assert pool.fill(0, "weights") is None
        led.close()

    def test_budget_guard_pre_write(self, pkg, tmp_path):
        pool, led = self._pool(pkg, tmp_path, budget=8192)
        pool.spill(0, "a", b"x" * 6000)
        with pytest.raises(pkg.spill.SpillBudgetError):
            pool.spill(0, "b", b"y" * 3000)
        assert led.node_spilled_total() == 6000
        assert pkg.spill.pool_totals(pool.pool_dir) == (1, 6000)
        led.close()

    def test_budget_is_node_wide_across_processes(self, pkg, tmp_path):
        led = pkg.vmem.VmemLedger(str(tmp_path / "vmem.config"), create=True)
        a = pkg.spill.SpillPool(str(tmp_path / "spill"), budget_bytes=10000,
                                ledger=led, owner_token=1, pid=os.getpid())
        led.record_spilled(os.getpid(), 1, 7000, owner_token=2)
        with pytest.raises(pkg.spill.SpillBudgetError):
            a.spill(0, "big", b"z" * 5000)
        a.spill(0, "small", b"z" * 2000)
        led.close()

    def test_lru_victim_choice(self, pkg):
        cands = [("hot", 40, 300), ("cold", 30, 10), ("warm", 40, 100)]
        choose = pkg.spill.SpillPool.choose_victims
        assert choose(cands, 50) == ["cold", "warm"]
        assert choose(cands, 200) == []
        assert choose([], 1) == []

    def test_torn_spill_never_corrupts_ledger(self, pkg, tmp_path):
        pool, led = self._pool(pkg, tmp_path)
        pkg.failpoints.enable(seed=7)
        pkg.failpoints.arm("spill.copy", "partial-write")
        with pytest.raises(pkg.Crash):
            pool.spill(0, "torn", b"t" * 8192)
        pkg.failpoints.disable()
        assert led.node_spilled_total() == 0
        assert pkg.spill.pool_totals(pool.pool_dir) == (0, 0)
        assert [n for n in os.listdir(pool.pool_dir) if ".tmp." in n]
        assert pool.fill(0, "torn") is None
        assert pkg.spill.reap_pool(pool.pool_dir, stale_s=0.0) == 1
        assert not [n for n in os.listdir(pool.pool_dir) if ".tmp." in n]
        pkg.spill.assert_node_invariants(led, {0: GIB}, pool.budget_bytes)
        led.close()

    def test_injected_budget_exhaustion(self, pkg, tmp_path):
        pool, led = self._pool(pkg, tmp_path)
        pkg.failpoints.enable(seed=3)
        pkg.failpoints.arm("spill.budget", "error",
                           exc=pkg.spill.SpillBudgetError, count=1)
        with pytest.raises(pkg.spill.SpillBudgetError):
            pool.spill(0, "b", b"x" * 128)
        pkg.failpoints.disable()
        assert led.node_spilled_total() == 0
        pool.spill(0, "b", b"x" * 128)
        assert led.node_spilled_total() == 128
        led.close()

    def test_crashed_spiller_reaped(self, pkg, tmp_path, monkeypatch):
        monkeypatch.setenv("VTPU_VMEM_STALE_S", "0.01")
        led = pkg.vmem.VmemLedger(str(tmp_path / "vmem.config"), create=True)
        pool_dir = str(tmp_path / "spill")
        dead = pkg.spill.SpillPool(pool_dir, budget_bytes=10**6, ledger=led,
                                   owner_token=0xDEAD, pid=4_000_000)
        dead.spill(0, "orphan", b"o" * 2048)
        assert led.node_spilled_total() == 2048
        time.sleep(0.02)
        assert led.node_spilled_total() == 0
        assert pkg.spill.reap_pool(pool_dir, stale_s=0.0) == 1
        assert pkg.spill.pool_totals(pool_dir) == (0, 0)
        led.close()

    def test_invariants_guard(self, pkg, tmp_path):
        led = pkg.vmem.VmemLedger(str(tmp_path / "vmem.config"), create=True)
        me = os.getpid()
        led.record(me, 0, 10 * GIB)
        pkg.spill.assert_node_invariants(led, {0: 16 * GIB}, 8 * GIB)
        led.record(me, 0, 17 * GIB)
        with pytest.raises(AssertionError, match="resident"):
            pkg.spill.assert_node_invariants(led, {0: 16 * GIB}, 8 * GIB)
        led.record(me, 0, GIB)
        led.record_spilled(me, 0, 9 * GIB)
        with pytest.raises(AssertionError, match="spill pool"):
            pkg.spill.assert_node_invariants(led, {0: 16 * GIB}, 8 * GIB)
        led.close()

    def test_chaos_rounds_converge(self, pkg, tmp_path, monkeypatch):
        monkeypatch.setenv("VTPU_VMEM_STALE_S", "120")
        led = pkg.vmem.VmemLedger(str(tmp_path / "vmem.config"), create=True)
        budget = 64 * 1024
        pool = pkg.spill.SpillPool(str(tmp_path / "spill"),
                                   budget_bytes=budget, ledger=led,
                                   owner_token=0xC0)
        pkg.failpoints.enable(seed=11)
        pkg.failpoints.arm("spill.copy", "partial-write", p=0.3, count=3)
        pkg.failpoints.arm("spill.budget", "error",
                           exc=pkg.spill.SpillBudgetError, p=0.2, count=2)
        alive: dict[str, bytes] = {}
        for i in range(40):
            buf = f"b{i % 8}"
            payload = bytes([i % 251]) * (1024 + 17 * i)
            try:
                if buf in alive:
                    assert pool.fill(0, buf) == alive.pop(buf)
                else:
                    pool.spill(0, buf, payload)
                    alive[buf] = payload
            except (pkg.Crash, pkg.spill.SpillBudgetError):
                alive.pop(buf, None)
            pkg.spill.assert_node_invariants(led, {0: GIB}, budget)
            assert led.node_spilled_total() == \
                sum(len(v) for v in alive.values())
        led.close()


@pytest.mark.parametrize("dims,elem", [((4, 8), 4), ((0, 8), 4), ((), 2),
                                       ((2**40, 2**30), 8), ((3,), 0),
                                       ((5, -1), 4)])
def test_shape_capture_predicate_as_jax(dims, elem):
    n = tspill.spill_logical_bytes(dims, elem)
    assert n == jspill.spill_logical_bytes(dims, elem)
    for on_device in (n, n + 1, 0):
        assert tspill.spill_shape_capture_ok(n, on_device) == \
            jspill.spill_shape_capture_ok(n, on_device)


def test_both_pools_share_one_directory_ledger_and_budget(tmp_path):
    """The JAX pool and the port's on one directory and one ledger: the
    same names and `spilled` rows, one node-wide budget, and a torn port
    spill the JAX reaper converges."""
    path, pool_dir = str(tmp_path / "vmem.config"), str(tmp_path / "spill")
    jled = jvmem.VmemLedger(path, create=True)
    tled = vmem.VmemLedger(path)
    me = os.getpid()
    theirs = jspill.SpillPool(pool_dir, budget_bytes=10_000, ledger=jled,
                              owner_token=0xA, pid=me)
    mine = tspill.SpillPool(pool_dir, budget_bytes=10_000, ledger=tled,
                            owner_token=0xB, pid=me)
    theirs.spill(0, "w", b"a" * 6000)
    with pytest.raises(tspill.SpillBudgetError):
        mine.spill(1, "w", b"b" * 5000)
    mine.spill(1, "w", b"b" * 3000)
    with pytest.raises(jspill.SpillBudgetError):
        theirs.spill(0, "v", b"c" * 1001)
    assert sorted(os.listdir(pool_dir)) == sorted(
        [jspill._pool_name(0xA, me, 0, "w"), tspill._pool_name(0xB, me, 1,
                                                              "w"),
         ".budget.lock"])
    assert [(e.pid, e.host_index, e.spilled) for e in tled.entries()] == \
        [(e.pid, e.host_index, e.spilled) for e in jled.entries()] == \
        [(me, 0, 6000), (me, 1, 3000)]
    assert tspill.pool_totals(pool_dir) == jspill.pool_totals(pool_dir) == \
        (2, 9000)
    tfp.enable(seed=1)
    tfp.arm("spill.copy", "partial-write")
    with pytest.raises(CrashFailpoint):
        mine.spill(1, "torn", b"t" * 500)
    tfp.disable()
    assert tled.node_spilled_total() == jled.node_spilled_total() == 9000
    assert jspill.reap_pool(pool_dir, stale_s=0.0) == 1
    assert tspill.pool_totals(pool_dir) == (2, 9000)
    assert mine.fill(1, "w") == b"b" * 3000
    assert theirs.fill(0, "w") == b"a" * 6000
    assert tled.node_spilled_total() == 0 and tled.entries() == []
    jled.close()
    tled.close()


# --- Allocate ----------------------------------------------------------------

class _Fixed:
    """A node policy whose rollup is given."""

    def __init__(self, oc):
        self.oc = oc

    def compute(self):
        if isinstance(self.oc, Exception):
            raise self.oc
        return self.oc


@pytest.mark.parametrize("rollup", ["ratio", "stale", "fails", "none"])
@pytest.mark.parametrize("cls", ["", consts.WORKLOAD_CLASS_THROUGHPUT])
@pytest.mark.parametrize("gate", [False, True])
def test_allocate_stamps_virtual_capacity_as_the_jax_plugin(
        tmp_path, monkeypatch, gate, cls, rollup):
    """Config bytes and environment against the JAX plugin's, each plugin
    with an equal rollup of its own package: the virtual capacity from the
    class's ratio (1.0 when the rollup is stale, the policy fails or there
    is none), the node's budget, the class; gate off, zeros and no env."""
    jpool = tmp_path / "jax-node" / "spill"
    monkeypatch.setattr(jc, "SPILL_DIR", str(jpool))
    client = FakeKubeClient()
    mgr = make_manager(client)
    dirs = node_dirs(tmp_path / "port")
    p = VnumPlugin(mgr, client, "node-1", node_config=NodeConfig(), **dirs)
    jp, jclient = jax_plugin(mgr, tmp_path / "jax")
    ts = {"ratio": time.time(), "stale": time.time() - 500}.get(rollup, 0)
    raw = {"ratios": {"thr": 1.5, "def": 2.25}, "spill_frac": 0.0,
           "spilled_bytes": 0, "ts": ts}
    for plugin, mod in ((p, tratio), (jp, jratio)):
        plugin.hbm_overcommit_enabled = gate
        plugin.spill_budget_bytes = 8 * GIB if gate else 0
        plugin.overcommit_policy = (
            None if rollup == "none"
            else _Fixed(RuntimeError("torn fold")) if rollup == "fails"
            else _Fixed(mod.NodeOvercommit(**raw)))
    anns = {consts.workload_class_annotation(): cls} if cls else {}
    pod = committed_pod(mgr, cores=25, memory=16 * GIB, annotations=anns)
    client.add_pod(copy.deepcopy(pod))
    jclient.add_pod(copy.deepcopy(pod))
    ids = [device_id(mgr.chips[0].uuid, 0)]
    mine = alloc(p, *ids)
    theirs = jp.allocate(jpb.AllocateRequest(container_requests=[
        jpb.ContainerAllocateRequest(devicesIDs=ids)])).container_responses[0]
    rel = os.path.join("uid-p1_main", "config", "vtpu.config")
    with open(os.path.join(p.base_dir, rel), "rb") as f:
        mine_bytes = f.read()
    with open(os.path.join(str(tmp_path / "jax"), rel), "rb") as f:
        assert mine_bytes == f.read()
    # the names both plugins set carry the same values, the pool's path
    # apart (the JAX plugin's is its node's fixed path, patched here)
    jenvs = dict(theirs.envs)
    shared = (set(mine.envs) & set(jenvs)) - {consts.ENV_SPILL_POOL_DIR}
    assert {k: mine.envs[k] for k in shared} == {k: jenvs[k] for k in shared}
    dev = config_of(mine).devices[0]
    ratio = {"ratio": 1.5 if cls else 2.25}.get(rollup, 1.0)
    assert dev.virtual_hbm_bytes == (int(mgr.chips[0].memory * ratio)
                                     if gate else 0)
    assert dev.spill_budget_bytes == (8 * GIB if gate else 0)
    if gate:
        assert mine.envs[consts.ENV_SPILL_POOL_DIR] == consts.SPILL_DIR
        assert theirs.envs[jc.ENV_SPILL_POOL_DIR] == str(jpool)
        # the pool under the ledger's dir, which tenants mount
        assert os.path.isdir(os.path.join(dirs["vmem_dir"], "spill"))
        assert any(m.container_path == consts.VMEM_DIR
                   and m.host_path == dirs["vmem_dir"] for m in mine.mounts)
    else:
        assert consts.ENV_SPILL_POOL_DIR not in mine.envs
        assert jc.ENV_SPILL_POOL_DIR not in theirs.envs
        assert not os.path.exists(os.path.join(dirs["vmem_dir"], "spill"))


# --- the exporter ------------------------------------------------------------

SPILL_FAMILIES = ("vtpu_node_spill_step_fraction", "vtpu_node_spilled_bytes",
                  "vtpu_node_spill_pool_bytes", "vtpu_node_spill_pool_files",
                  "vtpu_node_spill_events_total",
                  "vtpu_node_fill_events_total")


@pytest.mark.parametrize("gate", [False, True])
def test_exporter_spill_series_as_jax(tmp_path, gate):
    """Gate on: the node's spill series, equal to the JAX collector's on
    the same node dir (rings, pool); gate off: none of them, on both."""
    base, tc_path = str(tmp_path / "mgr"), str(tmp_path / "tc_util.config")
    _write_node(base, tc_path, SCENARIOS["spilling"], 0)
    pool = tmp_path / "spill"
    pool.mkdir()
    (pool / f"{7:016x}-{os.getpid()}-0-b.spill").write_bytes(b"p" * 4096)
    kw = {"base_dir": base, "tc_path": tc_path,
          "vmem_path": str(tmp_path / "vmem.config"),
          "pod_resources_socket": str(tmp_path / "no-sock"),
          "kubelet_checkpoint": str(tmp_path / "no-ckpt")}
    if gate:
        kw.update(overcommit_enabled=True, spill_dir=str(pool))
    jax_text, port_text = render_both([fake_chip(0)], **kw)
    for text in (jax_text, port_text):
        present = [f for f in SPILL_FAMILIES if f"{f}{{" in text]
        assert present == (list(SPILL_FAMILIES) if gate else [])
    if gate:
        assert 'vtpu_node_spilled_bytes{node="n1"} 6442450944' in port_text
        assert 'vtpu_node_spill_pool_bytes{node="n1"} 4096' in port_text
        assert 'vtpu_node_spill_step_fraction{node="n1"} 0.5' in port_text
        spill = [ln for ln in masked(port_text) if "spill" in ln
                 or "fill_events" in ln]
        assert spill == [ln for ln in masked(jax_text) if "spill" in ln
                         or "fill_events" in ln]


# --- the scheduler admits against the port's annotation ----------------------

def test_jax_scheduler_admits_past_physical_against_the_ports_annotation(
        tmp_path):
    """The port's publisher writes the annotation from two tenants' rings;
    the JAX scheduler's filter and bind, admitting against physical x the
    published ratio, commit a pod whose memory exceeds what is left of the
    node's physical memory; the port's plugin allocates it with the virtual
    capacity stamped."""
    from vtpu_manager.client.fake import FakeKubeClient as JaxFakeKubeClient
    from vtpu_manager.scheduler.bind import BindPredicate
    from vtpu_manager.scheduler.filter import FilterPredicate
    from vtpu_manager.manager.device_manager import DeviceManager
    from vtpu_manager.tpu.discovery import FakeBackend

    client = FakeKubeClient()
    client.add_node({"metadata": {"name": "gpu-node", "annotations": {}}})
    from vtpu_manager_torch.manager.device_manager import \
        DeviceManager as PortDeviceManager
    from vtpu_manager_torch.tpu.discovery import FakeBackend as PortBackend
    mgr = PortDeviceManager("gpu-node", client,
                            node_config=NodeConfig(device_split_count=4),
                            backends=[PortBackend(1, "nvidia-h100-sxm")])
    mgr.init_devices()
    mgr.register_node()
    chip = mgr.chips[0]
    dirs = node_dirs(tmp_path)
    # two tenants of one class that hold 16 GiB each and touch 1 GiB
    tenants = [(u, vc.WORKLOAD_CLASS_NONE, 16 * GIB, [chip.index],
                [2 * GIB], None) for u in ("a", "b")]
    tc_path = str(tmp_path / "tc_util.config")
    led = tledger.UtilizationLedger("gpu-node", mgr.chips,
                                    base_dir=dirs["base_dir"],
                                    tc_path=tc_path)
    policy = tpolicy.OvercommitPolicy(led)
    for round_ in (0, 1):
        _write_node(dirs["base_dir"], tc_path, tenants, round_)
        led.fold()
    oc = tpolicy.OvercommitPublisher(client, "gpu-node", policy).publish_once()
    assert oc.ratios["def"] > 1.5
    jclient = JaxFakeKubeClient()
    jclient.add_node(client.get_node("gpu-node"))
    # a pod takes the card's physical memory but 20 GiB; the next asks 40
    for name, gib in (("p0", chip.memory // GIB - 20), ("p1", 40)):
        pod = {"metadata": {"name": name, "namespace": "default",
                            "uid": f"uid-{name}", "annotations": {}},
               "spec": {"containers": [{"name": "main", "resources": {
                   "limits": {jc.vtpu_number_resource(): 1,
                              jc.vtpu_cores_resource(): 10,
                              jc.vtpu_memory_resource(): gib * 1024}}}]},
               "status": {"phase": "Pending"}}
        jclient.add_pod(pod)
        if name == "p1":
            # at physical capacity, with the gate off, it does not fit
            assert FilterPredicate(jclient).filter(
                {"Pod": pod, "NodeNames": ["gpu-node"]}).node_names == []
        result = FilterPredicate(jclient, hbm_overcommit=True).filter(
            {"Pod": pod, "NodeNames": ["gpu-node"]})
        assert result.node_names == ["gpu-node"], (name, result)
        bound = BindPredicate(jclient).bind({
            "PodName": name, "PodNamespace": "default",
            "PodUID": f"uid-{name}", "Node": "gpu-node"})
        assert not bound.error, bound
    client.add_pod(jclient.get_pod("default", "p1"))
    p = VnumPlugin(mgr, client, "gpu-node", **dirs)
    p.hbm_overcommit_enabled = True
    p.spill_budget_bytes = 8 * GIB
    p.overcommit_policy = policy
    cresp = alloc(p, device_id(chip.uuid, 0))
    dev = config_of(cresp).devices[0]
    assert dev.total_memory == 40 * GIB
    assert dev.virtual_hbm_bytes == int(chip.memory * oc.ratios["def"])
    assert cresp.envs[consts.ENV_SPILL_POOL_DIR] == consts.SPILL_DIR


# --- the interposer's overflow tier on the fake driver ----------------------

PHYS = 256 * MIB


def overflow_run(world, uid, ops, *, cap=4 * PHYS, virtual=2 * PHYS,
                 budget=PHYS // 2, pool=True, hold=None, step=None,
                 **extra):
    """The harness's `--overflow` tenant on `world`'s node, as a Popen:
    its config from the node's writer, the fake card PHYS bytes."""
    env = world.env(str(build.build_shim()), uid, cap=cap, real_memory=PHYS,
                    virtual_memory=virtual, spill_budget=budget)
    keep = {k: v for k, v in env.items() if k.startswith("VTPU_")}
    if pool:
        keep[consts.ENV_SPILL_POOL_DIR] = str(world.root / "spill")
    if hold:
        keep["SHIM_TEST_HOLD_FILE"] = hold
    if step:
        keep["SHIM_TEST_STEP_FILE"] = step
    keep.update({k: str(v) for k, v in extra.items()})
    return subprocess.Popen(
        [str(build.build_shim_test()), "--overflow"],
        env=bench_quota.fake_harness_env(
            FAKE_TOTAL_MEM=PHYS, SHIM_TEST_OPS=",".join(ops), **keep),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def parse_overflow(out: str) -> dict:
    res = {"verdicts": [], "where": {}, "spill": []}
    for line in out.splitlines():
        parts = line.split()
        if parts and parts[0] == "VERDICT":
            res["verdicts"].append(int(parts[2]))
        elif parts and parts[0] == "WHERE":
            res["where"][int(parts[1][2:])] = parts[2]
        elif parts and parts[0] == "SPILL":
            res["spill"].append({k: int(v) for k, v in
                                 (f.split("=") for f in parts[1:])})
    return res


def finish(proc) -> dict:
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    return parse_overflow(out)


@pytest.fixture
def world(tmp_path):
    return bench_quota.World(str(tmp_path / "node"))


def test_the_overflow_arm_gives_its_verdicts(world):
    """At physical a regular grant; one byte over, within virtual and the
    budget, a grant advised to the host; over the virtual capacity and
    over the budget refused; cuMemCreate past physical refused; a free
    returns the credit."""
    ops = [f"alloc:{PHYS}", "alloc:1", f"alloc:{PHYS}",
           f"alloc:{PHYS // 2}", f"create:{MIB}", "free:1",
           f"alloc:{PHYS // 2 - 1}", "alloc:2"]
    res = finish(overflow_run(world, "t1", ops))
    OOM = 2
    assert res["verdicts"] == [0, 0, OOM, OOM, OOM, 0, 0, OOM]
    # the grant at physical is the card's memory; the overflow the host's
    assert res["where"] == {0: "none", 1: "host", 6: "host"}
    held, freed = res["spill"]
    assert held["spilled"] == PHYS // 2 - 1
    assert (held["spills"], held["rejected"], held["oom"]) == (2, 3, 4)
    # the host memory is mapped in whole 2 MiB
    assert held["host_bytes"] == PHYS // 2
    assert held["device_bytes"] == PHYS
    assert held["fill_ns"] > 0
    assert freed["spilled"] == 0 and freed["host_bytes"] == 0


def test_the_ledger_holds_the_overflow_and_the_free_returns_it(world):
    hold = str(world.root / "hold")
    proc = overflow_run(world, "t1", [f"alloc:{PHYS}", f"alloc:{MIB}"],
                        hold=hold)
    line = proc.stdout.readline()
    while line and not line.startswith("HELD"):
        line = proc.stdout.readline()
    led = vmem.VmemLedger(world.vmem_path)
    try:
        (entry,) = led.entries()
        assert (entry.bytes, entry.spilled) == (PHYS, MIB)
        assert led.node_spilled_total() == MIB
        open(hold, "w").close()
        proc.wait(timeout=60)
        assert led.entries() == [] and led.node_spilled_total() == 0
    finally:
        led.close()
        if proc.poll() is None:
            proc.kill()


def test_the_budget_counts_another_processs_entry(world):
    """Another process's spilled bytes in the ledger (this test's pid: a
    live owner) take the budget: the same request is refused, then
    granted once that entry returns its bytes."""
    led = vmem.VmemLedger(world.vmem_path)
    led.record_spilled(os.getpid(), 3, PHYS // 2 - MIB, owner_token=99)
    res = finish(overflow_run(world, "t1", [f"alloc:{PHYS}",
                                            f"alloc:{2 * MIB}"]))
    assert res["verdicts"] == [0, 2]
    assert res["spill"][0]["rejected"] == 1
    led.record_spilled(os.getpid(), 3, 0)
    res = finish(overflow_run(world, "t1", [f"alloc:{PHYS}",
                                            f"alloc:{2 * MIB}"]))
    assert res["verdicts"] == [0, 0] and res["where"][1] == "host"
    led.close()


@pytest.mark.parametrize("case", ["no_pool", "virtual_at_physical",
                                  "no_virtual"])
def test_an_unarmed_tier_refuses_at_physical(world, case):
    kw = {"no_pool": {"pool": False},
          "virtual_at_physical": {"virtual": PHYS},
          "no_virtual": {"virtual": 0}}[case]
    res = finish(overflow_run(world, "t1", [f"alloc:{PHYS}", "alloc:1"],
                              **kw))
    assert res["verdicts"] == [0, 2]
    assert res["spill"][0]["spills"] == 0
    assert res["spill"][0]["rejected"] == 0
    assert res["spill"][0]["spilled"] == 0


def test_the_cap_counts_the_overflow(world):
    """The tenant's cap holds its spilled bytes too."""
    res = finish(overflow_run(world, "t1", [f"alloc:{PHYS}", f"alloc:{MIB}",
                                            "alloc:1"], cap=PHYS + MIB))
    assert res["verdicts"] == [0, 0, 2]
    assert res["spill"][0]["rejected"] == 0


def test_a_co_tenant_within_physical_is_granted_beside_the_overflow(world):
    """A tenant over physical with bytes in the overflow: a co-tenant's
    allocation that fits in what is left of physical memory is granted,
    and the next byte past it goes to the co-tenant's own overflow."""
    hold = str(world.root / "hold")
    first = overflow_run(world, "t1", [f"alloc:{PHYS - 64 * MIB}",
                                       f"alloc:{PHYS // 2}"], hold=hold,
                         budget=PHYS)
    line = first.stdout.readline()
    while line and not line.startswith("HELD"):
        line = first.stdout.readline()
    try:
        res = finish(overflow_run(world, "t2", [f"alloc:{64 * MIB}",
                                                "alloc:1"], budget=PHYS))
        assert res["verdicts"] == [0, 0]
        assert res["where"] == {0: "none", 1: "host"}
    finally:
        open(hold, "w").close()
        first.wait(timeout=60)


def test_a_dead_owners_spilled_bytes_are_reaped(world, monkeypatch):
    """A spiller killed while holding overflow bytes: its entry's
    `spilled` stops counting once it is dead and stale, and the next
    tenant's overflow has the whole budget again."""
    hold = str(world.root / "hold")
    proc = overflow_run(world, "t1", [f"alloc:{PHYS}", f"alloc:{PHYS // 2}"],
                        hold=hold)
    line = proc.stdout.readline()
    while line and not line.startswith("HELD"):
        line = proc.stdout.readline()
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    monkeypatch.setenv("VTPU_VMEM_STALE_S", "0.05")
    time.sleep(0.1)
    res = finish(overflow_run(world, "t2", [f"alloc:{PHYS // 2}"],
                              VTPU_VMEM_STALE_S="0.05"))
    # the dead owner's resident bytes are stale too: physical is free
    assert res["verdicts"] == [0] and res["where"] == {0: "none"}
    res = finish(overflow_run(world, "t3", [f"alloc:{PHYS}",
                                            f"alloc:{PHYS // 2}"],
                              VTPU_VMEM_STALE_S="0.05"))
    assert res["verdicts"] == [0, 0] and res["where"][1] == "host"
    led = vmem.VmemLedger(world.vmem_path)
    assert led.node_spilled_total() == 0
    led.close()


def test_gate_off_config_refuses_past_physical_as_before(world):
    """A config with no virtual capacity or budget (the gate off) and no
    pool: the refusal past physical is the one before the tier."""
    res = finish(overflow_run(world, "t1", [f"alloc:{PHYS}", "alloc:1",
                                            f"create:{MIB}"], virtual=0,
                              budget=0, pool=False))
    assert res["verdicts"] == [0, 2, 2]
    held, freed = res["spill"]
    assert (held["spills"], held["rejected"], held["spilled"],
            held["oom"]) == (0, 0, 0, 2)
    assert freed["spilled"] == 0


# --- the commands ------------------------------------------------------------

def test_the_exporter_takes_the_gate_and_renders_the_spill_series(tmp_path):
    from test_torch_device_monitor import Exporter, node_dir
    node_dir(tmp_path)
    pool = tmp_path / "spill"
    pool.mkdir()
    (pool / f"{7:016x}-{os.getpid()}-0-b.spill").write_bytes(b"p" * 100)
    bodies = {}
    for gates in ("StepTelemetry=true", "StepTelemetry=true,"
                  "HBMOvercommit=true"):
        exp = Exporter(tmp_path, "--feature-gates", gates)
        try:
            bodies[gates] = exp.get("/metrics")[1]
        finally:
            assert exp.stop() == 0
    off, on = bodies.values()
    assert not [f for f in SPILL_FAMILIES if f in off]
    assert 'vtpu_node_spill_pool_bytes{node="n1"} 100' in on
    assert 'vtpu_node_spill_pool_files{node="n1"} 1' in on
    assert all(f"{f}{{" in on for f in SPILL_FAMILIES)


def test_the_device_plugin_takes_the_gate_and_publishes(tmp_path):
    """`--feature-gates HBMOvercommit=true --spill-budget-gib 8` is taken:
    the publisher runs; without the gate the budget flag changes nothing."""
    from test_torch_entry import ENTRY, _env, private_flags
    for gates, marker in (("HBMOvercommit=true",
                           "overcommit policy publisher running (budget "
                           "8.0 GiB)"), ("", "device plugin running")):
        proc = subprocess.Popen(
            ENTRY + private_flags(tmp_path) + [
                "--fake-chips", "1", "--fake-client", "--feature-gates",
                gates, "--spill-budget-gib", "8"],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            seen = []
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                line = proc.stdout.readline()
                seen.append(line)
                if not line or "device plugin running" in line:
                    break
            text = "".join(seen)
            assert marker in text, text
            assert ("overcommit" in text) == bool(gates), text
        finally:
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0


# --- the Python writer's spill-fill deltas ------------------------------------

def _spill_fill_ring(side, path, totals):
    from vtpu_manager.runtime import client as jclient
    from vtpu_manager.telemetry import stepring as jring
    from vtpu_manager_torch.runtime import client as tclient
    mod_ring, mod_client = (jring, jclient) if side == "jax" else \
        (stepring, tclient)
    state = {"i": 0}
    values = [0, *totals]
    wrapped = mod_client._ShimWaitStepRing(
        mod_ring.StepRingWriter(str(path)), lambda: 0,
        spill_fill_fn=lambda: values[state["i"]])
    for i in range(1, len(values)):
        state["i"] = i
        wrapped.record(10_000_000 + i, start_mono_ns=10**12 + i * 10**8)
    wrapped.close()
    return path.read_bytes()


@pytest.mark.parametrize("totals,deltas", [
    ([700, 700, 2500], [700, 0, 1800]),
    ([900, 0, 40], [900, 0, 40])], ids=["rising", "reloaded"])
def test_python_writer_spill_fill_equals_jax(tmp_path, totals, deltas):
    """The records byte for byte the JAX writer's for one sequence of the
    interposer's `vtpu_spill_fill_ns_total`: each record its delta, a
    reloaded interposer re-baselined."""
    mine = _spill_fill_ring("port", tmp_path / "port.ring", totals)
    assert mine == _spill_fill_ring("jax", tmp_path / "jax.ring", totals)
    reader = stepring.StepRingReader(str(tmp_path / "port.ring"))
    recs, _, _ = reader.poll(0)
    reader.close()
    assert [r.spill_fill_time_ns for r in recs] == deltas


def test_spill_fill_source_needs_the_pool_env_as_jax(monkeypatch):
    from vtpu_manager.runtime import client as jclient
    from vtpu_manager_torch.runtime import client as tclient
    monkeypatch.delenv(consts.ENV_SPILL_POOL_DIR, raising=False)
    assert tclient._interposer_spill_fill_source() is None
    assert jclient._shim_spill_fill_source() is None
    # armed in a process without the interposer: no accessor either
    monkeypatch.setenv(consts.ENV_SPILL_POOL_DIR, "/nonexistent/spill")
    assert tclient._interposer_spill_fill_source() is None
