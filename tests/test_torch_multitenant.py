"""Several tenants on one (fake) card: the cases of
tests/test_multitenant.py:93-258 and tests/test_shim_closedloop.py:34-175,
run against the port's interposer, each tenant reading its limits from its
own vtpu.config.

The fake driver's FAKE_SHARED_STATE makes the card real contention: one
timeline shared by every process (an flock guards it) and a busy counter,
which `BusySampler` turns into the utilization the port's node watcher
(`TcWatcherDaemon`) publishes. Bands are the JAX tests' own.
"""

from __future__ import annotations

import os
import signal
import struct
import subprocess
import time

import pytest

from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.config import tc_watcher as tc
from vtpu_manager_torch.config.vmem import VmemLedger, fnv64
from vtpu_manager_torch.manager.watcher import TcWatcherDaemon

MIB = 1 << 20


class BusySampler:
    """The card's utilization from the fake's shared busy counter."""

    def __init__(self, state_path: str):
        self.path = state_path
        self.last = (0, time.monotonic_ns())

    def sample(self, host_index: int) -> int:
        with open(self.path, "rb") as f:
            busy, = struct.unpack("<Q", f.read(8))
        now = time.monotonic_ns()
        prev_busy, prev_t = self.last
        self.last = (busy, now)
        return min(100, int(100 * (busy - prev_busy) / max(now - prev_t, 1)))


@pytest.fixture
def world(tmp_path):
    w = bench_quota.World(str(tmp_path / "node"))
    w.state = str(tmp_path / "card.state")
    with open(w.state, "wb") as f:
        f.write(b"\0" * 16)
    return w


@pytest.fixture
def watcher(world):
    """The node watcher over the world's ledger and feed, at 20 ms."""
    d = TcWatcherDaemon([0], BusySampler(world.state), tc_path=world.tc_path,
                        vmem_path=world.vmem_path, interval_ms=20)
    d.start()
    yield d
    d.stop()


def harness_env(world, pod_uid, container="main", iters=300, extra=None,
                **config):
    env = world.env(str(build.build_shim()), pod_uid, container, **config)
    env.update({"SHIM_PATH": env["LD_PRELOAD"],
                "VTPU_REAL_CUDA_LIBRARY_PATH": str(build.build_fake_driver()),
                "FAKE_SHARED_STATE": world.state, "FAKE_EXEC_US": "2000",
                "SHIM_TEST_ITERS": str(iters)})
    env.update({k: str(v) for k, v in (extra or {}).items()})
    return env


def spawn(env, mode="--throttle-only"):
    return subprocess.Popen([str(build.build_shim_test()), mode], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, timeout=120):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out + err
    return bench_quota.parse_harness(out)


def run_together(world, specs, iters):
    """Every (pod_uid, quota) tenant at once; their parsed outputs."""
    procs = {uid: spawn(harness_env(world, uid, iters=iters, hard_core=q))
             for uid, q in specs}
    return {uid: finish(p) for uid, p in procs.items()}


def test_two_tenants_share_one_card(world, watcher):
    out = run_together(world, [("uid-a", 50), ("uid-b", 50)], iters=300)
    walls = [o["wall_ms"] for o in out.values()]
    # 2 x 600 ms of serialized busy demand: faster walls would mean the
    # card was not shared at all
    assert min(walls) >= 1000, walls
    assert max(walls) / min(walls) < 2.0, walls
    # each read the feed the watcher published
    assert all(o["vtpu_watcher_external_total"] > 0 for o in out.values())


def test_unequal_quotas_bias_the_card(world, watcher):
    out = run_together(world, [("uid-hi", 75), ("uid-lo", 25)], iters=300)
    assert out["uid-hi"]["wall_ms"] < out["uid-lo"]["wall_ms"], out


def test_three_tenants_quota_ordering(world, watcher):
    # 300 steps: q60's and q25's walls about 1.0 and 2.4 s apart by their
    # quotas, far past a loaded host's start-up stalls (150 steps once
    # left them 2 ms apart under -n 6)
    out = run_together(world, [("uid-hi", 60), ("uid-mid", 25),
                               ("uid-lo", 10)], iters=300)
    walls = {uid: o["wall_ms"] for uid, o in out.items()}
    assert walls["uid-hi"] < walls["uid-mid"] < walls["uid-lo"], walls
    assert walls["uid-hi"] >= 350, walls
    assert walls["uid-lo"] >= 2000, walls     # paced at 10 %...
    assert walls["uid-lo"] <= 15000, walls    # ...but not starved


# --- memory across processes -------------------------------------------


def hold(world, pod_uid, allocs, hold_file, container="main", extra=None,
         **config):
    env = harness_env(world, pod_uid, container,
                      extra={"SHIM_TEST_ALLOCS": ",".join(
                          str(a * MIB) for a in allocs),
                          "SHIM_TEST_HOLD_FILE": hold_file, **(extra or {})},
                      **config)
    proc = spawn(env, "--alloc")
    verdicts = {}
    for line in proc.stdout:
        if line.startswith("VERDICT"):
            _, label, rc = line.split()
            verdicts[label] = int(rc)
        if line.startswith("HELD"):
            return proc, verdicts
    raise AssertionError(proc.stderr.read())


def alloc_once(world, pod_uid, allocs, extra=None, **config):
    env = harness_env(world, pod_uid, extra={
        "SHIM_TEST_ALLOCS": ",".join(str(a * MIB) for a in allocs),
        **(extra or {})}, **config)
    return finish(spawn(env, "--alloc"))


def release(procs, hold_file):
    open(hold_file, "w").close()
    for p in procs:
        p.communicate(timeout=30)


def test_sibling_processes_share_the_cap(world, tmp_path):
    release_file = str(tmp_path / "release")
    first, got = hold(world, "uid-sib", [12], release_file, container="a",
                      cap=16 * MIB, real_memory=80 * MIB)
    try:
        assert got == {"alloc0": 0}
        # the same tenant (pod and container) from a second process
        out = alloc_once(world, "uid-sib", [8, 2], container="a",
                         cap=16 * MIB, real_memory=80 * MIB)
        assert out["verdicts"] == {"alloc0": 2, "alloc1": 0}
        assert out["vtpu_oom_rejected_total"] == 1
    finally:
        release([first], release_file)


def test_co_tenant_does_not_consume_my_cap(world, tmp_path):
    release_file = str(tmp_path / "release")
    other, got = hold(world, "uid-other", [12], release_file, cap=16 * MIB,
                      real_memory=80 * MIB)
    try:
        out = alloc_once(world, "uid-me", [12], cap=16 * MIB,
                         real_memory=80 * MIB)
        assert out["verdicts"] == {"alloc0": 0}
    finally:
        release([other], release_file)


def test_physical_pressure_refused_by_the_interposer(world, tmp_path):
    release_file = str(tmp_path / "release")
    a, got_a = hold(world, "uid-a", [36], release_file, cap=40 * MIB,
                    real_memory=80 * MIB)
    b, got_b = hold(world, "uid-b", [36], release_file, cap=40 * MIB,
                    real_memory=80 * MIB)
    try:
        assert got_a == got_b == {"alloc0": 0}
        out = alloc_once(world, "uid-c", [12, 4], cap=40 * MIB,
                         real_memory=80 * MIB)
        # 72 + 12 > 80: refused before the driver sees it; 72 + 4 fits
        assert out["verdicts"] == {"alloc0": 2, "alloc1": 0}
        assert out["vtpu_oom_rejected_total"] == 1
    finally:
        release([a, b], release_file)


def test_killed_tenant_reaped_and_capacity_recovered(world, tmp_path,
                                                     monkeypatch):
    release_file = str(tmp_path / "release")
    dead, got = hold(world, "uid-x", [12], release_file, container="a",
                     cap=16 * MIB, real_memory=80 * MIB)
    assert got == {"alloc0": 0}
    dead.send_signal(signal.SIGKILL)       # no exit handler runs
    dead.wait(timeout=10)
    dead.stdout.close()
    dead.stderr.close()
    ledger = VmemLedger(world.vmem_path)
    try:
        assert any(e.pid == dead.pid for e in ledger.entries())
        # while the dead entry is not stale it still holds the capacity
        out = alloc_once(world, "uid-x", [12], container="a", cap=16 * MIB,
                         real_memory=80 * MIB,
                         extra={"VTPU_VMEM_STALE_S": "600"})
        assert out["verdicts"] == {"alloc0": 2}
        # stale after 1 s: a sibling of the dead tenant takes it again
        time.sleep(1.2)
        out = alloc_once(world, "uid-x", [12], container="a", cap=16 * MIB,
                         real_memory=80 * MIB,
                         extra={"VTPU_VMEM_STALE_S": "1"})
        assert out["verdicts"] == {"alloc0": 0}
        # and the node's sweep frees the slot
        monkeypatch.setenv("VTPU_VMEM_STALE_S", "1")
        assert ledger.reap_dead() >= 1
        assert not any(e.pid == dead.pid for e in ledger.entries())
    finally:
        ledger.close()


def test_exited_tenant_leaves_no_entry(world):
    out = alloc_once(world, "uid-gone", [1], cap=16 * MIB)
    assert out["verdicts"] == {"alloc0": 0}
    ledger = VmemLedger(world.vmem_path)
    assert ledger.entries() == []
    ledger.close()


# --- the feed and the controllers ---------------------------------------


def test_external_feed_engages(world, tmp_path):
    feed = tc.TcUtilFile(world.tc_path)
    co_token = fnv64("uid-cotenant/main")
    feed.write_device(0, tc.DeviceUtil(time.monotonic_ns(), 90, [
        tc.ProcUtil(pid=7, util=45, mem_used=MIB, owner_token=co_token)]))
    env = harness_env(world, "uid-me", iters=100, hard_core=50)
    proc = spawn(env)
    try:
        # a fresh feed every 50 ms while the tenant runs
        while proc.poll() is None:
            feed.write_device(0, tc.DeviceUtil(time.monotonic_ns(), 90, [
                tc.ProcUtil(7, 45, MIB, co_token)]))
            time.sleep(0.05)
        out = finish(proc)
    finally:
        feed.close()
    assert out["vtpu_watcher_external_total"] > 0
    assert out["vtpu_blind_ticks_total"] == 0


def test_stale_feed_falls_back_to_self_estimate(world):
    feed = tc.TcUtilFile(world.tc_path)
    feed.write_device(0, tc.DeviceUtil(1, 90, [tc.ProcUtil(7, 45, 0, 123)]))
    feed.close()
    out = finish(spawn(harness_env(world, "uid-me", iters=60,
                                   hard_core=50)))
    assert out["vtpu_watcher_external_total"] == 0
    assert out["vtpu_watcher_fallback_total"] > 0


def _wall(world, pod_uid, iters=400, **config):
    return finish(spawn(harness_env(world, pod_uid, iters=iters, **config)))


@pytest.mark.parametrize("fed", [False, True])
def test_balance_mode_climbs_toward_the_soft_limit(world, request, fed):
    if fed:         # the node watcher's feed is fresh, as on a card
        request.getfixturevalue("watcher")
    fixed = _wall(world, "uid-fixed", hard_core=25)
    balance = _wall(world, "uid-bal", hard_core=25, soft_core=90)
    # 400 x 2 ms: fixed 25 % takes about 3.2 s; balance climbs past it
    assert balance["wall_ms"] < fixed["wall_ms"] * 0.8, (fixed, balance)
    assert balance["vtpu_up_limit"] > 25


def test_balance_mode_pinned_when_a_co_tenant_is_present(world):
    ledger = VmemLedger(world.vmem_path)
    # this test process plays the co-tenant: alive, foreign token, bytes
    ledger.record(os.getpid(), 0, 256 * MIB,
                  owner_token=fnv64("uid-cotenant/main"))
    try:
        fixed = _wall(world, "uid-fixed", hard_core=25)
        pinned = _wall(world, "uid-pin", hard_core=25, soft_core=90)
    finally:
        ledger.record(os.getpid(), 0, 0)
        ledger.close()
    climbed = _wall(world, "uid-free", hard_core=25, soft_core=90)
    assert pinned["wall_ms"] > fixed["wall_ms"] * 0.8, (fixed, pinned)
    assert pinned["wall_ms"] > climbed["wall_ms"] * 1.25, (climbed, pinned)
    assert pinned["vtpu_up_limit"] == 25


def test_lagging_feed_does_not_blind_an_honest_tenant(world):
    """NVML's utilization averages over up to 1 s, so a tenant's first
    second sees the card as it was before it started: here 90 % busy and
    all of it attributed to the tenant, four times its 10 % and more. The
    interposer does not judge those horizons; its own samples are
    honest."""
    feed = tc.TcUtilFile(world.tc_path)
    proc = spawn(harness_env(world, "uid-late", iters=100, hard_core=10))
    t0 = time.monotonic()
    try:
        while proc.poll() is None:
            util = 90 if time.monotonic() - t0 < 0.8 else 10
            feed.write_device(0, tc.DeviceUtil(time.monotonic_ns(), util, []))
            time.sleep(0.05)
        out = finish(proc)
    finally:
        feed.close()
    assert out["vtpu_watcher_external_total"] > 0
    assert out["vtpu_blind_ticks_total"] == 0, out


def test_blind_tenant_held_by_the_controllers(world, watcher):
    """Events that complete when recorded: the tenant's own samples see no
    device time, so only the watcher's feed can pace it. Its first second
    is not judged (the feed's lag), so it runs free for that long."""
    iters = 1200                             # 2.4 s of device demand
    blind = _wall(world, "uid-blind", iters=iters, hard_core=25,
                  extra={"FAKE_LYING_EVENTS": 1})
    assert blind["vtpu_blind_ticks_total"] > 0
    share = 100.0 * iters * 2.0 / blind["wall_ms"]
    assert share < 50, blind
    # without the feed the same blind tenant runs nearly unthrottled
    unfed = _wall(world, "uid-blind2", iters=iters, hard_core=25,
                  extra={"FAKE_LYING_EVENTS": 1,
                         "VTPU_TC_UTIL_PATH": "/nonexistent"})
    assert unfed["wall_ms"] < blind["wall_ms"] * 0.7, (unfed, blind)
