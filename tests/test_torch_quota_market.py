"""The quota market's node side in the port against the JAX package.

Each ported piece runs through both packages on the same inputs at the
same explicit clock: the lease ledger (`quota/ledger.py`) over one
sequence of grants, settles and compacts; the codecs (the lease summary,
the victim-cost rollup) over a table of fresh, stale, empty and garbage
annotations; the market's pure helpers over a grid; the market itself
(`quota/market.py`) over every case of `tests/test_quota.py::TestMarket`
and a seeded random walk, two managers side by side over two copies of
one node directory and the JAX test's fake utilization states, with the
configs' bytes, the ledgers' bytes, the counters and the annotation equal
and the conservation rule held after every pass; the audit's trace
events; the crash, torn-ledger and restart chaos of
`TestReclaimChaos` with each package's failpoints armed; the victim
costs (`quota/victimcost.py`); the rollup's lease fold and vtpu-smi's
lent and borrowed columns; the commands under the gate. Then the loop
end to end on the fake driver: the port's market over two harness
tenants' rings lends an idle throughput tenant's headroom to a throttled
latency-critical one, whose interposer adopts it, and takes it back when
the lender's demand returns.
"""

from __future__ import annotations

import copy
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import time
from pathlib import Path
from random import Random
from types import SimpleNamespace

import numpy as np
import pytest

import test_torch_device_monitor as tdm
import test_torch_utilization as tu
from test_torch_utilization import frozen  # noqa: F401 - a fixture
from test_quota import FakeState, FakeUtil, write_tenant
from test_torch_entry import ENTRY, _env, private_flags
from test_torch_quota_lease import EXEC_US, SHARE_BAND, Steps, rate
from vtpu_manager import quota as jq
from vtpu_manager import trace as jtrace
from vtpu_manager.client.fake import FakeKubeClient as JaxFakeKubeClient
from vtpu_manager.config import vmem as jvmem
from vtpu_manager.config import vtpu_config as jvc
from vtpu_manager.quota import ledger as jledger
from vtpu_manager.quota import market as jmarket
from vtpu_manager.quota import victimcost as jvictim
from vtpu_manager.resilience import failpoints as jfp
from vtpu_manager_torch import bench_quota
from vtpu_manager_torch import quota as pq
from vtpu_manager_torch import trace as ptrace
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.cmd import device_plugin as dp
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.quota import ledger as pledger
from vtpu_manager_torch.quota import market as pmarket
from vtpu_manager_torch.quota import victimcost as pvictim
from vtpu_manager_torch.resilience import failpoints as pfp
from vtpu_manager_torch.telemetry import stepring
from vtpu_manager_torch.tools import vtpu_smi
from vtpu_manager_torch.util import consts
from vtpu_manager_torch.utilization import UtilizationLedger

NOW = 1_700_000_000.0
TP, LAT, NONE = (vc.WORKLOAD_CLASS_THROUGHPUT, vc.WORKLOAD_CLASS_LATENCY,
                 vc.WORKLOAD_CLASS_NONE)
PACKAGES = {"jax": jq, "port": pq}


@pytest.fixture(autouse=True)
def _isolation():
    yield
    jfp.disable()
    pfp.disable()
    jtrace.reset()
    ptrace.reset()


def test_names_and_constants_are_the_jax_packages():
    from vtpu_manager.util import consts as jc
    assert consts.node_quota_lease_annotation() == \
        jc.node_quota_lease_annotation()
    assert consts.node_victim_cost_annotation() == \
        jc.node_victim_cost_annotation()
    for name in ("REVOKE_MARGIN_PCT", "GRANT_HEADROOM_PCT",
                 "WELL_USED_UTILIZATION", "UNUSED_UTILIZATION",
                 "CLASS_TO_ABI"):
        assert getattr(pmarket, name) == getattr(jmarket, name), name
    for name in ("LEDGER_NAME", "STATE_GRANTED", "STATE_REVOKED",
                 "STATE_EXPIRED"):
        assert getattr(pledger, name) == getattr(jledger, name), name
    for name in ("MAX_VICTIM_COST_AGE_S", "FUTURE_SKEW_TOLERANCE_S",
                 "UID_PREFIX_LEN", "MAX_TENANTS", "MAX_VC_LEN"):
        assert getattr(pvictim, name) == getattr(jvictim, name), name
    assert pq.MAX_LEASE_SUMMARY_AGE_S == jq.MAX_LEASE_SUMMARY_AGE_S
    assert set(pq.__all__) == set(jq.__all__)


# --- the lease ledger ---------------------------------------------------------

def _ledger_ops(seed: int) -> list[tuple]:
    """A seeded sequence of grants, settles, compacts and tears."""
    rng = np.random.default_rng(seed)
    ops, now, granted = [], NOW, 0
    for _ in range(30):
        now += float(rng.uniform(0.5, 20.0))
        r = rng.random()
        if r < 0.45 or not granted:
            ops.append(("grant", int(rng.integers(0, 2)),
                        f"t{rng.integers(0, 3)}/main",
                        f"i{rng.integers(0, 3)}/main",
                        int(rng.integers(1, 30)),
                        float(rng.uniform(5.0, 60.0)), now))
            granted += 1
        elif r < 0.75:
            ops.append(("settle", [f"q{int(rng.integers(1, granted + 2))}"],
                        str(rng.choice([jledger.STATE_REVOKED,
                                        jledger.STATE_EXPIRED])), now))
        elif r < 0.93:
            ops.append(("compact", float(rng.uniform(5.0, 100.0)), now))
        else:
            ops.append(("tear", now))
    return ops


def _apply(led, op) -> object:
    kind = op[0]
    if kind == "grant":
        return led.grant(*op[1:])
    if kind == "settle":
        prefixes, state, now = op[1:]
        ids = [l["id"] for l in led.leases()
               if any(l["id"].startswith(p + "-") for p in prefixes)]
        return led.settle(ids, state, now=now)
    if kind == "compact":
        return led.compact(retain_s=op[1], now=op[2])
    with open(led.path, "w") as f:
        f.write('{"epoch": 3, "leas')
    return None


@pytest.mark.parametrize("seed", range(6))
def test_the_ledger_follows_the_jax_ledger(tmp_path, seed):
    clock = {"now": NOW}
    leds = {"jax": jledger.QuotaLeaseLedger(str(tmp_path / "jax"),
                                            clock=lambda: clock["now"]),
            "port": pledger.QuotaLeaseLedger(str(tmp_path / "port"),
                                             clock=lambda: clock["now"])}
    for op in _ledger_ops(seed):
        clock["now"] = op[-1]
        out = {side: _apply(led, op) for side, led in leds.items()}
        assert out["jax"] == out["port"], op
        raws = {side: (open(led.path, "rb").read() if led.exists()
                       else None) for side, led in leds.items()}
        assert raws["jax"] == raws["port"], op
        for later in (op[-1], op[-1] + 30.0):
            views = {s: led.snapshot(now=later) for s, led in leds.items()}
            assert [(v.epoch, v.leases, v.active, v.deltas)
                    for v in views.values()] == 2 * [
                (views["jax"].epoch, views["jax"].leases,
                 views["jax"].active, views["jax"].deltas)]
            for fn in ("active", "due", "deltas"):
                assert getattr(leds["port"], fn)(now=later) == \
                    getattr(leds["jax"], fn)(now=later), fn
            assert leds["port"].active(now=later, chip=1) == \
                leds["jax"].active(now=later, chip=1)
        assert leds["port"].epoch() == leds["jax"].epoch()
        assert leds["port"].load() == leds["jax"].load()


@pytest.mark.parametrize("torn", ['{"epoch": 3, "leas', "[1, 2]", "{torn",
                                  '{"epoch": 2}', ""])
def test_a_torn_ledger_loads_empty_in_both(tmp_path, torn):
    docs = {}
    for side, mod in (("jax", jledger), ("port", pledger)):
        led = mod.QuotaLeaseLedger(str(tmp_path / side), clock=lambda: NOW)
        led.grant(0, "a/main", "b/main", 5, 30.0, now=NOW - 5)
        with open(led.path, "w") as f:
            f.write(torn)
        docs[side] = led.load()
        assert docs[side]["leases"] == [] and docs[side].get("recovered")
        assert docs[side]["epoch"] == int(NOW) & 0x7FFFFFFF
        led.settle([], mod.STATE_REVOKED, now=NOW + 1)
        assert not led.load().get("recovered")
    assert docs["jax"] == docs["port"]
    assert open(tmp_path / "jax" / pledger.LEDGER_NAME, "rb").read() == \
        open(tmp_path / "port" / pledger.LEDGER_NAME, "rb").read()


def test_lease_is_active_agrees():
    for state in (jledger.STATE_GRANTED, jledger.STATE_REVOKED, None):
        for granted_at in (NOW - 40, NOW - 10, NOW):
            lease = {"state": state, "granted_at": granted_at,
                     "ttl_s": 30.0}
            for now in (NOW - 1, NOW, NOW + 25):
                assert pq.lease_is_active(lease, now) == \
                    jq.lease_is_active(lease, now)
    assert pledger.deltas_from([]) == {}


# --- the codecs and the pure helpers -------------------------------------------

LEASE_SUMMARIES = [
    None, "", "garbage", "@", f"@{NOW}", f"0:25:2@{NOW}",
    f"0:25:2;1:10:1@{NOW - 110}", f"0:25:2@{NOW - 121}",
    f"0:25:2@{NOW + 4}", f"0:25:2@{NOW + 6}", f"0:a:b@{NOW}",
    f"0:25@{NOW}", f"0:-5:-1@{NOW}", f"0:25:2;;1:3:1@{NOW}",
    f"0:25:2@nan", f"0:25:2@inf", f"0:25:2@x@{NOW}", f"x:1:1@{NOW}",
]


@pytest.mark.parametrize("raw", LEASE_SUMMARIES)
def test_lease_summaries_decode_alike(raw):
    for now in (NOW, NOW + 60, NOW + 200):
        assert pq.parse_lease_summary(raw, now=now) == \
            jq.parse_lease_summary(raw, now=now)


VICTIM_COSTS = [
    None, "", "garbage", f"@{NOW}", f"uid-aaaaaaaaaaaaaaa:l:0.250@{NOW}",
    f"uid-a:l:0.250;uid-b:-:0.000@{NOW - 119}", f"uid-a:l:0.2@{NOW - 121}",
    f"uid-a:x:0.2;uid-b:l:nan;uid-c:l:inf;:l:0.1;uid-d:-:2.5@{NOW}",
    f"uid-a:l:-0.5;uid-b:l@{NOW}", f"uid-a:l:0.1@{NOW + 6}",
    ";".join(f"u{i}:l:0.1" for i in range(80)) + f"@{NOW}",
    "u:l:0.1;" * 600 + f"@{NOW}", f"uid-a:l:abc;uid-b:-:0.5@{NOW}",
]


def _costs(vcs):
    return None if vcs is None else (vcs.tenants, vcs.ts)


@pytest.mark.parametrize("raw", VICTIM_COSTS)
def test_victim_costs_decode_alike(raw):
    for now in (NOW, NOW + 60, NOW + 200):
        mine = pvictim.parse_victim_costs(raw, now=now)
        theirs = jvictim.parse_victim_costs(raw, now=now)
        assert _costs(mine) == _costs(theirs)
        for later in (now, now + 100):
            assert pvictim.victim_costs_fresh(mine, later) == \
                jvictim.victim_costs_fresh(theirs, later)
        if mine is not None:
            assert mine.encode() == theirs.encode()
            for uid in ("uid-a", "uid-aaaaaaaaaaaaaaaXYZ", "", None):
                assert mine.lookup(uid) == theirs.lookup(uid)


def test_the_pure_helpers_agree_over_a_grid():
    useds = (None, 0.0, 10.0, 39.5, 45.0, 60.0, 120.0)
    bases = (None, 0, 40)
    borrows = (-5, 0, 1, 10, 40)
    for used in useds:
        for base in bases:
            for borrowed in borrows:
                assert pmarket.borrowed_used_verdict(used, base, borrowed) \
                    == jmarket.borrowed_used_verdict(used, base, borrowed)
                for prev in (1, 5, 10, 25, 40):
                    assert pmarket.scaled_grant_step(
                        prev, 10, 40, used, base, borrowed) == \
                        jmarket.scaled_grant_step(
                            prev, 10, 40, used, base, borrowed)
    for hard in (0, 25, 60, 100):
        for lease in (-100, -25, 0, 25, 75):
            assert pq.effective_core(hard, lease) == \
                jq.effective_core(hard, lease)
    for cls in ("", "garbage", consts.WORKLOAD_CLASS_THROUGHPUT,
                consts.WORKLOAD_CLASS_LATENCY_CRITICAL):
        pod = {"metadata": {"annotations": {
            consts.workload_class_annotation(): cls}}}
        assert pq.workload_class_of(pod) == jq.workload_class_of(pod)
        assert pq.workload_class_abi(cls) == jq.workload_class_abi(cls)


# --- the market, two managers side by side -------------------------------------

class Twin:
    """The JAX manager and the port's over two copies of one node
    directory, the same fake utilization states and the same clock."""

    SIDES = ("jax", "port")

    def __init__(self, tmp_path, tenants, states, **kw):
        self.root = tmp_path
        self.kw = kw
        self.now = NOW
        self.base = {s: str(tmp_path / s) for s in self.SIDES}
        for side in self.SIDES:
            for t in tenants:
                write_tenant(self.base[side], *t[:4], **t[4] if len(t) > 4
                             else {})
        self.util = {s: FakeUtil([copy.copy(st) for st in states])
                     for s in self.SIDES}
        self.m = {}
        self.restart()

    def restart(self) -> None:
        """New managers (a plugin restart); their recover() not yet run."""
        self.m = {side: PACKAGES[side].QuotaMarketManager(
            "node-t", self.base[side], FakeUtil(self.util[side].states),
            clock=lambda: self.now, **self.kw) for side in self.SIDES}
        for side in self.SIDES:
            self.util[side] = self.m[side].util

    def set(self, i: int, **fields) -> None:
        for side in self.SIDES:
            for k, v in fields.items():
                setattr(self.util[side].states[i], k, v)

    def each(self, fn) -> None:
        for side in self.SIDES:
            fn(side, self.m[side], self.base[side])
        self.check()

    def tick(self, now: float) -> None:
        self.now = now
        self.each(lambda side, m, base: m.tick(now=now))

    def recover(self) -> None:
        self.each(lambda side, m, base: m.recover())

    def cfg(self, uid: str, side: str = "port", cont: str = "main"):
        return vc.read_config(os.path.join(self.base[side], f"{uid}_{cont}",
                                           "config", "vtpu.config"))

    def check(self) -> None:
        """Equal configs, ledgers, counters and annotations; both cards
        conserved."""
        files = {}
        for side in self.SIDES:
            root = Path(self.base[side])
            files[side] = {str(p.relative_to(root)): p.read_bytes()
                           for p in sorted(root.rglob("*"))
                           if p.is_file() and not p.name.endswith(".flock")}
        assert files["jax"] == files["port"]
        counters = [(m.grants_total, m.revokes_total, m.expiries_total,
                     m.rewrites_total) for m in self.m.values()]
        assert counters[0] == counters[1]
        anns = [m.encode_annotation(self.now) for m in self.m.values()]
        assert anns[0] == anns[1]
        sums = [PACKAGES[s].sum_effective_by_chip(self.base[s])
                for s in self.SIDES]
        assert sums[0] == sums[1]
        assert all(v <= 100 for v in sums[1].values()), sums


def pair(tmp_path, lender_reclaim=35.0, borrower_wait=0.6, **kw) -> Twin:
    """`tests/test_quota.py:market_pair`: one card, a throughput lender at
    60 % and a latency-critical borrower at 40 %."""
    return Twin(tmp_path,
                [("train", TP, 60), ("infer", LAT, 40)],
                [FakeState("train", "main", 0, 20.0, 1.0, 0.0,
                           lender_reclaim),
                 FakeState("infer", "main", 0, 39.0, 1.0, borrower_wait,
                           0.0)],
                **kw)


def _grant_moves_quota(tmp_path):
    t = pair(tmp_path)
    t.tick(10.0)
    assert t.cfg("infer").devices[0].lease_core == 10
    assert t.cfg("train").devices[0].lease_core == -10
    assert t.cfg("infer").quota_epoch == t.cfg("train").quota_epoch == 1
    assert pq.sum_effective_by_chip(t.base["port"])[0] == 100


def _no_grant_without_stall(tmp_path):
    t = pair(tmp_path, borrower_wait=0.05)
    t.tick(10.0)
    assert t.m["port"].grants_total == 0


def _no_grant_from_stale_lender(tmp_path):
    t = pair(tmp_path)
    t.set(0, _conf=0.0)
    t.tick(10.0)
    assert t.m["port"].grants_total == 0


def _unclassified_never_participate(tmp_path):
    t = Twin(tmp_path, [("plain", NONE, 60), ("infer", LAT, 40)],
             [FakeState("plain", "main", 0, 5.0, 0.0, 0.0, 50.0),
              FakeState("infer", "main", 0, 39.0, 1.0, 0.9, 0.0)])
    t.tick(10.0)
    assert t.m["port"].grants_total == 0


def _unthrottled_borrower_gets_nothing(tmp_path):
    t = Twin(tmp_path, [("train", TP, 60),
                        ("free", LAT, 0, 0,
                         {"core_limit": jvc.CORE_LIMIT_NONE})],
             [FakeState("train", "main", 0, 10.0, 0.0, 0.0, 40.0),
              FakeState("free", "main", 0, 50.0, 1.0, 0.9, 0.0)])
    t.tick(10.0)
    assert t.m["port"].grants_total == 0


def _bounded_by_max_borrow(tmp_path):
    t = pair(tmp_path, lender_reclaim=60.0, max_borrow_pct=15)
    for now in range(1, 6):
        t.tick(float(now))
    assert t.cfg("infer").devices[0].lease_core <= 15


def _revoke_on_demand_and_cooldown(tmp_path):
    t = pair(tmp_path)
    t.tick(1.0)
    assert t.m["port"].grants_total == 1
    t.set(0, used_ewma=50.0, _reclaim=5.0)
    t.tick(2.0)
    assert t.m["port"].revokes_total == 1
    assert t.cfg("infer").devices[0].lease_core == 0
    assert t.cfg("train").devices[0].lease_core == 0
    t.set(0, used_ewma=20.0, _reclaim=35.0)
    t.tick(3.0)
    assert t.m["port"].grants_total == 1
    t.tick(3.0 + t.m["port"].cooldown_s + 1.0)
    assert t.m["port"].grants_total == 2


def _revoke_on_stale_signal(tmp_path):
    t = pair(tmp_path)
    t.tick(1.0)
    t.set(0, _conf=0.1)
    t.tick(2.0)
    assert t.m["port"].revokes_total == 1
    assert t.cfg("infer").devices[0].lease_core == 0


def _expiry_converges(tmp_path):
    t = pair(tmp_path, lease_ttl_s=5.0)
    t.tick(1.0)
    assert t.cfg("infer").devices[0].lease_core == 10
    t.set(1, wait_frac=0.0)
    t.tick(20.0)
    assert t.m["port"].expiries_total == 1
    assert t.cfg("infer").devices[0].lease_core == 0
    assert all(l["state"] == pq.STATE_EXPIRED
               for l in t.m["port"].ledger.leases())


def _party_gone_revokes(tmp_path):
    t = pair(tmp_path)
    t.tick(1.0)
    for side in t.SIDES:
        shutil.rmtree(os.path.join(t.base[side], "infer_main"))
    t.tick(2.0)
    assert t.m["port"].revokes_total == 1
    assert t.cfg("train").devices[0].lease_core == 0


def _oversubscribed_ledger_defense(tmp_path):
    t = pair(tmp_path)
    t.each(lambda side, m, base: m.ledger.grant(
        0, "train/main", "infer/main", 90, 300.0, now=1.0))
    t.tick(2.0)
    assert all(l["state"] != pq.STATE_GRANTED
               for l in t.m["port"].ledger.leases() if l["pct"] == 90)


def _restart_revokes_carried_leases(tmp_path):
    t = pair(tmp_path)
    t.tick(1.0)
    assert t.cfg("infer").devices[0].lease_core == 10
    t.restart()
    t.recover()
    assert t.cfg("infer").devices[0].lease_core == 0
    assert all(l["state"] in (pq.STATE_REVOKED, pq.STATE_EXPIRED)
               for l in t.m["port"].ledger.leases())


def _torn_ledger_reconciles_to_base(tmp_path):
    t = pair(tmp_path)
    t.tick(1.0)
    for side in t.SIDES:
        with open(t.m[side].ledger.path, "w") as f:
            f.write("{torn")
    t.set(1, wait_frac=0.0)
    t.tick(2.0)
    assert t.cfg("infer").devices[0].lease_core == 0
    assert t.cfg("train").devices[0].lease_core == 0


def _annotation_roundtrip(tmp_path):
    t = pair(tmp_path)
    t.tick(1.0)
    for side in t.SIDES:
        assert PACKAGES[side].parse_lease_summary(
            t.m["port"].encode_annotation(1.0), now=2.0) == \
            {0: {"lent_core_pct": 10, "leases": 1}}


MARKET_CASES = {f.__name__.lstrip("_"): f for f in (
    _grant_moves_quota, _no_grant_without_stall, _no_grant_from_stale_lender,
    _unclassified_never_participate, _unthrottled_borrower_gets_nothing,
    _bounded_by_max_borrow, _revoke_on_demand_and_cooldown,
    _revoke_on_stale_signal, _expiry_converges, _party_gone_revokes,
    _oversubscribed_ledger_defense, _restart_revokes_carried_leases,
    _torn_ledger_reconciles_to_base, _annotation_roundtrip)}


@pytest.mark.parametrize("case", sorted(MARKET_CASES))
def test_each_jax_market_case_runs_alike(tmp_path, case):
    """`tests/test_quota.py::TestMarket`, case by case, through both
    managers: the JAX case's own verdicts on the port, and after every
    pass equal configs, ledgers, counters and annotations."""
    MARKET_CASES[case](tmp_path)


@pytest.mark.parametrize("seed", range(4))
def test_a_random_walk_of_passes_runs_alike(tmp_path, seed):
    """Fifty passes: tenants arrive and leave, their used share, wait and
    confidence move; the two managers stay equal and no card is ever
    over 100 % in either."""
    rng = np.random.default_rng(seed)
    n_chips = int(rng.integers(1, 3))
    twin = Twin(tmp_path, [("t0", TP, 40), ("t1", LAT, 30)],
                [FakeState("t0", "main", 0, 0.0, 0.0, 0.0, 0.0),
                 FakeState("t1", "main", 0, 0.0, 0.0, 0.0, 0.0)])
    free = {c: 100 for c in range(n_chips)}
    free[0] -= 70
    live: dict[str, tuple[int, int]] = {"t0": (0, 40), "t1": (0, 30)}
    serial = 2
    now = NOW
    for _ in range(50):
        now += float(rng.uniform(2.0, 8.0))
        if (len(live) < 5 and rng.random() < 0.3) or len(live) < 2:
            chip = int(rng.integers(0, n_chips))
            hard = int(rng.choice([10, 20, 30, 40]))
            if hard <= free[chip]:
                uid = f"t{serial}"
                serial += 1
                cls = int(rng.choice([TP, LAT, TP, LAT, NONE]))
                free[chip] -= hard
                live[uid] = (chip, hard)
                for side in twin.SIDES:
                    write_tenant(twin.base[side], uid, cls, hard, chip=chip)
                    twin.util[side].states.append(FakeState(
                        uid, "main", chip, 0.0, 0.0, 0.0, 0.0))
        elif live and rng.random() < 0.15:
            uid = str(rng.choice(sorted(live)))
            chip, hard = live.pop(uid)
            free[chip] += hard
            for side in twin.SIDES:
                shutil.rmtree(os.path.join(twin.base[side], f"{uid}_main"))
                twin.util[side].states = [s for s in twin.util[side].states
                                          if s.pod_uid != uid]
        for i, st in enumerate(twin.util["port"].states):
            hard = live[st.pod_uid][1]
            used = float(rng.uniform(0, hard + 10) if rng.random() < 0.3
                         else rng.uniform(0, hard / 3))
            twin.set(i, used_ewma=used, used_var=float(rng.uniform(0, 9)),
                     wait_frac=float(rng.uniform(0, 0.9)),
                     _reclaim=max(0.0, hard - used - float(rng.uniform(0, 5))),
                     _conf=float(rng.choice([0.0, 0.2, 0.8, 1.0, 1.0])))
        twin.tick(now)
    assert twin.m["port"].grants_total > 0
    assert twin.m["port"].revokes_total + \
        twin.m["port"].expiries_total > 0


def test_the_audit_records_one_trace_event_per_party(tmp_path):
    """Each grant, revoke and expiry is a `quota.<op>` event in both
    parties' timelines, as the JAX manager records it."""
    spans = {}
    for side, tr in (("jax", jtrace), ("port", ptrace)):
        spool = tmp_path / f"spool-{side}"
        tr.configure("plugin", spool_dir=str(spool), sampling_rate=1.0,
                     flush_interval_s=3600.0)
        twin = pair(tmp_path / f"node-{side}", lease_ttl_s=5.0)
        m, util = twin.m[side], twin.util[side]
        m.tick(now=1.0)                     # a grant
        util.states[0]._conf = 0.0
        m.tick(now=2.0)                     # a revoke (stale signal)
        util.states[0]._conf = 1.0
        m.tick(now=2.0 + m.cooldown_s + 1)  # a grant again
        util.states[1].wait_frac = 0.0
        m.tick(now=40.0)                    # its expiry
        tr.flush()
        tr.reset()
        rows = []
        for f in sorted(os.listdir(spool)):
            if f.endswith(".jsonl"):
                with open(spool / f) as fh:
                    rows += [json.loads(l) for l in fh if l.strip()]
        spans[side] = sorted(
            (r["stage"], r["pod"], r["trace"], r["service"], r["dur"],
             json.dumps(r["attrs"], sort_keys=True))
            for r in rows if r["kind"] == "span"
            and r["stage"].startswith("quota."))
    assert spans["jax"] == spans["port"]
    ops = [s[0] for s in spans["port"]]
    assert ops.count("quota.grant") == 4 and ops.count("quota.revoke") == 2
    assert ops.count("quota.expire") == 2
    roles = {(s[0], s[1], json.loads(s[5])["role"]) for s in spans["port"]}
    assert ("quota.grant", "train", "lender") in roles
    assert ("quota.grant", "infer", "borrower") in roles


# --- chaos: crashes, torn ledgers, restarts -------------------------------------

def _chaos(pkg, fp, crash, base: str, seed: int) -> None:
    """`tests/test_quota.py::TestReclaimChaos` with one package's manager
    and failpoints: the invariant after every round, convergence to the
    base rates at the end."""
    rng = Random(seed)
    n_chips = rng.randint(1, 2)
    tenants = []
    free = {c: 100 for c in range(n_chips)}
    for i in range(rng.randint(2, 4)):
        chip = rng.randrange(n_chips)
        cls = rng.choice([TP, LAT, NONE])
        hard = min(rng.choice([20, 30, 40]), free[chip])
        if hard < 10:
            continue
        free[chip] -= hard
        write_tenant(base, f"t{i}", cls, hard, chip=chip)
        reclaim = rng.uniform(5, hard - 5) if cls == TP else 0.0
        wait = rng.uniform(0.3, 0.9) if cls == LAT else 0.0
        tenants.append(FakeState(f"t{i}", "main", chip,
                                 rng.uniform(5, 15), 1.0, wait, reclaim))
    m = pkg.QuotaMarketManager("chaos", base, FakeUtil(tenants),
                               lease_ttl_s=rng.uniform(5.0, 20.0))
    fp.enable(seed=seed)
    fp.arm("quota.lease", rng.choice(["crash", "partial-write", "error"]),
           p=0.5, count=rng.randint(1, 3))
    fp.arm("quota.revoke", rng.choice(["crash", "partial-write"]),
           p=0.5, count=rng.randint(1, 2))
    now = 0.0
    for _ in range(12):
        now += rng.uniform(2.0, 8.0)
        if rng.random() < 0.3:
            for s in tenants:
                if s._reclaim:
                    s.used_ewma = rng.uniform(25, 60)
                    s._reclaim = rng.uniform(0, 4)
        try:
            m.tick(now=now)
        except crash:
            m = pkg.QuotaMarketManager("chaos", base, FakeUtil(tenants),
                                       lease_ttl_s=10.0)
            try:
                m.recover()
            except crash:
                m = pkg.QuotaMarketManager("chaos", base, FakeUtil(tenants),
                                           lease_ttl_s=10.0)
            except Exception:  # noqa: BLE001 - an injected error
                pass
        except Exception:  # noqa: BLE001 - an injected error: next pass
            pass
        sums = pkg.sum_effective_by_chip(base)
        assert all(v <= 100 for v in sums.values()), (seed, sums)
    fp.disable()
    for s in tenants:
        s._reclaim, s.wait_frac, s._conf = 0.0, 0.0, 0.0
    m2 = pkg.QuotaMarketManager("chaos", base, FakeUtil(tenants))
    m2.recover()
    m2.tick(now=now + 100.0)
    for lease in m2.ledger.leases():
        assert lease["state"] in (pkg.STATE_REVOKED, pkg.STATE_EXPIRED), \
            (seed, lease)
    for entry in os.listdir(base):
        path = os.path.join(base, entry, "config", "vtpu.config")
        if os.path.exists(path):
            assert all(d.lease_core == 0
                       for d in vc.read_config(path).devices), (seed, entry)


@pytest.mark.parametrize("seed", range(12))
def test_chaos_converges_to_base_rates_in_both(tmp_path, seed):
    _chaos(jq, jfp, jfp.CrashFailpoint, str(tmp_path / "jax"), seed)
    _chaos(pq, pfp, pfp.CrashFailpoint, str(tmp_path / "port"), seed)


def test_the_ports_failpoints_fire_at_the_markets_sites(tmp_path):
    t = pair(tmp_path)
    pfp.enable(seed=0)
    pfp.arm("quota.lease", "error")
    with pytest.raises(Exception):
        t.m["port"].tick(now=1.0)
    # granted in the ledger, in no config: the restart rule converges it
    assert t.m["port"].ledger.active(now=1.0)
    assert t.cfg("infer").devices[0].lease_core == 0
    pfp.disarm("quota.lease")
    pfp.arm("quota.revoke", "crash")
    m = pq.QuotaMarketManager("node-t", t.base["port"], t.util["port"],
                              clock=lambda: 2.0)
    with pytest.raises(pfp.CrashFailpoint):
        m.recover()
    assert any(k.startswith("quota.revoke") for k in pfp.stats()["fires"])
    pfp.disable()
    pq.QuotaMarketManager("node-t", t.base["port"], t.util["port"],
                          clock=lambda: 3.0).recover()
    assert t.cfg("infer").devices[0].lease_core == 0
    assert not t.m["port"].ledger.active(now=3.0)


def test_a_failed_pass_is_logged_and_counted(tmp_path, caplog):
    t = pair(tmp_path)
    m = t.m["port"]
    pfp.enable(seed=0)
    pfp.arm("quota.lease", "error")
    assert m.run_pass() is False
    assert (m.passes_total, m.failed_passes_total) == (1, 1)
    assert "quota market pass failed" in caplog.text
    pfp.disable()
    assert m.run_pass() is True
    assert (m.passes_total, m.failed_passes_total) == (2, 1)


# --- the victim costs ------------------------------------------------------------

def _victim_node(tmp_path, now: float = NOW) -> tuple[str, str]:
    """Three tenants, one ledger with a lease active at `now`, a revoked
    and a lapsed one, and a memory ledger with resident and spilled
    bytes."""
    base = str(tmp_path / "mgr")
    for uid, cont, cls, hard in (("uid-aaaaaaaaaaaaaaaa", "main", TP, 50),
                                 ("uid-b", "main", LAT, 25),
                                 ("uid-c", "side", NONE, 20)):
        write_tenant(base, uid, cls, hard, cont=cont)
    led = pledger.QuotaLeaseLedger(base)
    led.grant(0, "uid-aaaaaaaaaaaaaaaa/main", "uid-b/main", 10, 300.0,
              now=now - 5)
    gone, _ = led.grant(0, "uid-aaaaaaaaaaaaaaaa/main", "uid-c/side", 5,
                        300.0, now=now - 5)
    led.settle([gone["id"]], pq.STATE_REVOKED, now=now - 1)
    led.grant(0, "uid-b/main", "uid-c/side", 5, 1.0, now=now - 10)
    vmem_path = str(tmp_path / "vmem.config")
    ledger = jvmem.VmemLedger(vmem_path, create=True)
    pid = os.getpid()
    ledger.record(pid, 0, 3 << 30,
                  owner_token=jvmem.fnv64("uid-aaaaaaaaaaaaaaaa/main"))
    ledger.record_spilled(pid, 0, 1 << 30,
                          owner_token=jvmem.fnv64("uid-aaaaaaaaaaaaaaaa/main"))
    ledger.record(pid, 1, 1 << 30, owner_token=jvmem.fnv64("uid-c/side"))
    ledger.record_spilled(pid, 1, 3 << 30,
                          owner_token=jvmem.fnv64("uid-c/side"))
    ledger.close()
    return base, vmem_path


@pytest.mark.parametrize("leases", [True, False], ids=["leases", "no_leases"])
@pytest.mark.parametrize("spill", [True, False], ids=["spill", "no_spill"])
def test_victim_costs_collect_alike(tmp_path, leases, spill):
    base, vmem_path = _victim_node(tmp_path)
    mine = pvictim.collect_victim_costs(base, vmem_path=vmem_path,
                                        include_leases=leases,
                                        include_spill=spill, now=NOW)
    theirs = jvictim.collect_victim_costs(base, vmem_path=vmem_path,
                                          include_leases=leases,
                                          include_spill=spill, now=NOW)
    assert _costs(mine) == _costs(theirs)
    assert mine.encode() == theirs.encode()
    if leases:
        assert mine.lookup("uid-b")[0] is True
        assert mine.lookup("uid-c") is None or mine.lookup("uid-c")[0] is \
            False
    if spill:
        assert mine.lookup("uid-c")[1] == pytest.approx(0.75)
        assert mine.lookup("uid-aaaaaaaaaaaaaaaa")[1] == pytest.approx(0.25)
    # a broken source costs its column only
    broken = pvictim.collect_victim_costs(
        base, vmem_path=str(tmp_path / "no" / "vmem"), include_leases=leases,
        include_spill=spill, now=NOW)
    assert all(frac == 0.0 for _, frac in broken.tenants.values())


def test_the_publishers_annotations_decode_alike_in_the_jax_codec(tmp_path):
    """The annotation the port's publisher and market patch decodes with
    the JAX `parse_victim_costs` and `parse_lease_summary` to what the
    JAX publisher's and market's do over the same ledgers."""
    base, vmem_path = _victim_node(tmp_path, now=time.time())
    anns = {}
    for side, mod, client in (("port", pvictim, FakeKubeClient()),
                              ("jax", jvictim, JaxFakeKubeClient())):
        client.add_node({"metadata": {"name": "n1", "annotations": {}}})
        mod.VictimCostPublisher(client, "n1", base,
                                vmem_path=vmem_path).publish_once()
        anns[side] = client.get_node("n1")["metadata"]["annotations"][
            consts.node_victim_cost_annotation()]
    decoded = {s: jvictim.parse_victim_costs(a) for s, a in anns.items()}
    assert decoded["port"] is not None
    assert decoded["port"].tenants == decoded["jax"].tenants
    assert decoded["port"].lookup("uid-b") == (True, 0.0)
    t = pair(tmp_path / "market")
    t.tick(time.time())
    clients = {"port": FakeKubeClient(), "jax": JaxFakeKubeClient()}
    for side, client in clients.items():
        client.add_node({"metadata": {"name": "node-t", "annotations": {}}})
        t.m[side].client = client
        t.m[side]._publish(t.now)
    raw = {s: c.get_node("node-t")["metadata"]["annotations"][
        consts.node_quota_lease_annotation()] for s, c in clients.items()}
    assert jq.parse_lease_summary(raw["port"]) == \
        jq.parse_lease_summary(raw["jax"]) == \
        {0: {"lent_core_pct": 10, "leases": 1}}


# --- the rollup's lease fold and vtpu-smi ------------------------------------------

def _leases_on(node_base: str, now: float) -> None:
    """The port market's ledger on the node: an active lease uid-a ->
    uid-b on card 0, a second one to uid-b's other card's row, a revoked
    one and a lapsed one."""
    led = pledger.QuotaLeaseLedger(node_base)
    led.grant(0, "uid-a/main", "uid-b/main", 10, 300.0, now=now)
    led.grant(0, "uid-a/main", "uid-b/main", 5, 300.0, now=now)
    gone, _ = led.grant(1, "uid-d/main", "uid-b/main", 5, 300.0, now=now)
    led.settle([gone["id"]], pq.STATE_REVOKED, now=now)
    led.grant(1, "uid-d/main", "uid-b/main", 5, 1.0, now=now - 10)


@pytest.mark.parametrize("quota", [True, False], ids=["quota", "off"])
@pytest.mark.parametrize("with_client", [True, False],
                         ids=["cluster", "local"])
def test_rollup_with_the_lease_fold_agrees(tmp_path, frozen, quota,
                                           with_client):
    node = tu.Node(tmp_path, 5, True)
    try:
        clients = (FakeKubeClient(), JaxFakeKubeClient())
        specs = [tu.ChipSpec(uuid=f"GPU-{i}", index=i,
                             chip_type="nvidia-h100-sxm", memory=80 * tu.GIB,
                             split_count=4) for i in range(2)]
        for c in clients:
            tu._cluster(c, node, specs, tu.NOW)
            c.patch_node_annotations("n2", {
                consts.node_quota_lease_annotation():
                    f"0:15:2;1:5:1@{tu.NOW}"})
        _leases_on(node.base, frozen["wall"])
        gates = {"quota_dir": node.base} if quota else {}
        mine, theirs = tu.rollups(node, tmp_path,
                                  clients if with_client else (None, None),
                                  **gates)
        for _ in range(2):
            node.append()
            frozen["wall"] += 2.0
            frozen["mono"] += 2.0
            a = mine.collect(now=frozen["wall"])
            b = theirs.collect(now=frozen["wall"])
            for doc in (a, b):
                doc["node"].pop("last_fold_s")
            tu.assert_close(a, b)
        assert ("quota" in a) == quota
        if quota:
            assert a["quota"]["leases_active"] == 2
            assert a["quota"]["lent_core_pct_total"] == 15
            rows = {(t["pod_uid"], t["chip_index"]): t for t in a["tenants"]}
            assert rows[("uid-b", 0)]["borrowed_core_pct"] == 15
            assert rows[("uid-a", 0)]["lent_core_pct"] == 15
            if with_client:
                n2 = next(n for n in a["nodes"] if n["node"] == "n2")
                assert (n2["quota_lent_core_pct"], n2["quota_leases"]) == \
                    (20, 3)
        else:
            assert not any("lent_core_pct" in t or "borrowed_core_pct" in t
                           for t in a["tenants"])
            assert all("_quota_lease_raw" not in n for n in a["nodes"])
        for cut in ({"node": tu.NODE}, {"pod": "uid-b"}, {}):
            assert tu.roll.filter_document(a, **cut) == \
                tu.jroll.filter_document(a, **cut)
    finally:
        node.close()


def test_the_jax_fold_reads_the_ports_ledger_as_its_own(tmp_path):
    """The JAX rollup's `_fold_quota_leases` over the lease ledger the
    port's market wrote gives the port rollup's quota block."""
    from vtpu_manager.utilization.ledger import UtilizationLedger as JLedger
    from vtpu_manager.utilization.rollup import ClusterRollup as JRollup
    from vtpu_manager_torch.utilization.rollup import ClusterRollup
    t = pair(tmp_path)
    now = time.time()
    t.tick(now)
    base = t.base["port"]
    rows = [{"pod_uid": "infer", "container": "main", "chip_index": 0,
             "used_core_pct": 47.0, "allocated_core_pct": 40},
            {"pod_uid": "train", "container": "main", "chip_index": 0,
             "used_core_pct": 12.0, "allocated_core_pct": 60}]
    chips = [SimpleNamespace(index=0, uuid="TPU-0")]
    folds = []
    for roll, led in ((ClusterRollup, UtilizationLedger),
                      (JRollup, JLedger)):
        r = roll(led("node-t", chips, base_dir=base), quota_dir=base)
        tenant_rows = copy.deepcopy(rows)
        folds.append((r._fold_quota_leases(tenant_rows, [], now),
                      tenant_rows))
    assert folds[0] == folds[1]
    block, tenant_rows = folds[0]
    assert block["leases_active"] == 1 and block["epoch"] == 1
    assert block["borrowed_used"][0]["used_of_borrowed_pct"] == 7.0
    assert tenant_rows[0]["borrowed_core_pct"] == 10
    assert tenant_rows[1]["lent_core_pct"] == 10


def test_vtpu_smi_renders_lent_and_borrowed_as_the_jax_script(tmp_path,
                                                               frozen):
    node = tu.Node(tmp_path, 8, True)
    try:
        clients = (FakeKubeClient(), JaxFakeKubeClient())
        specs = [tu.ChipSpec(uuid=f"GPU-{i}", index=i, memory=80 * tu.GIB,
                             split_count=4) for i in range(2)]
        tu._cluster(clients[0], node, specs, tu.NOW)
        _leases_on(node.base, frozen["wall"])
        mine, _ = tu.rollups(node, tmp_path, clients, quota_dir=node.base)
        node.append()
        doc = json.loads(json.dumps(mine.collect(now=frozen["wall"])))
    finally:
        node.close()
    texts = []
    for render in (vtpu_smi.render, tu._jax_smi().render):
        out = io.StringIO()
        render(doc, out=out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert "market: 2 lease(s)" in texts[0]
    assert "lent" in texts[0] and "borrow" in texts[0]


# --- the commands -----------------------------------------------------------------

def _chips():
    return [SimpleNamespace(index=0, uuid="TPU-0")]


def test_start_market_recovers_before_its_first_pass_and_stops(tmp_path):
    t = pair(tmp_path)
    t.tick(time.time())
    base = t.base["port"]
    assert t.cfg("infer").devices[0].lease_core == 10
    client = FakeKubeClient(upsert_on_patch=True)
    market = dp.start_market(client, "node-t", _chips(), base,
                             str(tmp_path / "no-feed"))
    try:
        # the carried lease is revoked and the configs back at base before
        # any pass has run
        assert market.passes_total == 0
        assert t.cfg("infer").devices[0].lease_core == 0
        assert t.cfg("train").devices[0].lease_core == 0
        assert all(l["state"] == pq.STATE_REVOKED
                   for l in market.ledger.leases())
        assert market.interval_s == 5.0 and market.lease_ttl_s == 30.0
        assert market.grant_step_pct == 10 and market.max_borrow_pct == 40
        assert isinstance(market.util, UtilizationLedger)
    finally:
        market.stop()
    market._thread.join(timeout=10)
    assert not market._thread.is_alive()


def _run_plugin(tmp_path, gates: str) -> str:
    proc = subprocess.Popen(
        ENTRY + private_flags(tmp_path) + [
            "--fake-chips", "1", "--fake-client", "--feature-gates", gates],
        cwd=tdm.REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    out = []
    deadline = time.monotonic() + 60
    try:
        for line in proc.stdout:
            out.append(line)
            if "device plugin running" in line:
                break
            assert time.monotonic() < deadline, "".join(out)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=30)
        out.append(rest)
        assert proc.returncode == 0, "".join(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return "".join(out)


@pytest.mark.parametrize("gates,market,victims", [
    ("QuotaMarket=true", True, "leases=True spill=False"),
    ("HBMOvercommit=true", False, "leases=False spill=True"),
    ("QuotaMarket=true,HBMOvercommit=true", True, "leases=True spill=True"),
    ("UtilizationLedger=true", False, None)],
    ids=["market", "overcommit", "both", "neither"])
def test_the_plugin_starts_the_market_and_the_victim_costs(tmp_path, gates,
                                                           market, victims):
    log = _run_plugin(tmp_path, gates)
    assert ("quota market manager running" in log) == market, log
    assert "quota-market manager is not ported" not in log
    if victims is None:
        assert "victim-cost publisher running" not in log, log
    else:
        assert f"victim-cost publisher running ({victims})" in log, log


@pytest.mark.parametrize("quota", [True, False], ids=["quota", "off"])
def test_the_exporter_takes_the_gate(tmp_path, quota):
    tdm.node_dir(tmp_path)
    led = pledger.QuotaLeaseLedger(str(tmp_path / "mgr"))
    led.grant(0, "a/main", "b/main", 10, 3600.0)
    token = tmp_path / "token"
    token.write_text(tdm.TOKEN + "\n")
    gates = "UtilizationLedger=true" + (",QuotaMarket=true" if quota else "")
    exp = tdm.Exporter(tmp_path, "--metrics-token-file", str(token),
                       "--feature-gates", gates, "--fake-client")
    try:
        status, body, _ = exp.get("/utilization", token=tdm.TOKEN)
    finally:
        assert exp.stop() == 0
    assert status == 200, body
    doc = json.loads(body)
    assert ("quota" in doc) == quota
    if quota:
        assert doc["quota"]["leases_active"] == 1
        assert doc["quota"]["leases"][0]["borrower"] == "b/main"


# --- end to end on the fake driver ------------------------------------------------

def _tenant_cfg(base: str, uid: str, cls: int, hard: int) -> str:
    path = os.path.join(base, f"{uid}_main", "config", "vtpu.config")
    vc.write_config(path, vc.VtpuConfig(
        pod_uid=uid, container_name="main", workload_class=cls,
        devices=[vc.DeviceConfig(uuid="GPU-lease-0", total_memory=1 << 30,
                                 real_memory=1 << 30, hard_core=hard,
                                 soft_core=hard,
                                 core_limit=vc.CORE_LIMIT_HARD,
                                 host_index=0)]))
    return path


def _ring_env(base: str, uid: str, **extra) -> dict:
    """The tenant's step ring where the ledger reads it (the directory
    Allocate would mount)."""
    ring = os.path.join(base, f"{uid}_main", consts.TELEMETRY_SUBDIR,
                        consts.STEP_RING_NAME)
    os.makedirs(os.path.dirname(ring), exist_ok=True)
    return {consts.ENV_STEP_TELEMETRY: "true",
            consts.ENV_STEP_RING_PATH: ring, **extra}


def test_the_market_lends_an_idle_lenders_headroom_and_takes_it_back(
        tmp_path):
    """A throughput tenant at hard 60 that takes about 12 % (a 2 ms fake
    kernel, then 14.7 ms idle) and a latency-critical one at hard 40 that
    runs back to back, each under the port's interposer with its step
    ring where the ledger reads it. The port's market, ticked every
    0.4 s over the rings, grants the borrower +20 (effective 60); the
    borrower's interposer adopts it and its paced share rises; the
    lender's surge (back to back, paced at its effective 40) revokes the
    lease, and the share returns to 40. Each stage's share is the
    unmetered step's median (the paired yardstick, timed beside the run)
    over the stage's ms per step, within SHARE_BAND."""
    base = str(tmp_path / "mgr")
    lender_cfg = _tenant_cfg(base, "train", TP, 60)
    borrower_cfg = _tenant_cfg(base, "infer", LAT, 40)
    busy = str(tmp_path / "surge")
    lender = Steps(tmp_path, lender_cfg, "train",
                   **_ring_env(base, "train", SHIM_TEST_IDLE_US=14700,
                               SHIM_TEST_BUSY_FILE=busy))
    borrower = Steps(tmp_path, borrower_cfg, "infer",
                     **_ring_env(base, "infer"))
    market = pq.QuotaMarketManager(
        "node-t", base, UtilizationLedger("node-t", _chips(), base_dir=base),
        grant_step_pct=20, max_borrow_pct=20)
    epochs, sums = [], []

    def tick():
        market.tick()
        epochs.append(vc.read_config(borrower_cfg).quota_epoch)
        sums.append(pq.sum_effective_by_chip(base)[0])
    try:
        for _ in range(3):
            borrower.at(0.4, tick)
        granted_at = next(i for i, e in enumerate(epochs) if e)
        for _ in range(3):
            borrower.at(0.4, tick)
        Path(busy).touch()
        surged = len(borrower.marks)
        for _ in range(6):
            borrower.at(0.4, tick)
            if market.revokes_total:
                break
        revoked_at = len(epochs) - 1
        run = borrower.finish(1.0)
    finally:
        open(lender.stop, "w").close()
        lender.proc.communicate(timeout=60)
    yard = bench_quota.run_fake_harness(
        "--steps", FAKE_EXEC_US=EXEC_US, SHIM_TEST_KERNELS=1,
        SHIM_TEST_ITERS=150)
    t100 = statistics.median(
        int(p[3]) - int(p[2]) for p in (ln.split() for ln in
                                        yard["stdout"].splitlines())
        if p and p[0] == "STEP") / 1e6
    assert (market.grants_total, market.revokes_total) == (1, 1), epochs
    assert all(s <= 100 for s in sums), sums
    assert revoked_at - surged < 3, (epochs, surged)
    lease = market.ledger.leases()[0]
    assert (lease["lender"], lease["borrower"], lease["pct"],
            lease["state"]) == ("train/main", "infer/main", 20,
                                pq.STATE_REVOKED)
    steps, marks = run["steps"], borrower.marks
    grant, rev = marks[granted_at], marks[revoked_at]
    shares = {"base": 100 * t100 / rate(steps, steps[0][0],
                                        borrower.began[granted_at]),
              "granted": 100 * t100 / rate(steps, grant,
                                           borrower.began[revoked_at]),
              "revoked": 100 * t100 / rate(steps, rev, borrower.end)}
    for stage, want in (("base", 40), ("granted", 60), ("revoked", 40)):
        assert abs(shares[stage] - want) <= SHARE_BAND, (shares, t100)
    assert run["vtpu_quota_reloads_total"] == 2, run
    assert run["vtpu_core_limit"] == 40
    assert "quota lease granted on device 0: eff 40% -> 60%" in run["stderr"]
    assert "quota lease revoked on device 0: eff 60% -> 40%" in run["stderr"]


def test_a_time_sliced_borrower_its_bucket_does_not_bind_gets_nothing(
        tmp_path):
    """`test_unthrottled_borrower_gets_nothing`'s rule on the interposer's
    rings. On a card that time-slices in 2 ms slices (FAKE_TIMESLICE_US)
    beside a ledger co-tenant of 12 ms kernels at hard 50, with the node
    watcher on the fake's busy counter (so the interposers see each
    other), a latency-critical tenant at hard 40 that takes about 25 %
    (a 2 ms kernel, then 6 ms idle) spends about
    half of each step off the card, which its ring records as its wait,
    while its bucket never binds. An idle throughput lender at hard 60
    beside it has headroom to lend. The market's ledger reads the
    borrower's wait fraction from its bucket's wait, which the records
    carry apart, so no pass grants it anything."""
    from test_torch_timeslice import BusySampler
    from vtpu_manager_torch.manager.watcher import TcWatcherDaemon
    base = str(tmp_path / "mgr")
    lender_cfg = _tenant_cfg(base, "train", TP, 60)
    borrower_cfg = _tenant_cfg(base, "infer", LAT, 40)
    world = bench_quota.World(str(tmp_path / "node"))
    state = tmp_path / "card.state"
    state.write_bytes(b"\0" * 16)
    fake = str(bench_quota.build.build_fake_driver())
    card = {"FAKE_SHARED_STATE": str(state), "FAKE_TIMESLICE_US": 2000,
            consts.ENV_TC_UTIL_PATH: world.tc_path,
            consts.ENV_VMEM_PATH: world.vmem_path,
            consts.ENV_LOCK_DIR: world.lock_dir}
    watcher = TcWatcherDaemon([0], BusySampler(str(state), fake),
                              tc_path=world.tc_path,
                              vmem_path=world.vmem_path, interval_ms=20)
    watcher.start()
    cotenant = lender = None
    try:
        env = world.env(str(bench_quota.build.build_shim()), "uid-busy",
                        hard_core=50)
        env.update({"SHIM_PATH": env["LD_PRELOAD"],
                    "VTPU_REAL_CUDA_LIBRARY_PATH": fake,
                    "FAKE_EXEC_US": "12000", "SHIM_TEST_ITERS": "400",
                    **{k: str(v) for k, v in card.items()}})
        cotenant = subprocess.Popen(
            [str(bench_quota.build.build_shim_test()), "--throttle-only"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        time.sleep(0.3)
        lender = Steps(tmp_path, lender_cfg, "train",
                       **_ring_env(base, "train", SHIM_TEST_IDLE_US=14700),
                       **card)
        borrower = Steps(tmp_path, borrower_cfg, "infer",
                         **_ring_env(base, "infer", SHIM_TEST_IDLE_US=6000),
                         **card)
        # the market's ledger reads use from the rings (the charged card
        # time): the lender's stays low however the host is loaded
        util = UtilizationLedger("node-t", _chips(), base_dir=base)
        market = pq.QuotaMarketManager("node-t", base, util)
        seen = []
        for _ in range(5):
            time.sleep(0.4)
            market.tick()
            now = time.time()
            seen.append({s.pod_uid: (round(s.wait_frac, 3),
                                     round(s.used_ewma, 1),
                                     round(s.reclaim_core_pct(now), 1))
                         for s in util.tenants()})
        beside = cotenant.poll() is None
        run = borrower.finish(0.0)
    finally:
        if lender is not None:
            open(lender.stop, "w").close()
            lender.proc.communicate(timeout=60)
        if cotenant is not None:
            cotenant.kill()
            cotenant.wait()
        watcher.stop()
    reader = stepring.StepRingReader(
        _ring_env(base, "infer")[consts.ENV_STEP_RING_PATH])
    records, _, _ = reader.poll(0)
    reader.close()
    dur = sum(r.duration_ns for r in records)
    off_card = sum(r.throttle_wait_ns for r in records) / dur
    bucket = sum(r.bucket_wait_ns for r in records) / dur
    # the scenario: sliced (its time off the card would pass the market's
    # threshold), not throttled, beside a lender with headroom to lend
    assert beside and off_card >= 2 * market.wait_frac_threshold, (
        off_card, seen)
    # a record with device time charged since the one before it carries
    # the bucket's wait apart (one with none keeps the bucket's as its wait)
    assert bucket < 0.05 and any(r.flags & stepring.FLAG_BUCKET_WAIT
                                 for r in records), (bucket, seen)
    assert all(s["infer"][0] < market.wait_frac_threshold
               for s in seen[1:]), seen
    # passes at which the lender had quota to lend (`_grant`'s lendable)
    assert sum(s["train"][2] - pmarket.GRANT_HEADROOM_PCT >= 1
               for s in seen[1:]) >= 2, seen
    assert market.grants_total == 0 and not market.ledger.leases(), seen
    assert vc.read_config(borrower_cfg).devices[0].lease_core == 0
    assert run["vtpu_quota_reloads_total"] == 0, run


# --- the card check's judging, on synthetic records -------------------------------

def _synthetic_market(yard_ms: float = 1.6, speed: float = 1.0,
                      slow: tuple[int, int] = (0, 0),
                      unthrottled: tuple[int, int] = (0, 0)) -> dict:
    """What `bench_quota_lease.Phase.check_market` records on a card that
    does what the market asks: passes every 5 s, grants of 10, 20 and 10
    (pod-infer at 50, 70, 80), pod-train's surge after the third and the
    revoke at the next pass; pod-infer's steps paced at its effective
    quota, the rest of each step its bucket's wait (`speed` scales its
    step rate; steps that begin inside `slow`, ms, take twice as long;
    those inside `unthrottled` wait nothing in the bucket)."""
    from vtpu_manager_torch import bench_quota_lease as bl
    ms = 10**6
    infer_key, train_key = "uid-pod-infer/main", "uid-pod-train/main"
    plan = [(5000, 10, 50), (10000, 30, 70), (15000, 40, 80),
            (25000, 0, 40)]
    steps, ring, t, charged, wait = [], [], 0, 0, 0
    epoch_at = [(0, 0)] + [(at, i + 1) for i, (at, _, _) in enumerate(plan)]
    while t < 30000 * ms:
        eff = next((e for at, _, e in reversed(plan) if t >= at * ms), 40)
        epoch = next((e for at, e in reversed(epoch_at) if t >= at * ms), 0)
        dur = int(yard_ms * ms * 100 / eff / speed
                  * (2 if slow[0] * ms <= t < slow[1] * ms else 1))
        charged += int(yard_ms * ms)
        bucket = (0 if unthrottled[0] * ms <= t < unthrottled[1] * ms
                  else dur - int(yard_ms * ms))
        wait += bucket
        ring.append((t, dur, bucket))
        steps.append((t, t + dur, wait, 0, charged, epoch))
        t += dur
    train = [(i * 12 * ms, i * 12 * ms + 2 * ms, 0, i * 12 * ms > 20000 * ms)
             for i in range(2000)]
    states, leases = [], []
    for n, (at, lease, eff) in enumerate(plan, start=1):
        if lease:
            leases.append({"id": f"q{n}-0-{n - 1}", "lender": train_key,
                           "borrower": infer_key, "pct": lease - sum(
                               l["pct"] for l in leases),
                           "state": "granted"})
        else:
            for l in leases:
                l["state"] = "revoked"
        cfg = {"epoch": n, "effective": eff, "renamed_ns": at * ms}
        states.append({
            "now": NOW + at / 1e3, "mono_ns": at * ms, "passes": n,
            "fold_wall": NOW + at / 1e3,
            "failed_passes": 0,
            "configs": {bl.INFER_POD: {**cfg, "lease": lease},
                        bl.TRAIN_POD: {**cfg, "lease": -lease,
                                       "effective": 60 - lease}},
            "epoch": n, "deltas": ({infer_key: lease, train_key: -lease}
                                   if lease else {}),
            "leases": [dict(l) for l in leases],
            "active": sum(1 for l in leases if l["state"] == "granted"),
            "sum_effective": {0: 100}, "annotation": "",
            "annotation_ok": True, "util": {}})
    spans = [{"stage": "quota.grant", "attrs": {"role": "x"}},
             {"stage": "quota.revoke", "attrs": {"why": "lender-demand"}}]
    return dict(
        runs={bl.INFER_POD: {"steps": steps, "ring": ring, "rc": 0,
                             "vtpu_quota_reloads_total": 4,
                             "vtpu_core_limit": 40,
                             "attn_block_launches": len(steps)},
              bl.TRAIN_POD: {"steps": train, "rc": 0}},
        states=states,
        published=[{"raw": f"uid-pod-infer:l:0.000@{NOW}", "leased": True,
                    "after_revoke": False},
                   {"raw": f"@{NOW}", "leased": False,
                    "after_revoke": True}],
        docs=[(200, json.dumps({"quota": {"leases_active": 1}, "tenants": [
            {"pod_uid": "uid-pod-infer", "borrowed_core_pct": 10}]}))],
        marks={"surge": {"pass": 3, "mono_ns": 17500 * ms},
               "revoke": {"pass": 4, "mono_ns": 25000 * ms},
               "mono_minus_wall_ns": -int(NOW * 1e9),
               "wait_frac_threshold": 0.2, "plugin_rc": 0,
               "plugin_started": True, "failed_passes": 0},
        end_ns=30000 * ms,
        lease_stages=[{"effective": 100, "n": 50,
                       "charged_ms_per_step": yard_ms}],
        timelines={"uid-pod-infer": spans, "uid-pod-train": spans},
        uids={bl.TRAIN_POD: "uid-pod-train", bl.INFER_POD: "uid-pod-infer"},
        parse_victim_costs=lambda raw: pvictim.parse_victim_costs(raw,
                                                                  now=NOW))


def test_the_market_check_passes_a_card_that_does_what_it_is_told():
    from vtpu_manager_torch import bench_quota_lease as bl
    rec = bl.judge_market_run(**_synthetic_market())
    assert rec["ok"], rec
    assert [round(s["share"], 3) for s in rec["stages"]] == [40, 50, 70, 80,
                                                             80, 40]
    assert [s["surge"] for s in rec["stages"]] == [False] * 4 + [True,
                                                               False]
    assert rec["revoke_passes"] == 1 and rec["surge_to_revoke_s"] == 7.5
    assert rec["report"]["train_retention"] == pytest.approx(1.0, abs=0.01)
    assert rec["adoption_ms"][0] is not None
    # each grant's pass read the bucket's wait of the stage before it
    assert [(g["pass"], round(g["bucket_wait"], 2))
            for g in rec["grants"]] == [(1, 0.6), (2, 0.5), (3, 0.3)]


def test_the_market_check_reports_the_surge_and_judges_the_rest():
    """A borrower slowed only between the lender's surge and the revoke
    (the card's quotas sum to 100 and both contexts slice it) passes, the
    surge stretch reported; slowed before the surge, it fails."""
    from vtpu_manager_torch import bench_quota_lease as bl
    for lo, ok in ((17600, True), (13000, False)):
        out = bl.judge_market_run(**_synthetic_market(slow=(lo, 25000)))
        assert out["ok"] is ok, out["stages"]


@pytest.mark.parametrize("fault", [
    "over_100", "slow_steps", "stale_why", "no_reload", "marked_after",
    "late_revoke", "third_party", "torn_epoch", "no_revoke_event",
    "unthrottled_grant", "unadopted", "plugin_failed_pass"])
def test_the_market_check_fails_each_fault(fault):
    from vtpu_manager_torch import bench_quota_lease as bl
    rec = _synthetic_market(
        speed=0.6 if fault == "slow_steps" else 1.0,
        # pod-infer's bucket stops binding before the third grant
        unthrottled=(10000, 15000) if fault == "unthrottled_grant"
        else (0, 0))
    st = rec["states"]
    if fault == "over_100":
        st[1]["sum_effective"] = {0: 110}
    elif fault == "stale_why":
        rec["timelines"]["uid-pod-infer"][1] = {
            "stage": "quota.revoke", "attrs": {"why": "stale-signal"}}
    elif fault == "no_reload":
        rec["runs"][bl.INFER_POD]["vtpu_quota_reloads_total"] = 3
    elif fault == "marked_after":
        rec["published"][1]["raw"] = f"uid-pod-infer:l:0.000@{NOW}"
    elif fault == "late_revoke":
        rec["marks"]["revoke"]["pass"] = 6
    elif fault == "third_party":
        st[-1]["leases"][0]["lender"] = "uid-pod-other/main"
    elif fault == "torn_epoch":
        st[2]["configs"][bl.INFER_POD]["lease"] = 99
    elif fault == "no_revoke_event":
        rec["timelines"]["uid-pod-train"] = rec["timelines"][
            "uid-pod-train"][:1]
    elif fault == "unadopted":
        # the interposer never ran a step under the second grant's epoch
        rec["runs"][bl.INFER_POD]["steps"] = [
            s[:5] + (1 if s[5] == 2 else s[5],)
            for s in rec["runs"][bl.INFER_POD]["steps"]]
    elif fault == "plugin_failed_pass":
        rec["marks"]["failed_passes"] = 1
    assert not bl.judge_market_run(**rec)["ok"]
