"""The quota market's tenant side in the port's interposer, on the fake
driver: a lease and a migration freeze adopted from the tenant's config.

The JAX package's writers rewrite the config (`vtpu_manager/quota/
market.py` `QuotaMarketManager._reconcile`, driven by
`tests/test_quota.py`'s `FakeUtil`; `vtpu_manager/autopilot/migrate.py`
`set_tenant_freeze`), and the port's interposer, preloaded into the
harness's `--steps` tenant (one 2 ms fake kernel and a synchronisation
per step), adopts what they wrote while it runs, as
`library/src/enforce.cc:1290-1416, 2454-2502` does. The reloader itself
is held by the g++ probe over the interposer's own header
(`csrc/shim/test/quota_reclaim_probe.cc`, the counterpart of
`library/tools/quota_reclaim_probe.cc`). Then the workload class in
Allocate against the JAX plugin's config bytes, and the card phase's
judging on synthetic runs.
"""

from __future__ import annotations

import copy
import os
import statistics
import struct
import subprocess
import time

import pytest

from test_quota import FakeState, FakeUtil
from test_torch_deviceplugin import (alloc, committed_pod, jax_plugin,
                                     make_manager, node_dirs)
from vtpu_manager.autopilot.migrate import set_tenant_freeze
from vtpu_manager.config import vtpu_config as jvc
from vtpu_manager.deviceplugin.api import deviceplugin_pb2 as jpb
from vtpu_manager.quota import QuotaMarketManager
from vtpu_manager import quota as jquota
from vtpu_manager_torch import bench_quota, bench_quota_lease as bl, build
from vtpu_manager_torch import quota
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin, device_id
from vtpu_manager_torch.util import consts

EXEC_US = 2000            # the fake kernel
SHARE_BAND = 15.0         # the fake quota sweep's (tests/test_torch_shim.py)
QUANTUM_MS = 2.0          # the re-read's quantum (the quota tick's)
REREAD_SLACK_MS = 23.0    # scripts/bench_quotamarket.py:444
UUID = "GPU-lease-0"


def write_tenant(base, uid, cls, hard, lease=0, core_limit=None) -> str:
    """A tenant's config where the market looks for it
    (`<base>/<uid>_main/config/vtpu.config`), written by the JAX writer."""
    path = os.path.join(base, f"{uid}_main", "config", "vtpu.config")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    limit = core_limit if core_limit is not None else (
        jvc.CORE_LIMIT_HARD if hard else jvc.CORE_LIMIT_NONE)
    jvc.write_config(path, jvc.VtpuConfig(
        pod_uid=uid, container_name="main", workload_class=cls,
        devices=[jvc.DeviceConfig(uuid=UUID, total_memory=1 << 30,
                                  real_memory=1 << 30, hard_core=hard,
                                  soft_core=hard, core_limit=limit,
                                  lease_core=lease, host_index=0)]))
    return path


class Steps:
    """The harness's `--steps` tenant under the interposer, one fake kernel
    per step, stopped by a file. Each rewrite is stamped before the writer
    is called (`began`) and after it returns (`marks`): its rename lies
    between the two, and on a loaded host the writer's return can come
    tens of ms after it."""

    def __init__(self, tmp_path, cfg_path: str, uid: str, **env):
        self.stop = str(tmp_path / f"stop-{uid}")
        self.proc = subprocess.Popen(
            [str(build.build_shim_test()), "--steps"],
            env=bench_quota.fake_harness_env(
                VTPU_CONFIG_PATH=cfg_path, VTPU_POD_UID=uid,
                VTPU_CONTAINER_NAME="main", VTPU_LOGGER_LEVEL=2,
                FAKE_EXEC_US=EXEC_US, SHIM_TEST_KERNELS=1,
                SHIM_TEST_ITERS=100000, SHIM_TEST_STOP_FILE=self.stop,
                **env),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.marks: list[int] = []
        self.began: list[int] = []

    def at(self, delay_s: float, write) -> None:
        time.sleep(delay_s)
        self.began.append(time.monotonic_ns())
        write()
        self.marks.append(time.monotonic_ns())

    def finish(self, delay_s: float) -> dict:
        time.sleep(delay_s)
        self.end = time.monotonic_ns()
        open(self.stop, "w").close()
        out, err = self.proc.communicate(timeout=120)
        assert self.proc.returncode == 0, err[-2000:]
        # (start, end, the interposer's quota_epoch after the step)
        steps = [(int(p[2]), int(p[3]), int(p[4])) for p in
                 (ln.split() for ln in out.splitlines())
                 if p and p[0] == "STEP"]
        return {"steps": steps, "stderr": err,
                **{k: v for k, v in bench_quota.parse_harness(out).items()
                   if k.startswith("vtpu_")}}


def steps_epochs(run) -> list[int]:
    """The quota epochs the steps saw, in order, each once."""
    out: list[int] = []
    for s in run["steps"]:
        if not out or out[-1] != s[2]:
            out.append(s[2])
    return out


def rate(steps, start, end) -> float:
    """ms per step of the steps that begin one quantum and the step in
    flight after `start` and end by `end`."""
    settle = int(QUANTUM_MS * 1e6) + bl.in_flight_ns(steps, start)
    return bl.stage_rate(steps, start, end, settle)["ms_per_step"]


@pytest.fixture(scope="module")
def t100():
    """The fake step unthrottled (an unmetered tenant), ms."""
    res = bench_quota.run_fake_harness(
        "--steps", FAKE_EXEC_US=EXEC_US, SHIM_TEST_KERNELS=1,
        SHIM_TEST_ITERS=150)
    steps = [(int(p[2]), int(p[3])) for p in
             (ln.split() for ln in res["stdout"].splitlines())
             if p and p[0] == "STEP"]
    return statistics.median(t1 - t0 for t0, t1 in steps[20:]) / 1e6


# --- the JAX market's rewrites ---------------------------------------------


def test_the_interposer_adopts_the_jax_markets_grant_and_revoke(tmp_path,
                                                               t100):
    """A latency tenant at hard 25 beside a throughput lender at 75: the
    JAX market's tick grants +25 (effective 50), a tick after the lender's
    demand climbs revokes it; the fake step tracks 25 -> 50 -> 25."""
    base = str(tmp_path / "mgr")
    write_tenant(base, "train", jvc.WORKLOAD_CLASS_THROUGHPUT, 75)
    cfg = write_tenant(base, "infer", jvc.WORKLOAD_CLASS_LATENCY, 25)
    util = FakeUtil([FakeState("train", "main", 0, 20.0, 1.0, 0.0, 45.0),
                     FakeState("infer", "main", 0, 24.0, 1.0, 0.6, 0.0)])
    market = QuotaMarketManager("n", base, util, grant_step_pct=25,
                                max_borrow_pct=25)
    tenant = Steps(tmp_path, cfg, "infer")

    def revoke():
        util.states[0].used_ewma, util.states[0]._reclaim = 70.0, 2.0
        market.tick(now=11.0)

    tenant.at(0.8, lambda: market.tick(now=10.0))
    tenant.at(1.2, revoke)
    run = tenant.finish(1.2)
    assert (market.grants_total, market.revokes_total) == (1, 1)
    assert jvc.read_config(cfg).quota_epoch == 2
    (grant, rev), steps = tenant.marks, run["steps"]
    shares = {"base": 100 * t100 / rate(steps, steps[0][0], grant),
              "granted": 100 * t100 / rate(steps, grant, rev),
              "revoked": 100 * t100 / rate(steps, rev, tenant.end)}
    for stage, want in (("base", 25), ("granted", 50), ("revoked", 25)):
        assert abs(shares[stage] - want) <= SHARE_BAND, shares
    assert run["vtpu_quota_reloads_total"] == 2, run
    assert run["vtpu_quota_epoch"] == 2 and run["vtpu_core_limit"] == 25
    err = run["stderr"]
    assert "quota lease granted on device 0: eff 25% -> 50%" in err
    assert "quota lease revoked on device 0: eff 50% -> 25%" in err


def _torn(path: str, lease: int, epoch: int) -> None:
    """A whole-size file whose checksum fails (a writer that tore it)."""
    raw = bytearray(open(path, "rb").read())
    cfg = vc.VtpuConfig.unpack(bytes(raw))
    cfg.devices[0].lease_core, cfg.quota_epoch = lease, epoch
    raw = bytearray(cfg.pack())
    raw[-8] ^= 0xFF
    _replace(path, bytes(raw))


def _stale(path: str, lease: int, epoch: int) -> None:
    """A valid checksum over the wrong layout version."""
    cfg = vc.read_config(path)
    cfg.devices[0].lease_core, cfg.quota_epoch = lease, epoch
    raw = bytearray(cfg.pack())
    struct.pack_into("<I", raw, 4, vc.VERSION - 1)
    struct.pack_into("<I", raw, vc.CONFIG_SIZE - 8,
                     vc.fnv1a(bytes(raw[:vc.CONFIG_SIZE - 8])))
    _replace(path, bytes(raw))


def _same_epoch(path: str, lease: int, epoch: int) -> None:
    """A valid rewrite that does not bump the epoch."""
    cfg = vc.read_config(path)
    cfg.devices[0].lease_core = lease
    vc.write_config(path, cfg)


def _short(path: str, lease: int, epoch: int) -> None:
    """A file cut short (a writer that died mid-write, without the
    rename)."""
    with open(path, "r+b") as f:
        f.truncate(vc.CONFIG_SIZE // 2)


def _replace(path: str, raw: bytes) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
    os.replace(tmp, path)


@pytest.mark.parametrize("bad", [_torn, _stale, _same_epoch, _short])
def test_a_torn_stale_or_same_epoch_rewrite_is_never_adopted(tmp_path, bad):
    """The bad generation (+75: effective 100) leaves the tenant at its
    base; the next valid generation (+25, a new epoch) is adopted."""
    base = str(tmp_path / "mgr")
    cfg = write_tenant(base, "infer", jvc.WORKLOAD_CLASS_LATENCY, 25)
    whole = vc.read_config(cfg)
    tenant = Steps(tmp_path, cfg, "infer")
    tenant.at(0.3, lambda: bad(cfg, 75, 7))
    if bad is _short:
        # the whole file again (the rename a real writer ends with)
        tenant.at(0.3, lambda: write_tenant(base, "infer",
                                            jvc.WORKLOAD_CLASS_LATENCY, 25))
    else:
        tenant.at(0.3, lambda: None)
    bad_at, good_from = tenant.marks

    def good():
        whole.devices[0].lease_core, whole.quota_epoch = 25, 8
        vc.write_config(cfg, whole)

    tenant.at(0.0, good)
    run = tenant.finish(0.6)
    steps = run["steps"]
    # at the base throughout the bad generation, at 50 after the good one
    ratio = rate(steps, bad_at, good_from) / rate(steps, tenant.marks[2],
                                                   tenant.end)
    assert 1.5 <= ratio <= 2.6, ratio
    assert run["vtpu_quota_reloads_total"] == 1, run
    assert run["vtpu_quota_epoch"] == 8 and run["vtpu_core_limit"] == 50


def test_a_revoke_clamps_the_tokens(tmp_path):
    """A borrower at effective 100 banks up to a window's grant (10 ms);
    the revoke to 25 clamps it to one window at 25 % (2.5 ms), so at most
    two 2 ms steps after the adoption (the first step the new epoch ends)
    run unpaced, a launch going on any balance that is not in debt
    (without the clamp, three to five did here)."""
    base = str(tmp_path / "mgr")
    cfg = write_tenant(base, "infer", jvc.WORKLOAD_CLASS_LATENCY, 25,
                       lease=75)
    tenant = Steps(tmp_path, cfg, "infer")

    def revoke():
        c = vc.read_config(cfg)
        c.devices[0].lease_core, c.quota_epoch = 0, c.quota_epoch + 1
        vc.write_config(cfg, c)

    tenant.at(1.0, revoke)
    run = tenant.finish(0.5)
    assert steps_epochs(run) == [0, 1]
    steps = run["steps"]
    adopted = next(i for i, s in enumerate(steps) if s[2] == 1)
    after = steps[adopted + 1:adopted + 9]
    fast = [s for s in after if s[1] - s[0] < 1.5 * EXEC_US * 1000]
    assert len(after) == 8 and len(fast) <= 2, [
        (s[1] - s[0]) / 1e6 for s in after]
    assert run["vtpu_core_limit"] == 25
    assert "quota lease revoked on device 0: eff 100% -> 25%" in \
        run["stderr"]


def test_a_lender_at_hard_100_becomes_metered(tmp_path, t100):
    """Unmetered at hard 100 until it lends 50: then paced at 50. The
    unmetered stage is judged by its median step, the statistic of its
    yardstick `t100`: the bucket delays a launch inside its step, and the
    stage's wall also holds the host's pauses of the harness between
    steps, which no interposer decision makes. The paced stage is judged
    by its wall: pacing sets it."""
    base = str(tmp_path / "mgr")
    cfg = write_tenant(base, "train", jvc.WORKLOAD_CLASS_THROUGHPUT, 100)
    tenant = Steps(tmp_path, cfg, "train")

    def lend():
        c = vc.read_config(cfg)
        c.devices[0].lease_core, c.quota_epoch = -50, 1
        vc.write_config(cfg, c)

    tenant.at(0.5, lend)
    run = tenant.finish(1.2)
    steps, (lent,) = run["steps"], tenant.marks
    first = bl.stage_rate(steps, steps[0][0], lent, 0)
    before = 100 * t100 / first["median_ms"]
    after = 100 * t100 / rate(steps, lent, tenant.end)
    assert before >= 100 - SHARE_BAND, (before, after)
    assert abs(after - 50) <= SHARE_BAND, (before, after)
    assert run["vtpu_core_limit"] == 50 and run["vtpu_charged_ns_total"] > 0


# --- the migration freeze ---------------------------------------------------


def _gap(steps, after_ns) -> tuple[float, tuple]:
    """The longest step or pause between steps that ends after
    `after_ns`, in seconds, and where it lies."""
    spans = [(s[1] - s[0], s) for s in steps if s[1] > after_ns]
    spans += [(b[0] - a[1], (a[1], b[0])) for a, b in zip(steps, steps[1:])
              if b[0] > after_ns]
    span, where = max(spans)
    return span / 1e9, where


@pytest.mark.parametrize("hard", [0, 25], ids=["unmetered", "metered"])
def test_a_freeze_parks_launches_until_the_unfreeze(tmp_path, hard):
    """The JAX migrator's freeze parks the next launch of a metered and of
    an unmetered tenant until its unfreeze; the park is freeze wait, not
    throttle wait."""
    base = str(tmp_path / "mgr")
    cfg = write_tenant(base, "t1", jvc.WORKLOAD_CLASS_NONE, hard)
    tenant = Steps(tmp_path, cfg, "t1")
    tenant.at(0.4, lambda: set_tenant_freeze(base, "t1", True))
    tenant.at(0.6, lambda: set_tenant_freeze(base, "t1", False))
    run = tenant.finish(0.3)
    steps, (frozen, thawed) = run["steps"], tenant.marks
    held = (thawed - frozen) / 1e9
    gap, where = _gap(steps, frozen)
    # every tenant's quota tick re-reads every quantum
    slack = (QUANTUM_MS + REREAD_SLACK_MS) / 1e3 + 4 * EXEC_US / 1e6
    # nothing ran inside the freeze but the step in flight at its rename
    inside = [s for s in steps if frozen + int(slack * 1e9) < s[1] < thawed]
    assert not inside, [(s[0] - frozen) / 1e9 for s in inside]
    assert abs(gap - held) <= slack, (gap, held)
    freeze_s = run["vtpu_freeze_wait_ns_total"] / 1e9
    assert abs(freeze_s - held) <= slack, (freeze_s, held)
    # the throttle wait is a quota's, not the freeze's
    assert run["vtpu_throttle_wait_ns_total"] / 1e9 < 0.5 * sum(
        (s[1] - s[0]) for s in steps) / 1e9 + 0.05
    assert run["vtpu_quota_reloads_total"] == 2
    assert "launches parked: migration freeze epoch 1" in run["stderr"]


@pytest.mark.parametrize("launch", ["kernel", "graph"])
def test_a_freeze_parks_a_tenant_that_launches_rarely(tmp_path, launch):
    """An unmetered tenant that launches once per 50 ms step (one kernel,
    or one graph replay, with no synchronisation): no launch goes through
    later than one quantum and one re-read after the freeze's rename, and
    the one that parks waits out the freeze. Each rename lies between its
    two stamps (`Steps.at`): the freeze's is taken as late as it can be,
    the unfreeze's as early."""
    gap_ms = 50
    base = str(tmp_path / "mgr")
    cfg = write_tenant(base, "t1", jvc.WORKLOAD_CLASS_NONE, 0)
    tenant = Steps(tmp_path, cfg, "t1", SHIM_TEST_SYNC="none",
                   SHIM_TEST_GAP_US=gap_ms * 1000, SHIM_TEST_LAUNCH=launch,
                   SHIM_TEST_REPLAYS=1)
    tenant.at(0.4, lambda: set_tenant_freeze(base, "t1", True))
    tenant.at(0.8, lambda: set_tenant_freeze(base, "t1", False))
    run = tenant.finish(0.3)
    steps, (frozen, thawed) = run["steps"], tenant.marks
    frozen_from, thawed_from = tenant.began
    gap_ns = gap_ms * 1e6
    adopt = frozen + int((QUANTUM_MS + REREAD_SLACK_MS) * 1e6)
    # a step is its launch, then a sleep of at least the gap: one that
    # began after the freeze was adopted and whose launch returned before
    # the unfreeze's writer was called launched inside the freeze
    through = [(s[0] - frozen) / 1e6 for s in steps
               if adopt < s[0] and s[1] - gap_ns < thawed_from]
    assert not through, through
    parked = [s for s in steps if s[0] < thawed_from < s[1] - gap_ns]
    assert len(parked) == 1, [(s[0] - frozen, s[1] - frozen) for s in steps
                              if s[1] > frozen]
    slack = (QUANTUM_MS + REREAD_SLACK_MS) / 1e3 + gap_ms / 1e3
    freeze_s = run["vtpu_freeze_wait_ns_total"] / 1e9
    low, high = (thawed_from - frozen) / 1e9, (thawed - frozen_from) / 1e9
    assert low - slack <= freeze_s <= high + slack, (freeze_s, low, high)
    assert run["vtpu_quota_reloads_total"] == 2


def test_a_freeze_fails_open_after_its_limit(tmp_path):
    """An unfreeze that never comes: VTPU_FREEZE_MAX_S=1 releases the
    parked launch after a second, and no later launch of that freeze
    parks."""
    base = str(tmp_path / "mgr")
    cfg = write_tenant(base, "t1", jvc.WORKLOAD_CLASS_NONE, 0)
    tenant = Steps(tmp_path, cfg, "t1", VTPU_FREEZE_MAX_S=1)
    tenant.at(0.3, lambda: set_tenant_freeze(base, "t1", True))
    run = tenant.finish(1.8)
    steps, (frozen,) = run["steps"], tenant.marks
    gap, where = _gap(steps, frozen)
    assert 0.95 <= gap <= 1.2, gap
    after = [s for s in steps if s[0] > where[1]]
    assert len(after) > 50, len(after)      # no second park
    assert 0.95 <= run["vtpu_freeze_wait_ns_total"] / 1e9 <= 1.2
    assert vc.read_config(cfg).migration_freeze == 1
    assert "failing open" in run["stderr"]


# --- the reloader's latency, through the interposer's own code --------------


def test_the_probe_adopts_within_one_quantum_and_a_reread(tmp_path):
    """Rename-to-adoption through the interposer's QuotaReloader at its
    2 ms quantum: the p99 of 20 rewrites within one quantum and the
    reference's re-read slack (scripts/bench_quotamarket.py:444)."""
    cfg = str(tmp_path / "vtpu.config")
    c = vc.VtpuConfig(pod_uid="probe", quota_epoch=1, devices=[
        vc.DeviceConfig(uuid=UUID, total_memory=1 << 30,
                        real_memory=1 << 30, hard_core=40,
                        core_limit=vc.CORE_LIMIT_HARD)])
    vc.write_config(cfg, c)
    rounds = 20
    proc = subprocess.Popen([str(build.build_quota_probe()), cfg,
                             str(rounds)], stdout=subprocess.PIPE, text=True)
    lat_ms, seen = [], []
    try:
        assert proc.stdout.readline().split() == ["READY", "1"]
        for _ in range(rounds):
            time.sleep(0.01)
            c.quota_epoch += 1
            c.devices[0].lease_core = 20 if c.devices[0].lease_core == 0 \
                else 0
            t0 = time.time_ns()
            vc.write_config(cfg, c)
            line = proc.stdout.readline().split()
            assert line and line[0] == "ADOPT", line
            lat_ms.append((int(line[2]) - t0) / 1e6)
            seen.append((int(line[1]), int(line[3]), int(line[4])))
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert seen == [(2 + i, 20 if i % 2 == 0 else 0,
                     60 if i % 2 == 0 else 40) for i in range(rounds)]
    lat_ms.sort()
    p99 = lat_ms[max(0, int(0.99 * rounds) - 1)]
    assert p99 <= QUANTUM_MS + REREAD_SLACK_MS, lat_ms


def test_effective_core_equals_the_jax_markets():
    for hard in (0, 25, 60, 100):
        for lease in (-100, -25, 0, 25, 40, 75):
            assert quota.effective_core(hard, lease) == \
                jquota.effective_core(hard, lease)


# --- the workload class in Allocate -----------------------------------------

CLASSES = {"latency": consts.WORKLOAD_CLASS_LATENCY_CRITICAL,
           "throughput": consts.WORKLOAD_CLASS_THROUGHPUT,
           "garbage": "real-time", "none": None}


@pytest.mark.parametrize("gate", [True, False], ids=["gate_on", "gate_off"])
@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_allocate_stamps_the_class_as_the_jax_plugin(tmp_path, gate, cls):
    """The config bytes equal the JAX plugin's with QuotaMarket on and off
    (tests/test_quota.py:196 TestPluginStamping): the class stamped when
    on and the annotation normalized, 0 otherwise; epoch and lease 0."""
    client = FakeKubeClient()
    mgr = make_manager(client)
    p = VnumPlugin(mgr, client, "node-1", node_config=NodeConfig(),
                   **node_dirs(tmp_path / "port"))
    p.quota_market_enabled = gate
    anns = ({} if CLASSES[cls] is None
            else {consts.workload_class_annotation(): CLASSES[cls]})
    pod = committed_pod(mgr, cores=25, annotations=anns)
    jp, jclient = jax_plugin(mgr, tmp_path / "jax")
    jp.quota_market_enabled = gate
    client.add_pod(copy.deepcopy(pod))
    jclient.add_pod(copy.deepcopy(pod))
    ids = [device_id(mgr.chips[0].uuid, 0)]
    alloc(p, *ids)
    jp.allocate(jpb.AllocateRequest(container_requests=[
        jpb.ContainerAllocateRequest(devicesIDs=ids)]))
    rel = os.path.join("uid-p1_main", "config", "vtpu.config")
    mine = open(os.path.join(p.base_dir, rel), "rb").read()
    theirs = open(os.path.join(str(tmp_path / "jax"), rel), "rb").read()
    assert mine == theirs
    cfg = vc.read_config(os.path.join(p.base_dir, rel))
    want = (quota.workload_class_abi(CLASSES[cls] or "") if gate
            else vc.WORKLOAD_CLASS_NONE)
    assert cfg.workload_class == want
    assert (cfg.quota_epoch, cfg.devices[0].lease_core) == (0, 0)


@pytest.mark.parametrize("value", ["latency-critical", "throughput",
                                   " Latency-Critical ", "real-time", ""])
def test_class_readers_equal_the_jax_packages(value):
    pod = {"metadata": {"annotations": {
        consts.workload_class_annotation(): value}}}
    assert quota.workload_class_of(pod) == jquota.workload_class_of(pod)
    cls = quota.workload_class_of(pod)
    assert quota.workload_class_abi(cls) == jquota.workload_class_abi(cls)
    assert quota.CLASS_TO_ABI == jquota.CLASS_TO_ABI


# --- the card phase's judging, on synthetic runs -----------------------------


KERNEL_MS = 2.2   # the synthetic step's card time, charged each step
HOST_MS = 0.44    # its host time, which the card's share does not hold


def _synthetic(ms_by_stage, freeze_s=1.0, parked=True):
    """A run as the lease tenant reports it: steps at each stage's ms per
    step, each charged `KERNEL_MS` and waiting in the bucket whatever
    the step takes beyond its card and host time, a freeze that parks one
    step, and the renames."""
    t = 10**12
    steps, marks = [], {"stages": []}
    wait = frozen = charged = 0

    def run_for(seconds, ms):
        nonlocal t, wait, charged
        end = t + int(seconds * 1e9)
        while t < end:
            wait += int(max(0.0, ms - KERNEL_MS - HOST_MS) * 1e6)
            charged += int(KERNEL_MS * 1e6)
            steps.append([t, t + int(ms * 1e6), wait, frozen, charged])
            t += int(ms * 1e6)

    run_for(0.5, ms_by_stage[-1])
    for epoch, ((lease, eff), ms) in enumerate(zip(bl.STAGES, ms_by_stage),
                                               start=1):
        marks["stages"].append({"t_ns": t, "epoch": epoch, "lease": lease,
                                "effective": eff, "freeze": 0})
        run_for(2.0, ms)
    marks["freeze"] = {"t_ns": t, "epoch": 4, "lease": 0, "freeze": 1}
    held = int(freeze_s * 1e9)
    if parked:
        frozen += held
        charged += int(KERNEL_MS * 1e6)
        steps.append([t, t + held + int(ms_by_stage[-1] * 1e6), wait,
                      frozen, charged])
        t += held + int(ms_by_stage[-1] * 1e6)
    else:
        run_for(freeze_s, ms_by_stage[-1])
    marks["unfreeze"] = {"t_ns": marks["freeze"]["t_ns"] + held,
                         "epoch": 5, "lease": 0, "freeze": 0}
    run_for(0.5, ms_by_stage[-1])
    marks["end_ns"] = t
    return ({"steps": steps, "vtpu_quota_reloads_total": 5,
             "vtpu_quota_epoch": 5, "vtpu_freeze_wait_ns_total": frozen,
             "attn_block_launches": len(steps)}, marks)


UNPACED_MS = KERNEL_MS + HOST_MS


def test_the_phase_passes_a_run_that_tracks_its_leases():
    """Paced at 50 and 25 % of the card, the stages read 50 and 25 however
    much host time the step holds; the effective-100 stage reads the
    step's own demand, with no throttle wait."""
    run, marks = _synthetic([UNPACED_MS, 2 * KERNEL_MS, 4 * KERNEL_MS])
    lease = bl.judge_lease(run, marks)
    assert lease["ok"], lease
    assert [round(s["share"]) for s in lease["stages"]] == [
        round(100 * KERNEL_MS / UNPACED_MS), 50, 25]
    assert lease["stages"][0]["wait_share"] == 0
    freeze = bl.judge_freeze(run, marks)
    assert freeze["ok"], freeze


@pytest.mark.parametrize("ms,why", [
    ([UNPACED_MS, UNPACED_MS, 4 * KERNEL_MS], "the grant's 50"),
    ([UNPACED_MS, 2 * KERNEL_MS, 2 * KERNEL_MS], "the revoke"),
    # read against the unpaced step's time, this stage read 40.8 and passed
    ([UNPACED_MS, KERNEL_MS / 0.34, 4 * KERNEL_MS], "a 50 paced at 34"),
    ([4 * KERNEL_MS, 2 * KERNEL_MS, 4 * KERNEL_MS], "no grant to 100")])
def test_the_phase_fails_a_stage_off_its_quota(ms, why):
    run, marks = _synthetic(ms)
    assert not bl.judge_lease(run, marks)["ok"], why


def test_the_phase_fails_a_missed_reload_and_an_unparked_freeze():
    run, marks = _synthetic([UNPACED_MS, 2 * KERNEL_MS, 4 * KERNEL_MS])
    run["vtpu_quota_reloads_total"] = 4
    assert not bl.judge_lease(run, marks)["ok"]
    run, marks = _synthetic([UNPACED_MS, 2 * KERNEL_MS, 4 * KERNEL_MS],
                            parked=False)
    assert not bl.judge_freeze(run, marks)["ok"]


def test_inspect_shows_the_current_generation(tmp_path):
    from vtpu_manager_torch.tools import vtpu_inspect
    import io
    base = str(tmp_path / "mgr")
    path = write_tenant(base, "uid-lease", jvc.WORKLOAD_CLASS_LATENCY, 25)
    bl.rewrite(path, lease=25)
    out = io.StringIO()
    vtpu_inspect.dump(base, str(tmp_path / "none"), str(tmp_path / "none"),
                      out)
    cfg = vc.read_config(path)
    assert bl.inspect_shows(out.getvalue(), cfg)["ok"], out.getvalue()
    bl.rewrite(path, lease=0)
    assert not bl.inspect_shows(out.getvalue(), vc.read_config(path))["ok"]
