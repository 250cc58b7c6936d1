"""Observation calibration (`manager/obs_calibrate.py`), its wiring and the
interposer's excess table, against the JAX package.

The cases of tests/test_obs_calibrate.py run through both packages on the
same fake `run_once`; on a fake clock the two give the same table. The
encoded table is read by either package's decoder. Allocate (the device
plugin) and the DRA environment carry `VTPU_OBS_EXCESS_TABLE` exactly when
the JAX package's do. The feed's calibration block written by the port's
watcher is the JAX reader's. The interposer (the harness's `--excess` over
the fake driver) interpolates the table as computed here from the JAX
`decode_table`, takes a live feed table over the environment's, ignores a
malformed one, and discounts an isolated sample at most half its span.
"""

import copy
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from vtpu_manager.client.fake import FakeKubeClient as JaxFakeKubeClient
from vtpu_manager.config import tc_watcher as jtc
from vtpu_manager.deviceplugin.api import deviceplugin_pb2 as jpb
from vtpu_manager.deviceplugin.vnum import VnumPlugin as JaxVnumPlugin
from vtpu_manager.device.types import ChipSpec as JaxChipSpec
from vtpu_manager.kubeletplugin.device_state import \
    DeviceState as JaxDeviceState
from vtpu_manager.manager import obs_calibrate as jcal
from vtpu_manager.manager.device_manager import \
    DeviceManager as JaxDeviceManager
from vtpu_manager.util import consts as jc
from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.config import tc_watcher as tc
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.deviceplugin.api import messages as api
from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin, device_id
from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
from vtpu_manager_torch.manager import obs_calibrate as cal
from vtpu_manager_torch.manager import watcher as w
from vtpu_manager_torch.manager.device_manager import DeviceManager
from vtpu_manager_torch.tpu.discovery import FakeBackend
from vtpu_manager_torch.util import consts

from test_torch_entry import _serve_until

GIB = 2**30
TABLE = "0:0,60000:1800,120000:6000,250000:14000"


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return jcal if request.param == "jax" else cal


# --- the measurement (tests/test_obs_calibrate.py:25-102) --------------------

class TestMeasurement:
    def test_excess_over_b2b_floor(self, pkg):
        state = {}

        def run_once():
            now = time.perf_counter()
            gap = now - state.get("last", now) > 0.02
            time.sleep((9 if gap else 5) / 1000.0)
            state["last"] = time.perf_counter()

        table = pkg.measure_excess_table(run_once, gaps_ms=(30, 60),
                                         b2b_samples=4, gap_samples=3)
        assert table is not None and table[0] == (0, 0)
        gaps = dict(table)
        assert 3500 <= gaps[30000] <= 7000
        assert 3500 <= gaps[60000] <= 7000

    def test_phase_dependent_inflation_not_certified_clean(self, pkg):
        state = {"n": 0}

        def run_once():
            now = time.perf_counter()
            gap = now - state.get("last", now) > 0.02
            state["n"] += 1
            time.sleep((5 + (0 if not gap or state["n"] % 3 == 0 else 8))
                       / 1000.0)
            state["last"] = time.perf_counter()

        table = pkg.measure_excess_table(run_once, gaps_ms=(30,),
                                         b2b_samples=4, gap_samples=7)
        assert table is not None
        assert 6000 <= dict(table)[30000] <= 12000

    def test_clean_transport_calibrates_to_zero(self, pkg):
        table = pkg.measure_excess_table(lambda: time.sleep(0.004),
                                         gaps_ms=(30,), b2b_samples=4,
                                         gap_samples=3)
        assert table is not None and table[0] == (0, 0)
        assert dict(table)[30000] <= 1500

    def test_failure_returns_none(self, pkg):
        def run_once():
            raise RuntimeError("transport down")

        assert pkg.measure_excess_table(run_once, gaps_ms=(30,)) is None

    def test_encode_decode_roundtrip(self, pkg):
        table = [(0, 0), (60000, 1800), (250000, 14000)]
        assert pkg.encode_table(table) == "0:0,60000:1800,250000:14000"
        assert pkg.decode_table(pkg.encode_table(table)) == table
        with pytest.raises(ValueError):
            pkg.decode_table("garbage")


class _FakeTime:
    """A clock the fake program advances: spans and sleeps without noise,
    so both packages' statistics see the same numbers."""

    def __init__(self):
        self.ns = 10**12
        self.gap = False

    def perf_counter_ns(self):
        return self.ns

    def perf_counter(self):
        return self.ns / 1e9

    def sleep(self, s):
        self.ns += int(s * 1e9)
        self.gap = True

    def run_once(self, n=[0]):
        n[0] += 1
        # a 5 ms program; after an idle gap, 2-9 ms more by a phase
        self.ns += 5_000_000 + (1_000_000 * (2 + n[0] * 7 % 8)
                                if self.gap else 0)
        self.gap = False


@pytest.mark.parametrize("stat", ["median", "min"])
@pytest.mark.parametrize("gaps", [(60, 120, 250), (10, 500)])
def test_same_table_as_jax_on_the_same_program(monkeypatch, stat, gaps):
    monkeypatch.setenv("VTPU_OBS_CAL_STAT", stat)
    tables = []
    for mod in (jcal, cal):
        clock = _FakeTime()
        monkeypatch.setattr(mod, "time", clock)
        calls = [0]

        def run_once(clock=clock, calls=calls):
            calls[0] += 1
            clock.run_once(calls)

        tables.append(mod.measure_excess_table(run_once, gaps_ms=gaps))
    assert tables[0] is not None and tables[0] == tables[1]
    assert [g for g, _ in tables[1]] == [0] + [g * 1000 for g in gaps]


@pytest.mark.parametrize("table", [[(0, 0)], [(0, 0), (60000, 1800)],
                                   [(0, 5), (1, 2), (250000, 14000)]])
def test_encoded_tables_cross_decode(table):
    assert jcal.decode_table(cal.encode_table(table)) == table
    assert cal.decode_table(jcal.encode_table(table)) == table
    assert cal.encode_table(table) == jcal.encode_table(table)


@pytest.mark.parametrize("raw", ["garbage", "1:2,x", "1:", ":3", "1:2;3:4"])
def test_malformed_tables_refused_by_both(raw):
    for mod in (jcal, cal):
        with pytest.raises(ValueError):
            mod.decode_table(raw)


# --- the gate and the subprocess ------------------------------------------

@pytest.mark.parametrize("mode,real,runs", [
    ("0", True, False), ("0", False, False), ("1", False, True),
    ("1", True, True), ("auto", True, True), ("auto", False, False),
    (None, True, True), (None, False, False)])
def test_maybe_calibrate_gate_matches_jax(monkeypatch, mode, real, runs):
    if mode is None:
        monkeypatch.delenv("VTPU_OBS_CALIBRATE", raising=False)
    else:
        monkeypatch.setenv("VTPU_OBS_CALIBRATE", mode)
    for mod in (jcal, cal):
        called = []
        monkeypatch.setattr(mod, "calibrate_in_subprocess",
                            lambda *a, **k: called.append(1) or TABLE)
        assert mod.maybe_calibrate(real_chips=real) == (TABLE if runs
                                                        else None)
        assert bool(called) == runs


def test_maybe_calibrate_reads_the_plugins_environment(monkeypatch):
    monkeypatch.setenv("VTPU_OBS_CALIBRATE", "1")
    seen = []
    monkeypatch.setattr(cal, "calibrate_in_subprocess",
                        lambda env=None, **k: seen.append(env) or TABLE)
    assert cal.maybe_calibrate(True, env={"VTPU_OBS_CALIBRATE": "0"}) is None
    env = {"VTPU_OBS_CALIBRATE": "1", "X": "y"}
    assert cal.maybe_calibrate(False, env=env) == TABLE
    assert seen == [env]


@pytest.mark.parametrize("stdout,want", [
    (f"noise\nOBS_EXCESS_TABLE={TABLE}\n", TABLE),
    ("OBS_EXCESS_TABLE=none\n", None), ("OBS_EXCESS_TABLE=\n", None),
    ("nothing\n", None)])
def test_calibrate_in_subprocess_reads_the_line(monkeypatch, stdout, want):
    for mod in (jcal, cal):
        runs = []

        def run(cmd, **kw):
            runs.append(cmd)
            return SimpleNamespace(stdout=stdout, returncode=0)

        monkeypatch.setattr(mod.subprocess, "run", run)
        assert mod.calibrate_in_subprocess() == want
    assert runs[0][-1] == "vtpu_manager_torch.manager.obs_calibrate"


def test_calibrate_in_subprocess_times_out_to_none(monkeypatch):
    def run(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))

    monkeypatch.setattr(cal.subprocess, "run", run)
    assert cal.calibrate_in_subprocess(timeout_s=0.1) is None


@pytest.mark.parametrize("table", [None, [(0, 0), (60000, 700)]])
def test_main_prints_the_table(monkeypatch, capsys, table):
    monkeypatch.setenv("VTPU_OBS_CAL_GAPS_MS", "60")
    got = []
    monkeypatch.setattr(cal, "measure_excess_table",
                        lambda gaps_ms: got.append(gaps_ms) or table)
    rc = cal.main()
    out = capsys.readouterr().out.strip()
    assert got == [(60,)]
    if table is None:
        assert (rc, out) == (1, "OBS_EXCESS_TABLE=none")
    else:
        assert (rc, out) == (0, "OBS_EXCESS_TABLE=0:0,60000:700")


def test_no_card_means_no_table_in_a_subprocess():
    env = {k: v for k, v in os.environ.items() if not k.startswith("VTPU_")}
    env["PYTHONPATH"] = str(build.REPO)
    res = subprocess.run(
        [sys.executable, "-m", "vtpu_manager_torch.manager.obs_calibrate"],
        env=env, capture_output=True, text=True, timeout=120,
        cwd=str(build.REPO))
    # the calibration measures the card: no CPU fallback
    assert res.returncode == 1
    assert res.stdout.strip() == "OBS_EXCESS_TABLE=none"


# --- the node side: annotation, Allocate, DRA, feed ------------------------

def _port_manager():
    client = FakeKubeClient()
    client.add_node({"metadata": {"name": "node-1", "annotations": {}}})
    mgr = DeviceManager("node-1", client,
                        node_config=NodeConfig(device_split_count=4),
                        backends=[FakeBackend(n_chips=1)])
    mgr.init_devices()
    return mgr, client


@pytest.mark.parametrize("table", [TABLE, None])
def test_calibrate_obs_overhead_annotates_as_jax(table):
    mgr, client = _port_manager()
    jclient = JaxFakeKubeClient()
    jclient.add_node({"metadata": {"name": "node-1", "annotations": {}}})
    jmgr = JaxDeviceManager("node-1", jclient)
    assert mgr.calibrate_obs_overhead(table=table) == table
    assert jmgr.calibrate_obs_overhead(table=table) == table
    assert (mgr.obs_excess_table, jmgr.obs_excess_table) == (table, table)
    mine = client.get_node("node-1")["metadata"]["annotations"]
    theirs = jclient.get_node("node-1")["metadata"]["annotations"]
    assert mine == theirs
    assert (consts.node_obs_overhead_annotation() in mine) == (
        table is not None)
    assert consts.node_obs_overhead_annotation() == \
        jc.node_obs_overhead_annotation()


def test_calibrate_obs_overhead_measures_when_not_given(monkeypatch):
    mgr, _ = _port_manager()
    monkeypatch.setattr(cal, "calibrate_in_subprocess", lambda: TABLE)
    assert mgr.calibrate_obs_overhead() == TABLE


def test_a_failed_annotation_keeps_the_table(monkeypatch):
    mgr, client = _port_manager()

    def fail(*a, **k):
        raise RuntimeError("api down")

    monkeypatch.setattr(client, "patch_node_annotations", fail)
    assert mgr.calibrate_obs_overhead(table=TABLE) == TABLE
    assert mgr.obs_excess_table == TABLE


def _committed_pod(chip, cores=25, memory=GIB):
    from vtpu_manager_torch.device.claims import DeviceClaim, PodDeviceClaims
    claims = PodDeviceClaims()
    claims.add("main", DeviceClaim(chip.uuid, chip.index, cores, memory))
    return {"metadata": {"name": "p1", "namespace": "default",
                         "uid": "uid-p1",
                         "annotations": {
                             consts.pre_allocated_annotation():
                                 claims.encode(),
                             consts.predicate_node_annotation(): "node-1"}},
            "spec": {"nodeName": "node-1", "containers": [{"name": "main"}]},
            "status": {"phase": "Pending"}}


@pytest.mark.parametrize("table", [TABLE, None])
def test_allocate_injects_the_table_exactly_when_jax_does(tmp_path, table):
    mgr, client = _port_manager()
    mgr.obs_excess_table = table
    root = tmp_path / "port"
    p = VnumPlugin(mgr, client, "node-1", node_config=NodeConfig(),
                   base_dir=str(root / "mgr"), lock_dir=str(root / "locks"),
                   vmem_dir=str(root / "vmem"),
                   watcher_dir=str(root / "watcher"),
                   shim_host_dir=str(root / "driver"))
    jclient = JaxFakeKubeClient()
    jmgr = JaxDeviceManager("node-1", jclient)
    jmgr.chips = [JaxChipSpec.from_wire(c.to_wire()) for c in mgr.chips]
    jmgr.obs_excess_table = table
    jp = JaxVnumPlugin(jmgr, jclient, "node-1",
                       base_dir=str(tmp_path / "jax"))
    pod = _committed_pod(mgr.chips[0])
    client.add_pod(copy.deepcopy(pod))
    jclient.add_pod(copy.deepcopy(pod))
    ids = [device_id(mgr.chips[0].uuid, 0)]
    mine = p.allocate(api.AllocateRequest(
        [api.ContainerAllocateRequest(ids)])).container_responses[0]
    theirs = jp.allocate(jpb.AllocateRequest(container_requests=[
        jpb.ContainerAllocateRequest(devicesIDs=ids)])).container_responses[0]
    assert mine.envs.get(consts.ENV_OBS_EXCESS_TABLE) == \
        dict(theirs.envs).get(jc.ENV_OBS_EXCESS_TABLE) == table


@pytest.mark.parametrize("table", [TABLE, None])
def test_dra_env_injects_the_table_exactly_when_jax_does(tmp_path, table):
    from vtpu_manager.tpu.discovery import FakeBackend as JaxFakeBackend
    chips = FakeBackend(n_chips=1).discover().chips
    entry = {"device": "vtpu-0-0", "uuid": chips[0].uuid, "hostIndex": 0,
             "cores": 50, "memory": GIB}
    mine = DeviceState("node-1", chips, base_dir=str(tmp_path / "port"),
                       cdi_dir=str(tmp_path / "cdi"), obs_excess_table=table)
    theirs = JaxDeviceState("node-1", JaxFakeBackend(n_chips=1).discover()
                            .chips, base_dir=str(tmp_path / "jax"),
                            cdi_dir=str(tmp_path / "jcdi"),
                            obs_excess_table=table)
    got = mine._group_envs("claim-uid", [dict(entry)], "main")
    want = theirs._group_envs("claim-uid", [dict(entry)])
    assert got.get(consts.ENV_OBS_EXCESS_TABLE) == \
        want.get(jc.ENV_OBS_EXCESS_TABLE) == table


def test_published_calibration_is_the_jax_readers(tmp_path):
    path = tmp_path / "tc_util.config"
    daemon = w.TcWatcherDaemon([0], w.FakeSampler(), tc_path=str(path),
                               vmem_path=str(tmp_path / "vmem.config"))
    daemon.publish_calibration(cal.decode_table(TABLE))
    theirs = jtc.TcUtilFile(str(path))
    try:
        assert theirs.read_calibration() == jcal.decode_table(TABLE)
    finally:
        theirs.close()
    mine = tc.TcUtilFile(str(path))
    try:
        assert mine.read_calibration() == cal.decode_table(TABLE)
    finally:
        mine.close()


# --- the interposer ---------------------------------------------------------

def _interp(table, gap):
    """InterpExcess (library/src/enforce.cc:154) over a decoded table."""
    gaps = [g for g, _ in table]
    exc = [e for _, e in table]
    if gap <= gaps[0]:
        if gaps[0] <= 0 or gap <= 0:
            return exc[0] if gap >= gaps[0] else 0
        return exc[0] * gap // gaps[0]
    if gap >= gaps[-1]:
        return exc[-1]
    for i in range(1, len(gaps)):
        if gap <= gaps[i]:
            g0, g1 = gaps[i - 1], gaps[i]
            return exc[i - 1] + int((exc[i] - exc[i - 1]) * (gap - g0)
                                    / (g1 - g0))
    return exc[-1]


GAPS = [0, 1, 30000, 59999, 60000, 90000, 120000, 185000, 250000, 10**6]


def _excess(**env):
    res = bench_quota.run_fake_harness(
        "--excess", VTPU_CORE_LIMIT_0=50, FAKE_EXEC_US=300, SHIM_TEST_ITERS=8,
        SHIM_TEST_GAPS=",".join(str(g) for g in GAPS), **env)
    assert res["rc"] == 0, res["stderr"][-2000:]
    line = next(ln for ln in res["stdout"].splitlines()
                if ln.startswith("EXCESS"))
    return {int(k): int(v) for k, v in
            (kv.split("=") for kv in line.split()[1:])}, res


@pytest.mark.parametrize("raw", [
    TABLE, "60000:1800,250000:14000", "250000:14000,0:0,60000:1800",
    "0:100,5000:90,20000:400"])
def test_interposer_interpolates_the_env_table(raw):
    got, _ = _excess(VTPU_OBS_EXCESS_TABLE=raw)
    table = sorted(jcal.decode_table(raw))
    assert got == {g: _interp(table, g) for g in GAPS}


def test_interposer_keeps_the_first_seven_points_and_the_last():
    pts = [(i * 10000, i * 100) for i in range(10)]
    got, res = _excess(VTPU_OBS_EXCESS_TABLE=jcal.encode_table(pts))
    kept = pts[:7] + pts[-1:]
    assert got == {g: _interp(kept, g) for g in GAPS}
    assert "keeping the first 7" in res["stderr"]


@pytest.mark.parametrize("raw,kept", [("garbage", None),
                                      ("0:0,60000:x", [(0, 0)]),
                                      ("", None)])
def test_interposer_ignores_a_malformed_table(raw, kept):
    got, res = _excess(VTPU_OBS_EXCESS_TABLE=raw)
    if kept is None:
        assert set(got.values()) == {-1}
    else:
        assert got == {g: _interp(kept, g) for g in GAPS}
    if raw:
        assert "malformed" in res["stderr"]


def _feed(tmp_path, table):
    path = tmp_path / "tc_util.config"
    feed = tc.TcUtilFile(str(path), create=True, reset=True)
    feed.write_calibration(jcal.decode_table(table))
    feed.close()
    return str(path)


def test_a_live_feed_table_takes_precedence_over_the_env(tmp_path):
    feed_table = "0:0,100000:500"
    got, _ = _excess(VTPU_OBS_EXCESS_TABLE=TABLE,
                     VTPU_TC_UTIL_PATH=_feed(tmp_path, feed_table))
    table = jcal.decode_table(feed_table)
    assert got == {g: _interp(table, g) for g in GAPS}


def test_the_feed_table_alone_is_adopted(tmp_path):
    got, _ = _excess(VTPU_TC_UTIL_PATH=_feed(tmp_path, TABLE))
    assert got == {g: _interp(jcal.decode_table(TABLE), g) for g in GAPS}


def _charge_per_launch(**env):
    res = bench_quota.run_fake_harness(
        "--throttle-only", VTPU_CORE_LIMIT_0=50, FAKE_EXEC_US=2000,
        FAKE_SUBMIT_LATENCY_US=300, SHIM_TEST_ITERS=60, **env)
    assert res["rc"] == 0, res["stderr"][-2000:]
    return (res["vtpu_charged_ns_total"] / res["vtpu_launches_total"] / 1e3,
            res)


def test_the_discount_is_capped_at_half_the_sample():
    # every sample of a launch+synchronize loop is isolated: a table that
    # asks 100 ms of each 2.3 ms span discounts half of it
    capped, res = _charge_per_launch(VTPU_OBS_EXCESS_TABLE="0:100000")
    plain, _ = _charge_per_launch(VTPU_OBS_EXCESS_TABLE="0:0")
    assert res["vtpu_probes_total"] == 0
    assert 0.45 * plain <= capped <= 0.55 * plain


def test_without_a_table_the_probe_discounts_as_before():
    probed, res = _charge_per_launch()
    assert res["vtpu_probes_total"] > 0
    # the probe learns the submit latency: the charge is the kernel's time
    assert 1900 <= probed <= 2200


# --- the commands: the calibration at start-up ------------------------------

def _node_flags(root):
    return ["--node-name", "node-1", "--plugin-dir", str(root / "plugins"),
            "--base-dir", str(root / "mgr"),
            "--vmem-path", str(root / "vmem" / "vmem_node.config"),
            "--lock-dir", str(root / "locks"),
            "--watcher-dir", str(root / "watcher"),
            "--driver-dir", str(root / "driver"), "--fake-chips", "1"]


@pytest.mark.parametrize("mode", ["1", "auto"])
def test_device_plugin_calibrates_at_start_up(tmp_path, mode):
    # forced, the calibration runs and finds no card here (no table); auto
    # with fake devices does not run it
    log = _serve_until(
        [sys.executable, "-m", "vtpu_manager_torch.cmd.device_plugin",
         *_node_flags(tmp_path), "--fake-client"],
        "obs-overhead calibration skipped or unavailable",
        {"VTPU_OBS_CALIBRATE": mode})
    assert "obs excess table calibrated" not in log


def test_kubelet_plugin_calibrates_at_start_up(tmp_path):
    import shutil
    import tempfile
    registry = tempfile.mkdtemp(prefix="reg-")
    try:
        log = _serve_until(
            [sys.executable, "-m", "vtpu_manager_torch.cmd.kubelet_plugin",
             *_node_flags(tmp_path), "--registry-dir", registry,
             "--cdi-dir", str(tmp_path / "cdi")],
            "obs-overhead calibration: unavailable",
            {"VTPU_OBS_CALIBRATE": "1"})
    finally:
        shutil.rmtree(registry, ignore_errors=True)
    assert "obs-overhead calibration: unavailable" in log
