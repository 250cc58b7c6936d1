"""The utilization plane in the port against the JAX package.

Each piece runs through both packages on the same inputs, made with numpy
from a seed: the reclaimable-headroom codec (`utilization/headroom.py`:
the bytes, and every decode and score term over a table of fresh, stale,
empty and garbage annotations); the ledger (`utilization/ledger.py`) over
one node directory the port's writers made (configs, step rings with
durations, waits, memory peaks, comm and spill blocks, the watcher's
feed), folded at the same instants several times with records appended
between, with the feed and without it (the ring fallback), and under a
budget of 0; the cluster rollup and its cuts (`utilization/rollup.py`);
the publisher's annotation, which the JAX scheduler's headroom input reads
as it reads the JAX publisher's; the exporter's gate, series and
/utilization route; `tools/vtpu_smi.py`'s text against the JAX script's;
and `vtrace`'s utilization splice.
"""

from __future__ import annotations

import importlib.util
import io
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

import test_torch_device_monitor as tdm
from vtpu_manager.client.fake import FakeKubeClient as JaxFakeKubeClient
from vtpu_manager.util import consts as jc
from vtpu_manager.utilization import headroom as jhr
from vtpu_manager.utilization import ledger as jled
from vtpu_manager.utilization import rollup as jroll
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.clustercache import advertise
from vtpu_manager_torch.config import tc_watcher, vmem
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.device.claims import DeviceClaim, PodDeviceClaims
from vtpu_manager_torch.device.types import ChipSpec, NodeDeviceRegistry
from vtpu_manager_torch.metrics.collector import NodeCollector
from vtpu_manager_torch.overcommit import ratio
from vtpu_manager_torch.telemetry import pressure, stepring
from vtpu_manager_torch.util import consts
from vtpu_manager_torch.util import featuregates as fg
from vtpu_manager_torch.utilization import headroom as hr
from vtpu_manager_torch.utilization import ledger as led
from vtpu_manager_torch.utilization import rollup as roll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2**30
NOW = 1_700_000_000.0
MONO = 5_000.0
NODE = "n1"
CHIPS = [SimpleNamespace(index=i, uuid=f"GPU-{i}") for i in range(2)]
TOL = 1e-9


def test_names_and_constants_are_the_jax_packages():
    assert consts.node_reclaimable_headroom_annotation() == \
        jc.node_reclaimable_headroom_annotation()
    assert fg.FeatureGates().enabled(fg.UTILIZATION_LEDGER) is False
    from vtpu_manager.util import featuregates as jfg
    assert fg.UTILIZATION_LEDGER == jfg.UTILIZATION_LEDGER
    assert jfg.FeatureGates().enabled(jfg.UTILIZATION_LEDGER) is False
    for name in ("EWMA_ALPHA", "BURST_SIGMA_K", "STALENESS_S", "ALLOC_CORE",
                 "USED_CORE", "ALLOC_HBM", "HBM_HW", "WAIT_FRAC",
                 "CONFIDENCE", "RECLAIM_CORE", "RECLAIM_HBM", "RECLAIM_CONF",
                 "FOLDS_DROPPED", "FOLD_SECONDS"):
        assert getattr(led, name) == getattr(jled, name), name
    for name in ("MAX_HEADROOM_AGE_S", "FUTURE_SKEW_TOLERANCE_S",
                 "HEADROOM_TERM_CAP", "MIX_TERM_PER_LENDER", "MIX_TERM_CAP"):
        assert getattr(hr, name) == getattr(jhr, name), name


# --- the headroom codec -------------------------------------------------------

def _headrooms(seed: int):
    """The same seeded rollup as each package's NodeHeadroom."""
    rng = np.random.default_rng(seed)
    chips = {}
    for idx in range(int(rng.integers(0, 4))):
        chips[idx] = (float(rng.uniform(0, 300)), float(rng.uniform(0, 100)),
                      float(rng.uniform(0, 150)), int(rng.integers(0, 2**36)))
    mix = ({k: int(rng.integers(0, 5)) for k in ("thr", "lat", "def")
            if rng.random() < 0.6} if rng.random() < 0.5 else {})
    ts = NOW + float(rng.uniform(-10, 10))

    def build(mod):
        return mod.NodeHeadroom(
            chips={i: mod.ChipHeadroom(*c) for i, c in chips.items()},
            ts=ts, class_mix=mix)
    return build(hr), build(jhr)


@pytest.mark.parametrize("seed", range(12))
def test_encode_is_byte_for_byte(seed):
    mine, theirs = _headrooms(seed)
    assert mine.encode() == theirs.encode()
    assert mine.total_reclaim_core_pct() == theirs.total_reclaim_core_pct()


ANNOTATIONS = [
    None, "", "garbage", "@", "0:1:2:3:4", "0:1:2:3:4@nan", "0:1:2:3:4@inf",
    f"0:50.0:20.0:30.0:1024@{NOW}", f"0:50.0:20.0:30.0:1024@{NOW - 119}",
    f"0:50.0:20.0:30.0:1024@{NOW - 121}", f"0:50.0:20.0:30.0:1024@{NOW + 4}",
    f"0:50.0:20.0:30.0:1024@{NOW + 6}", f"@{NOW}",
    f"0:50.0:20.0:30.0:1024;1:100.0:0.0:90.0:0@{NOW}",
    f"mix=thr:2,lat:1;0:75.0:10.0:60.0:5@{NOW}",
    f"mix=thr:9;0:75.0:10.0:60.0:5@{NOW}",
    f"mix=thr:x;0:75.0:10.0:60.0:5@{NOW}",
    f"mix=lat:3@{NOW}", f"0:nan:1:2:3@{NOW}", f"0:1:2:3@{NOW}",
    f"0:1:2:3:4.5@{NOW}", f"a:1:2:3:4@{NOW}", f"0:-5:-1:-9:-7@{NOW}",
    f"0:1:1:99999:1@{NOW}", f"0:1:2:3:4;;@{NOW}",
    f"0:1:2:3:4@x@{NOW}",
]


def _fields(h):
    if h is None:
        return None
    return ({i: (c.alloc_core_pct, c.used_core_pct, c.reclaim_core_pct,
                 c.reclaim_hbm_bytes) for i, c in h.chips.items()},
            h.ts, dict(h.class_mix))


@pytest.mark.parametrize("raw", ANNOTATIONS)
def test_decodes_and_score_terms_agree(raw):
    for now in (NOW, NOW + 60, NOW + 200):
        mine = hr.parse_headroom(raw, now=now)
        theirs = jhr.parse_headroom(raw, now=now)
        assert _fields(mine) == _fields(theirs)
        for later in (now, now + 100):
            assert hr.headroom_is_fresh(mine, later) == \
                jhr.headroom_is_fresh(theirs, later)
            for fn in ("headroom_score_input", "headroom_score_term",
                       "class_mix_term"):
                assert getattr(hr, fn)(mine, later) == \
                    getattr(jhr, fn)(theirs, later), fn
    for x in (-5.0, 0.0, 12.5, 50.0, 500.0):
        assert hr.headroom_term_from_input(x) == \
            jhr.headroom_term_from_input(x)


# --- one node directory the port's writers made -----------------------------

# tenants: (uid, container label, pod name, workload class,
#           [(host index, hard core %, memory bytes)], ring?)
TENANTS = [
    ("uid-a", "main", "a", vc.WORKLOAD_CLASS_THROUGHPUT,
     [(0, 50, 16 * GIB)], True),
    ("uid-b", "main", "b", vc.WORKLOAD_CLASS_LATENCY,
     [(0, 25, 8 * GIB), (1, 25, 8 * GIB)], True),
    ("uid-c", "side", "c", vc.WORKLOAD_CLASS_NONE,
     [(1, 60, 24 * GIB)], True),
    ("uid-d", "main", "d", vc.WORKLOAD_CLASS_THROUGHPUT,
     [(1, 10, 4 * GIB)], False),
]


class Node:
    """Configs, rings and the feed of one node, written by the port; the
    rng draws every value."""

    def __init__(self, root, seed: int, feed: bool):
        self.root = root
        self.base = str(root / "mgr")
        self.tc_path = str(root / "tc_util.config") if feed else None
        self.rng = np.random.default_rng(seed)
        self.writers = {}
        self.mono_ns = 10**12
        for uid, label, name, cls, devs, ring in TENANTS:
            vc.write_config(
                os.path.join(self.base, f"{uid}_{label}", "config",
                             "vtpu.config"),
                vc.VtpuConfig(pod_uid=uid, container_name=label,
                              pod_name=name, pod_namespace="ns",
                              workload_class=cls,
                              devices=[vc.DeviceConfig(
                                  uuid=f"GPU-{h}", total_memory=mem,
                                  real_memory=80 * GIB, hard_core=core,
                                  memory_limit=True, host_index=h)
                                  for h, core, mem in devs]))
            if ring:
                path = os.path.join(self.base, f"{uid}_{label}",
                                    consts.TELEMETRY_SUBDIR,
                                    consts.STEP_RING_NAME)
                self.writers[uid] = stepring.StepRingWriter(
                    path, trace_id=f"tr-{name}")

    def close(self):
        for w in self.writers.values():
            w.close()

    def append(self, n_max: int = 12) -> None:
        """Seeded records on each ring (some rings get none), then a feed
        that names some tenants."""
        r = self.rng
        for uid, w in self.writers.items():
            for _ in range(int(r.integers(0, n_max))):
                dur = int(r.integers(1_000_000, 30_000_000))
                comm = r.random() < 0.5
                spill = r.random() < 0.3
                w.record(duration_ns=dur,
                         throttle_wait_ns=int(dur * r.uniform(0, 0.9)),
                         hbm_highwater_bytes=int(r.integers(0, 20 * GIB)),
                         start_mono_ns=self.mono_ns,
                         comm_time_ns=int(r.integers(0, dur)) if comm else 0,
                         bytes_transferred=int(r.integers(0, 2**30))
                         if comm else 0,
                         collective_count=int(r.integers(0, 4))
                         if comm else 0,
                         spill_events=int(r.integers(0, 3)) if spill else 0,
                         fill_events=int(r.integers(0, 2)) if spill else 0,
                         spilled_bytes=int(r.integers(0, 4 * GIB))
                         if spill else 0)
                self.mono_ns += dur + int(r.integers(0, 5_000_000))
        if self.tc_path is None:
            return
        tc = tc_watcher.TcUtilFile(self.tc_path, create=True)
        try:
            for chip in CHIPS:
                procs = [tc_watcher.ProcUtil(
                    pid=100 + i, util=int(r.integers(0, 60)), mem_used=0,
                    owner_token=vmem.fnv64(f"{uid}/{label}"))
                    for i, (uid, label, _, _, devs, _) in enumerate(TENANTS)
                    if any(h == chip.index for h, _, _ in devs)
                    and r.random() < 0.6]
                tc.write_device(chip.index, tc_watcher.DeviceUtil(
                    timestamp_ns=1, device_util=50, procs=procs))
        finally:
            tc.close()


def ledgers(node: Node):
    return (led.UtilizationLedger(NODE, CHIPS, base_dir=node.base,
                                  tc_path=node.tc_path),
            jled.UtilizationLedger(NODE, CHIPS, base_dir=node.base,
                                   tc_path=node.tc_path))


def assert_close(a, b, path="doc"):
    """Equal documents, floats within TOL; ints and strings exact."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        assert math.isclose(a, b, rel_tol=0, abs_tol=TOL), (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def _wire(ledger, now):
    doc = ledger.to_wire(now)
    doc.pop("last_fold_s")          # each process's own wall time
    return doc


def _state(ledger):
    """The unrounded EWMA, variance and confidence of every row."""
    return [(s.pod_uid, s.container, s.host_index, s.alloc_core_pct,
             s.alloc_hbm, s.hbm_highwater, s.used_ewma, s.used_var,
             s.wait_frac, s.samples, s.last_sample_wall, s.workload_class)
            for s in ledger.tenants()]


def _masked_render(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(led.FOLD_SECONDS + "{"))


def fold_both(mine, theirs, node, rounds, budget=None):
    for i in range(rounds):
        node.append()
        mono, wall = MONO + 2.5 * i, NOW + 2.5 * i
        assert mine.fold(budget_s=budget, now_mono=mono, now_wall=wall) == \
            theirs.fold(budget_s=budget, now_mono=mono, now_wall=wall)
        yield wall


@pytest.mark.parametrize("feed", [True, False], ids=["feed", "rings"])
@pytest.mark.parametrize("seed", range(4))
def test_ledger_folds_alike(tmp_path, seed, feed):
    node = Node(tmp_path, seed, feed)
    mine, theirs = ledgers(node)
    try:
        for wall in fold_both(mine, theirs, node, 5):
            for now in (wall, wall + 30, wall + 150):
                assert_close(_wire(mine, now), _wire(theirs, now))
                assert_close(mine.chip_rollup(now), theirs.chip_rollup(now))
                assert mine.headroom(now).encode() == \
                    theirs.headroom(now).encode()
                assert mine.render(now) == theirs.render(now) or \
                    _masked_render(mine.render(now)) == \
                    _masked_render(theirs.render(now))
                assert mine.hbm_fraction_samples(now) == \
                    theirs.hbm_fraction_samples(now)
                assert mine.node_spill_signal(now) == \
                    theirs.node_spill_signal(now)
                assert mine.comm_signals(now) == theirs.comm_signals(now)
                assert_close(mine.comm_rows(now), theirs.comm_rows(now))
            assert_close(_state(mine), _state(theirs))
            assert mine.class_mix() == theirs.class_mix()
            for attr in ("spill_events_total", "fill_events_total",
                         "comm_bytes_total", "collectives_total",
                         "folds_dropped_total", "last_fold_wall"):
                assert getattr(mine, attr) == getattr(theirs, attr), attr
        # the source each row's use came from: the feed where it names the
        # tenant, else the ring
        sources = {s.used_source for s in mine.tenants() if s.samples}
        assert sources <= ({"feed", "ring"} if feed else {"ring"})
        assert "ring" in sources
    finally:
        node.close()


@pytest.mark.parametrize("feed", [True, False], ids=["feed", "rings"])
def test_a_zero_budget_drops_rings_alike(tmp_path, feed):
    node = Node(tmp_path, 7, feed)
    mine, theirs = ledgers(node)
    try:
        for wall in fold_both(mine, theirs, node, 6, budget=0.0):
            assert mine.folds_dropped_total == theirs.folds_dropped_total
            assert mine._resume == theirs._resume
            assert_close(_wire(mine, wall), _wire(theirs, wall))
        # one ring a pass: each pass drops the other three
        assert mine.folds_dropped_total == 6 * (len(TENANTS) - 1)
    finally:
        node.close()


def test_a_removed_tenant_leaves_both(tmp_path):
    node = Node(tmp_path, 3, True)
    mine, theirs = ledgers(node)
    try:
        list(fold_both(mine, theirs, node, 2))
        import shutil
        shutil.rmtree(os.path.join(node.base, "uid-c_side"))
        list(fold_both(mine, theirs, node, 1))
        assert {s.pod_uid for s in mine.tenants()} == \
            {s.pod_uid for s in theirs.tenants()} == \
            {"uid-a", "uid-b", "uid-d"}
        assert_close(_wire(mine, NOW + 10), _wire(theirs, NOW + 10))
    finally:
        node.close()


def test_a_fold_beside_the_readers_never_tears_their_iteration(tmp_path):
    """The policy's publisher folds on its thread while Allocate reads the
    same ledger: with a short switch interval and more threads than
    cores, readers beside a folding thread (configs added and removed)
    never see a dict change size under them."""
    import shutil
    import sys
    import threading
    node = Node(tmp_path, 23, True)
    ledger = led.UtilizationLedger(NODE, CHIPS, base_dir=node.base,
                                   tc_path=node.tc_path)
    errors, stop = [], threading.Event()
    spare = os.path.join(node.base, "uid-c_side")
    keep = str(tmp_path / "keep")
    shutil.copytree(spare, keep)

    def fold():
        i = 0
        while not stop.is_set():
            try:
                if i % 2:
                    shutil.rmtree(spare, ignore_errors=True)
                else:
                    shutil.copytree(keep, spare, dirs_exist_ok=True)
                node.append(n_max=3)
                ledger.fold(now_mono=MONO + i, now_wall=NOW + i)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
            i += 1

    def read():
        while not stop.is_set():
            try:
                ledger.hbm_fraction_samples(NOW)
                ledger.node_spill_signal(NOW)
                ledger.class_mix()
                ledger.comm_rows(NOW)
                ledger.to_wire(NOW)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=fold)] + [
        threading.Thread(target=read) for _ in range((os.cpu_count() or 2)
                                                     + 1)]
    try:
        for t in threads:
            t.start()
        threading.Event().wait(2.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
        node.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# --- the publisher, and the JAX scheduler's headroom input ------------------

def test_publisher_writes_what_the_jax_codec_decodes(tmp_path, monkeypatch):
    node = Node(tmp_path, 11, True)
    mine, theirs = ledgers(node)
    try:
        list(fold_both(mine, theirs, node, 3))
        monkeypatch.setattr(led.time, "time", lambda: NOW + 10)
        client = FakeKubeClient()
        client.add_node({"metadata": {"name": NODE, "annotations": {}}})
        published = led.HeadroomPublisher(client, NODE, mine).publish_once()
        raw = client.get_node(NODE)["metadata"]["annotations"][
            consts.node_reclaimable_headroom_annotation()]
        assert raw == published.encode()
        decoded = jhr.parse_headroom(raw, now=NOW + 10)
        want = hr.parse_headroom(published.encode(), now=NOW + 10)
        assert _fields(decoded) == _fields(want)
        assert decoded.ts == round(published.ts, 3)
        assert {i: c.reclaim_hbm_bytes for i, c in decoded.chips.items()} \
            == {i: c.reclaim_hbm_bytes for i, c in published.chips.items()}
        for i, c in decoded.chips.items():
            assert abs(c.reclaim_core_pct
                       - published.chips[i].reclaim_core_pct) <= 0.05
    finally:
        node.close()


def test_jax_scheduler_headroom_input_reads_the_ports_annotation(
        tmp_path, monkeypatch):
    """The JAX scheduler's observe path (`scheduler/filter.py
    _observe_headroom`: `parse_headroom` of the node's annotation, then
    `headroom_score_input`) on the annotation the port's publisher wrote
    gives what it gives on the JAX publisher's over the same node."""
    from vtpu_manager.utilization.ledger import HeadroomPublisher as JPub
    node = Node(tmp_path, 5, True)
    mine, theirs = ledgers(node)
    try:
        list(fold_both(mine, theirs, node, 3))
        # the publishers fold once more themselves, at the same instants
        for mod in (led, jled):
            monkeypatch.setattr(mod.time, "time", lambda: NOW + 20)
            monkeypatch.setattr(mod.time, "monotonic", lambda: MONO + 20)
        raws = []
        for pub_cls, client_cls, ledger in (
                (led.HeadroomPublisher, FakeKubeClient, mine),
                (JPub, JaxFakeKubeClient, theirs)):
            client = client_cls()
            client.add_node({"metadata": {"name": NODE, "annotations": {}}})
            pub_cls(client, NODE, ledger).publish_once()
            raws.append(client.get_node(NODE)["metadata"]["annotations"][
                jc.node_reclaimable_headroom_annotation()])
        assert raws[0] == raws[1]
        got = [jhr.parse_headroom(r, now=NOW + 21) for r in raws]
        assert got[0] is not None
        assert jhr.headroom_score_input(got[0], NOW + 21) == \
            jhr.headroom_score_input(got[1], NOW + 21) > 0
        assert jhr.headroom_score_term(got[0], NOW + 21) == \
            jhr.headroom_score_term(got[1], NOW + 21)
        assert jhr.class_mix_term(got[0], NOW + 21) == \
            jhr.class_mix_term(got[1], NOW + 21) > 0
    finally:
        node.close()


def test_the_jax_filter_observes_the_ports_headroom(tmp_path):
    """A pod placed by the JAX filter with the utilization hint on, onto an
    H100 node whose reclaimable headroom the port published."""
    from vtpu_manager.scheduler.filter import FilterPredicate
    from vtpu_manager_torch.manager.device_manager import DeviceManager
    from vtpu_manager_torch.config.node_config import NodeConfig
    from vtpu_manager_torch.tpu.discovery import FakeBackend

    client = FakeKubeClient(upsert_on_patch=True)
    client.add_node({"metadata": {"name": "gpu-node", "annotations": {}}})
    mgr = DeviceManager("gpu-node", client,
                        node_config=NodeConfig(device_split_count=4),
                        backends=[FakeBackend(1, "nvidia-h100-sxm")])
    mgr.init_devices()
    mgr.register_node()
    chip = mgr.chips[0]
    base = str(tmp_path / "mgr")
    vc.write_config(os.path.join(base, "uid-x_main", "config",
                                 "vtpu.config"),
                    vc.VtpuConfig(pod_uid="uid-x", container_name="main",
                                  devices=[vc.DeviceConfig(
                                      uuid=chip.uuid, total_memory=GIB,
                                      real_memory=chip.memory, hard_core=50,
                                      host_index=chip.index)]))
    tc = str(tmp_path / "tc.config")
    f = tc_watcher.TcUtilFile(tc, create=True)
    f.write_device(chip.index, tc_watcher.DeviceUtil(
        timestamp_ns=1, device_util=10, procs=[tc_watcher.ProcUtil(
            pid=1, util=10, mem_used=0,
            owner_token=vmem.fnv64("uid-x/main"))]))
    f.close()
    published = led.HeadroomPublisher(
        client, "gpu-node",
        led.UtilizationLedger("gpu-node", mgr.chips, base_dir=base,
                              tc_path=tc)).publish_once()
    assert published.chips[chip.index].reclaim_core_pct == 40.0
    jclient = JaxFakeKubeClient()
    jclient.add_node(client.get_node("gpu-node"))
    pod = {"metadata": {"name": "p1", "namespace": "default",
                        "uid": "uid-p1", "annotations": {}},
           "spec": {"containers": [{"name": "main", "resources": {"limits": {
               jc.vtpu_number_resource(): 1, jc.vtpu_cores_resource(): 25,
               jc.vtpu_memory_resource(): 4096}}}]},
           "status": {"phase": "Pending"}}
    jclient.add_pod(pod)
    pred = FilterPredicate(jclient, utilization_hint=True)
    result = pred.filter({"Pod": pod, "NodeNames": ["gpu-node"]})
    assert result.node_names == ["gpu-node"], result
    assert pred.headroom_observed == 1


# --- the rollup --------------------------------------------------------------

def _cluster(client, node: Node, chip_specs, now):
    """Two nodes' annotations and three pods' claims, written by the
    port's codecs; the local node is NODE."""
    for name in (NODE, "n2"):
        reg = NodeDeviceRegistry(chips=chip_specs, mesh_domain="d1")
        anns = {consts.node_device_register_annotation(): reg.encode(),
                consts.node_pressure_annotation():
                    pressure.NodePressure(0.25, 123, now).encode(),
                consts.node_overcommit_annotation():
                    ratio.NodeOvercommit({"thr": 1.5, "def": 1.2}, 0.1,
                                         GIB, now).encode(),
                consts.node_cache_keys_annotation(): advertise.NodeWarmKeys(
                    "10.0.0.1:9394", [("fp1", "a" * 64), ("fp2", "b" * 64)],
                    now).encode()}
        if name == "n2":
            anns[consts.node_reclaimable_headroom_annotation()] = \
                hr.NodeHeadroom({0: hr.ChipHeadroom(50.0, 10.0, 30.0, 7)},
                                ts=now).encode()
        client.add_node({"metadata": {"name": name, "annotations": anns}})
    for uid, pod_name, node_name, claims in (
            ("uid-a", "a", NODE, [("main", 0, 50, 16 * GIB)]),
            ("uid-b", "b", NODE, [("main", 0, 25, 8 * GIB),
                                  ("main", 1, 25, 8 * GIB)]),
            ("uid-r", "r", "n2", [("main", 0, 40, 2 * GIB)])):
        pdc = PodDeviceClaims()
        for container, idx, cores, mem in claims:
            pdc.add(container, DeviceClaim(f"GPU-{idx}", idx, cores, mem))
        client.add_pod({"metadata": {
            "name": pod_name, "namespace": "ns", "uid": uid,
            "annotations": {consts.real_allocated_annotation():
                            pdc.encode()}},
            "spec": {"nodeName": node_name}})


def rollups(node, tmp_path, client_pair, **gates):
    mine, theirs = ledgers(node)
    cache_root = str(tmp_path / "cache")
    return (roll.ClusterRollup(mine, client=client_pair[0],
                               cache_root=cache_root, fold_budget_s=5.0,
                               vmem_path=str(tmp_path / "vmem.config"),
                               **gates),
            jroll.ClusterRollup(theirs, client=client_pair[1],
                                cache_root=cache_root, fold_budget_s=5.0,
                                **gates))


@pytest.fixture
def frozen(monkeypatch, tmp_path):
    """Both packages' ledgers and rollups at the same instants, and the
    JAX rollup's memory ledger (a fixed node path) at the port's."""
    import time as time_mod
    clock = {"wall": NOW + 30, "mono": MONO + 30}
    monkeypatch.setattr(time_mod, "time", lambda: clock["wall"])
    monkeypatch.setattr(time_mod, "monotonic", lambda: clock["mono"])
    monkeypatch.setattr(jc, "VMEM_NODE_CONFIG", str(tmp_path / "vmem.config"))
    ledger = vmem.VmemLedger(str(tmp_path / "vmem.config"), create=True)
    ledger.record(10, 0, GIB, owner_token=vmem.fnv64("uid-a/main"))
    ledger.record_spilled(10, 0, 3 * GIB,
                          owner_token=vmem.fnv64("uid-a/main"))
    ledger.close()
    return clock


@pytest.mark.parametrize("gates", [
    {}, {"overcommit": True}, {"cluster_cache": True}, {"comm": True},
    {"overcommit": True, "cluster_cache": True, "comm": True}],
    ids=["off", "overcommit", "cache", "comm", "all"])
@pytest.mark.parametrize("with_client", [True, False],
                         ids=["cluster", "local"])
def test_rollup_documents_agree(tmp_path, frozen, gates, with_client):
    node = Node(tmp_path, 21, True)
    try:
        clients = (FakeKubeClient(), JaxFakeKubeClient())
        specs = [ChipSpec(uuid=f"GPU-{i}", index=i,
                          chip_type="nvidia-h100-sxm", memory=80 * GIB,
                          split_count=4) for i in range(2)]
        for c in clients:
            _cluster(c, node, specs, NOW)
        mine, theirs = rollups(node, tmp_path,
                               clients if with_client else (None, None),
                               **gates)
        for i in range(3):
            node.append()
            frozen["wall"] += 2.0
            frozen["mono"] += 2.0
            a = mine.collect(now=frozen["wall"])
            b = theirs.collect(now=frozen["wall"])
            for doc in (a, b):
                doc["node"].pop("last_fold_s")
            assert_close(a, b)
        assert a["errors"] == []
        if with_client:
            assert len(a["nodes"]) == 2 and a["cluster"]["nodes"] == 2
            assert {t["pod_uid"] for t in a["tenants"]} >= {
                "uid-a", "uid-b", "uid-r"}
            for cut in ({"node": NODE}, {"node": "n2"}, {"pod": "a"},
                        {"pod": "uid-b"}, {"node": NODE, "pod": "r"}, {}):
                assert roll.filter_document(a, **cut) == \
                    jroll.filter_document(a, **cut)
        if gates.get("overcommit") and with_client:
            local = next(n for n in a["nodes"] if n["local"])
            assert local["chips"][0]["spilled_bytes"] == 3 * GIB
    finally:
        node.close()


class _FailingClient(FakeKubeClient):
    def list_nodes(self, *a, **kw):
        raise RuntimeError("apiserver down")

    def list_pods(self, *a, **kw):
        raise RuntimeError("apiserver down")


class _JaxFailingClient(JaxFakeKubeClient):
    def list_nodes(self, *a, **kw):
        raise RuntimeError("apiserver down")

    def list_pods(self, *a, **kw):
        raise RuntimeError("apiserver down")


def test_a_failed_listing_is_said_alike(tmp_path, frozen):
    node = Node(tmp_path, 2, False)
    try:
        mine, theirs = rollups(node, tmp_path,
                               (_FailingClient(), _JaxFailingClient()))
        node.append()
        a, b = mine.collect(now=NOW + 31), theirs.collect(now=NOW + 31)
        for doc in (a, b):
            doc["node"].pop("last_fold_s")
        assert_close(a, b)
        assert a["errors"] == ["list_nodes: apiserver down",
                               "list_pods: apiserver down"]
        assert a["tenants"] and all(t["live"] for t in a["tenants"])
    finally:
        node.close()


# --- the splice ----------------------------------------------------------------

@pytest.mark.parametrize("key", ["uid-a", "tr-b", "uid-c", "tr-c", "nobody"])
def test_utilization_stats_for_pod_agrees(tmp_path, key):
    node = Node(tmp_path, 13, False)
    try:
        node.append(n_max=40)
        node.append(n_max=40)
        mine = led.utilization_stats_for_pod(node.base, key)
        theirs = jled.utilization_stats_for_pod(node.base, key)
        assert_close(mine, theirs)
        assert (mine != []) == (key != "nobody")
    finally:
        node.close()


def test_vtrace_splices_the_pods_utilization(tmp_path):
    """Both vtrace CLIs on one spool and ring directory: the pod's
    utilization rows in `--json` and its `utilization [...]` lines."""
    from test_torch_trace import JAX_VTRACE, PORT_VTRACE, _cli
    from vtpu_manager.trace.recorder import Span as JaxSpan
    from vtpu_manager.trace.recorder import SpanRecorder
    node = Node(tmp_path, 19, False)
    try:
        node.append(n_max=30)
    finally:
        node.close()
    spool = tmp_path / "trace"
    rec = SpanRecorder("plugin", str(spool), capacity=8, flush_at=99)
    rec.record(JaxSpan(stage="plugin.allocate", trace_id="tr-b",
                       pod_uid="uid-b", start_s=1.0, dur_s=0.004))
    rec.flush()
    common = ["--spool-dir", str(spool), "--steps-dir", node.base,
              "--pod", "uid-b"]
    jax_extra = ["--explain-dir", str(tmp_path / "no-explain")]
    mine = _cli(PORT_VTRACE + common + ["--json"])
    theirs = _cli(JAX_VTRACE + common + ["--json"] + jax_extra)
    assert mine.returncode == theirs.returncode == 0, \
        mine.stderr + theirs.stderr
    rows = json.loads(mine.stdout)["utilization"]
    assert rows == json.loads(theirs.stdout)["utilization"]
    assert [r["pod_uid"] for r in rows] == ["uid-b"]
    assert rows == led.utilization_stats_for_pod(node.base, "tr-b")
    texts = [_cli(argv).stdout for argv in
             (PORT_VTRACE + common, JAX_VTRACE + common + jax_extra)]
    lines = [[ln for ln in t.splitlines() if ln.startswith("  utilization")]
             for t in texts]
    assert lines[0] == lines[1] and len(lines[0]) == 1


# --- U1: the rings alone read a throttled tenant's share ---------------------

@pytest.mark.parametrize("quota", [50, 25])
def test_a_throttled_tenants_ring_reads_its_share(tmp_path, quota):
    """ROADMAP U1's pin on the fake driver: a tenant of 4 kernels a step
    at a quota, its ring written by the interposer. A launch that waits in
    the bucket while the step's earlier kernels still run holds nothing
    back, so the rings-only read of its use (the ledger's fallback formula,
    (duration - wait) over the records' span) is the kernels' share of the
    card, not the few percent that the bucket's whole wait leaves."""
    from vtpu_manager_torch import bench_quota
    exec_us, kernels = 2000, 4
    entry = tmp_path / "mgr" / "uid-u_main"
    vc.write_config(str(entry / "config" / "vtpu.config"), vc.VtpuConfig(
        pod_uid="uid-u", container_name="main", devices=[vc.DeviceConfig(
            uuid="GPU-0", total_memory=GIB, real_memory=80 * GIB,
            hard_core=quota, host_index=0)]))
    ring = entry / consts.TELEMETRY_SUBDIR / consts.STEP_RING_NAME
    ring.parent.mkdir()
    res = bench_quota.run_fake_harness(
        "--steps", timeout=120, FAKE_EXEC_US=exec_us,
        VTPU_CORE_LIMIT_0=quota, SHIM_TEST_ITERS=40,
        SHIM_TEST_KERNELS=kernels, SHIM_TEST_SYNC="stream",
        **{consts.ENV_STEP_TELEMETRY: "true",
           consts.ENV_STEP_RING_PATH: str(ring)})
    assert res["rc"] == 0, res["stderr"][-2000:]
    reader = stepring.StepRingReader(str(ring))
    records, _, _ = reader.poll(0)
    reader.close()
    span_s = (records[-1].start_mono_ns + records[-1].duration_ns
              - records[0].start_mono_ns) / 1e9
    taken = 100.0 * len(records) * kernels * exec_us / 1e6 / span_s
    (row,) = led.utilization_stats_for_pod(str(tmp_path / "mgr"), "uid-u")
    assert abs(taken - quota) <= 8.0, taken
    assert abs(row["used_core_pct"] - taken) <= 8.0, (row, taken)
    # the JAX fold reads the same row but for the wait fraction: the
    # records carry the bucket's wait apart (stepring.FLAG_BUCKET_WAIT),
    # which the port's row gives and the JAX one, reading the time off
    # the card, does not
    (theirs,) = jled.utilization_stats_for_pod(str(tmp_path / "mgr"),
                                               "uid-u")
    dur = sum(r.duration_ns for r in records)
    assert any(r.flags & stepring.FLAG_BUCKET_WAIT for r in records)
    assert row["throttle_wait_frac"] == round(
        sum(r.bucket_wait_ns for r in records) / dur, 4)
    assert theirs["throttle_wait_frac"] == round(
        sum(r.throttle_wait_ns for r in records) / dur, 4)
    assert {**row, "throttle_wait_frac": None} == {
        **theirs, "throttle_wait_frac": None}


def test_a_time_sliced_tenants_ring_reads_its_charged_card_time(tmp_path):
    """On the fake driver's time-sliced card (FAKE_TIMESLICE_US), a 90 %
    tenant of two 2 ms kernels a step beside a 50 % co-tenant of 12 ms
    kernels that keeps the card busy: the tenant's kernels wait behind the
    co-tenant's slices, so its steps last about twice their card time
    while its bucket hardly waits (the card, not its quota, bounds it), as
    the card's idle pod waits behind its co-tenants. A charged step's wait
    is its time off the card, so its ring reads the card time the
    interposer charged it, where duration less the bucket's wait would
    read it near 100. (How close that charge is to the kernels' time in
    this configuration is the interposer's own matter: ROADMAP Queue 3,
    C1.)"""
    import shutil
    import subprocess
    import time
    from test_torch_timeslice import BusySampler
    from vtpu_manager_torch import bench_quota, build
    from vtpu_manager_torch.manager.watcher import TcWatcherDaemon
    exec_us, kernels = 2000, 2
    shim, fake = str(build.build_shim()), str(build.build_fake_driver())
    world = bench_quota.World(str(tmp_path / "node"))
    state = tmp_path / "card.state"
    state.write_bytes(b"\0" * 16)
    entry = tmp_path / "mgr" / "uid-idle_main"
    ring = entry / consts.TELEMETRY_SUBDIR / consts.STEP_RING_NAME
    ring.parent.mkdir(parents=True)

    def env_for(uid, exec_us, quota, **extra):
        env = world.env(shim, uid, hard_core=quota)
        env.update({"SHIM_PATH": env["LD_PRELOAD"],
                    "VTPU_REAL_CUDA_LIBRARY_PATH": fake,
                    "FAKE_SHARED_STATE": str(state),
                    "FAKE_EXEC_US": str(exec_us),
                    "FAKE_TIMESLICE_US": "2000", **extra})
        return env
    watcher = TcWatcherDaemon([0], BusySampler(str(state), fake),
                              tc_path=world.tc_path,
                              vmem_path=world.vmem_path, interval_ms=20)
    watcher.start()
    busy = None
    try:
        busy = subprocess.Popen(
            [str(build.build_shim_test()), "--throttle-only"],
            env=env_for("uid-busy", 12_000, 50, SHIM_TEST_ITERS="150"),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        time.sleep(0.3)
        env = env_for("uid-idle", exec_us, 90, SHIM_TEST_ITERS="100",
                      SHIM_TEST_KERNELS=str(kernels), SHIM_TEST_SYNC="stream",
                      **{consts.ENV_STEP_TELEMETRY: "true",
                         consts.ENV_STEP_RING_PATH: str(ring)})
        res = subprocess.run([str(build.build_shim_test()), "--steps"],
                             env=env, capture_output=True, text=True,
                             timeout=120, check=False)
        assert res.returncode == 0, res.stderr[-2000:]
        assert busy.poll() is None      # the co-tenant ran throughout
    finally:
        if busy is not None:
            busy.kill()
            busy.wait()
        watcher.stop()
    (entry / "config").mkdir()
    shutil.copy(env[consts.ENV_CONFIG_PATH],
                entry / "config" / "vtpu.config")
    reader = stepring.StepRingReader(str(ring))
    records, _, _ = reader.poll(0)
    reader.close()
    span_s = (records[-1].start_mono_ns + records[-1].duration_ns
              - records[0].start_mono_ns) / 1e9
    card_ns = kernels * exec_us * 1000
    taken = 100.0 * len(records) * card_ns / 1e9 / span_s
    durs = sorted(r.duration_ns for r in records)
    # the slices show: a step lasts well over its card time
    assert durs[len(durs) // 2] >= 1.3 * card_ns, durs
    # the bucket hardly waited: the records' waits are the steps' time
    # off the card, which is the interposer's step-wait counter
    counters = bench_quota.parse_harness(res.stdout)
    assert counters["vtpu_throttle_wait_ns_total"] \
        < 0.2 * sum(durs) < counters["vtpu_step_wait_ns_total"]
    charged = 100.0 * counters["vtpu_charged_ns_total"] / 1e9 / span_s
    (row,) = led.utilization_stats_for_pod(str(tmp_path / "mgr"), "uid-idle")
    assert abs(row["used_core_pct"] - charged) <= 2.0, (row, charged, taken)
    assert row["used_core_pct"] <= taken + 8.0, (row, taken)


def test_the_python_writer_takes_a_charged_steps_time_off_the_card(
        tmp_path):
    """The tenant's own writer takes a charged step's wait from the
    interposer's charged device time, as the interposer's records do; a
    step charged nothing (unmetered) keeps the bucket's wait."""
    from vtpu_manager_torch.runtime import client as rc
    waits = iter([0, 9_000, 9_000, 9_000, 30_000, 30_000])
    charged = iter([0, 6_000, 6_000, 10_000, 13_000, 12_000])
    ring = stepring.StepRingWriter(str(tmp_path / "ring"))
    w = rc._ShimWaitStepRing(ring, lambda: next(waits),
                             charged_fn=lambda: next(charged))
    w.record(duration_ns=12_000)     # bucket 9000, on card 6000: 6000
    w.record(duration_ns=12_000)     # charged nothing: the bucket's 0
    w.record(duration_ns=20_000)     # bucket 0, on card 4000: 16000
    w.record(duration_ns=24_000)     # bucket 21000, on card 3000: 21000
    w.record(duration_ns=5_000, throttle_wait_ns=77)   # the caller's
    reader = stepring.StepRingReader(str(tmp_path / "ring"))
    recs, _, _ = reader.poll(0)
    reader.close()
    w.close()
    assert [r.throttle_wait_ns for r in recs] == [6_000, 0, 16_000, 21_000,
                                                  77]


# --- vtpu-smi ------------------------------------------------------------------

def _jax_smi():
    spec = importlib.util.spec_from_file_location(
        "jax_vtpu_smi", os.path.join(REPO, "scripts", "vtpu_smi.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("gates", [{}, {"overcommit": True,
                                        "cluster_cache": True,
                                        "comm": True}], ids=["off", "all"])
def test_vtpu_smi_renders_as_the_jax_script(tmp_path, frozen, gates):
    from vtpu_manager_torch.tools import vtpu_smi
    node = Node(tmp_path, 17, True)
    try:
        clients = (FakeKubeClient(), JaxFakeKubeClient())
        specs = [ChipSpec(uuid=f"GPU-{i}", index=i, memory=80 * GIB,
                          split_count=4) for i in range(2)]
        _cluster(clients[0], node, specs, NOW)
        mine, _ = rollups(node, tmp_path, clients, **gates)
        node.append()
        doc = json.loads(json.dumps(mine.collect(now=NOW + 31)))
    finally:
        node.close()
    texts = []
    for render in (vtpu_smi.render, _jax_smi().render):
        out = io.StringIO()
        render(doc, out=out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert "POD" in texts[0] and "ns/a" in texts[0]
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(doc))
    for cut in ([], ["--node", "n2"], ["--pod", "b"]):
        outs = []
        for mod in (vtpu_smi, _jax_smi()):
            import contextlib
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert mod.main(["--from-file", str(path), *cut]) == 0
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
    assert vtpu_smi.main(["--from-file", str(tmp_path / "absent")]) == 1
    assert vtpu_smi.main(["--from-file", str(path), "--watch", "1"]) == 2


# --- the collector and the exporter -----------------------------------------

def test_collector_renders_the_jax_collectors_families(tmp_path):
    """With the gate on both collectors render the same utilization
    families and feed flag; off, neither renders any."""
    from vtpu_manager.metrics.collector import NodeCollector as JCollector
    node = Node(tmp_path, 9, True)
    try:
        kw = dict(base_dir=node.base, tc_path=node.tc_path,
                  vmem_path=str(tmp_path / "no-vmem"),
                  pod_resources_socket=str(tmp_path / "none.sock"),
                  kubelet_checkpoint=str(tmp_path / "no-ckpt"))
        for on in (False, True):
            mine = NodeCollector(NODE, CHIPS_SPEC, utilization_enabled=on,
                                 **kw)
            theirs = JCollector(NODE, CHIPS_SPEC_J, utilization_enabled=on,
                                **kw)
            node.append()
            texts = (mine.render(), theirs.render())
            fams = [{ln.split()[2] for ln in t.splitlines()
                     if ln.startswith("# TYPE") and ln.split()[2].startswith(
                         ("vtpu_utilization_", "vtpu_reclaimable_"))}
                    for t in texts]
            assert fams[0] == fams[1]
            assert len(fams[0]) == (11 if on else 0)
            assert ('feed="utilization"' in texts[0]) == on == \
                ('feed="utilization"' in texts[1])
            # allocations do not depend on the fold's instant
            for name in (led.ALLOC_CORE, led.ALLOC_HBM):
                rows = [sorted(ln for ln in t.splitlines()
                               if ln.startswith(name + "{")) for t in texts]
                assert rows[0] == rows[1] and bool(rows[0]) == on
    finally:
        node.close()


CHIPS_SPEC = [ChipSpec(uuid=f"GPU-{i}", index=i, memory=80 * GIB)
              for i in range(2)]


def _jax_chips():
    from vtpu_manager.device.types import ChipSpec as JChipSpec
    return [JChipSpec(uuid=f"GPU-{i}", index=i, memory=80 * GIB)
            for i in range(2)]


CHIPS_SPEC_J = _jax_chips()


def _series(text: str) -> dict[str, float]:
    out = {}
    for ln in text.splitlines():
        if ln.startswith(("vtpu_utilization_", "vtpu_reclaimable_")) and \
                not ln.startswith(led.FOLD_SECONDS):
            key, _, val = ln.rpartition(" ")
            out[key] = float(val)
    return out


@pytest.fixture
def util_node(tmp_path):
    tdm.node_dir(tmp_path)
    return tmp_path


def test_exporter_serves_utilization_under_the_gate(util_node, monkeypatch):
    root = util_node
    (root / "token").write_text(tdm.TOKEN + "\n")
    exp = tdm.Exporter(root, "--metrics-token-file", str(root / "token"),
                       "--feature-gates", "UtilizationLedger=true",
                       "--fake-client")
    try:
        status, body, ctype = exp.get("/utilization", token=tdm.TOKEN)
        assert status == 200 and ctype.startswith("application/json")
        doc = json.loads(body)
        rows = {t["pod_uid"]: t for t in doc["tenants"]}
        assert set(rows) == {"uid-a", "uid-b", "bogus-uid"}
        assert rows["uid-a"]["allocated_core_pct"] == 50.0
        assert rows["uid-a"]["allocated_hbm_bytes"] == 2**30
        assert rows["uid-a"]["trace_id"] == "tr-a"
        assert doc["errors"] == [] and doc["nodes"] == []
        assert exp.get("/utilization", token=None)[:2] == (
            401, '{"error": "unauthorized"}')
        assert exp.get("/utilization", token="wrong")[0] == 401
        one = json.loads(exp.get("/utilization?pod=uid-b",
                                 token=tdm.TOKEN)[1])
        assert [t["pod_uid"] for t in one["tenants"]] == ["uid-b"]
        none = json.loads(exp.get("/utilization?node=elsewhere",
                                  token=tdm.TOKEN)[1])
        assert none["tenants"] == [] and none["nodes"] == []
        metrics = exp.get("/metrics", token=tdm.TOKEN)[1]
        series = _series(metrics)
        assert series[f'{led.ALLOC_CORE}{{node="n1",pod_uid="uid-a",'
                      f'container="main",uuid="fake-0"}}'] == 50
        assert 'vtpu_node_scrape_last_error{node="n1",feed="utilization"} ' \
            '0.0' in metrics
        # the series and the document from the same fold
        by_row = {(t["pod_uid"], t["container"]): t for t in doc["tenants"]}
        for (uid, cont), t in by_row.items():
            lab = (f'{{node="n1",pod_uid="{uid}",container="{cont}",'
                   f'uuid="fake-0"}}')
            assert series[led.ALLOC_HBM + lab] == t["allocated_hbm_bytes"]
            assert series[led.HBM_HW + lab] == t["hbm_highwater_bytes"]
    finally:
        assert exp.stop() == 0


def test_a_failed_rollup_answers_503(util_node, monkeypatch):
    root = util_node
    env = tdm._env()
    env["VTPU_FAILPOINTS"] = "util.rollup=error(503)"
    monkeypatch.setattr(tdm, "_env", lambda: env)
    exp = tdm.Exporter(root, "--feature-gates",
                       "UtilizationLedger=true,FaultInjection=true")
    try:
        status, body, _ = exp.get("/utilization")
        assert status == 503
        assert json.loads(body)["error"].startswith(
            "utilization rollup failed:")
        # the scrape path never runs the rollup
        assert exp.get("/metrics")[0] == 200
    finally:
        assert exp.stop() == 0


def test_gate_off_has_no_route_and_no_series(util_node):
    exp = tdm.Exporter(util_node)
    try:
        assert exp.get("/utilization")[0] == 404
        metrics = exp.get("/metrics")[1]
        assert "vtpu_utilization_" not in metrics
        assert "vtpu_reclaimable_" not in metrics
        assert 'feed="utilization"' not in metrics
    finally:
        assert exp.stop() == 0


def test_device_plugin_publishes_the_headroom(tmp_path):
    from vtpu_manager_torch.cmd import device_plugin as dp
    base = str(tmp_path / "mgr")
    vc.write_config(os.path.join(base, "uid-a_main", "config",
                                 "vtpu.config"),
                    vc.VtpuConfig(pod_uid="uid-a", container_name="main",
                                  devices=[vc.DeviceConfig(
                                      uuid="GPU-0", total_memory=GIB,
                                      real_memory=80 * GIB, hard_core=30,
                                      host_index=0)]))
    client = FakeKubeClient()
    client.add_node({"metadata": {"name": NODE, "annotations": {}}})
    pub = dp.start_headroom(client, NODE, CHIPS_SPEC, base,
                            str(tmp_path / "no-feed"), interval_s=0.05)
    try:
        import time as time_mod
        deadline = time_mod.monotonic() + 10
        raw = None
        while raw is None and time_mod.monotonic() < deadline:
            raw = client.get_node(NODE)["metadata"]["annotations"].get(
                consts.node_reclaimable_headroom_annotation())
            time_mod.sleep(0.02)
    finally:
        pub.stop()
    got = jhr.parse_headroom(raw)
    assert got is not None and got.chips[0].alloc_core_pct == 30.0
    # no sample yet: no signal, nothing reclaimable
    assert got.chips[0].reclaim_core_pct == 0.0
