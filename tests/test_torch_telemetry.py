"""The port's ring consumers, pressure annotation, kubelet checkpoint reader,
reporters and trace reader against the JAX package's.

The aggregate and publisher cases of tests/test_telemetry.py run on the
same rings (written by the port's tenant-side writer) through both
packages, whose renders and annotations must be equal; the JAX
`parse_pressure` decodes the port's annotation (the scheduler reads what
the port writes). Then the checkpoint and reporter cases of
tests/test_deviceplugin.py, and the trace cases of tests/test_trace.py on
spools the JAX `SpanRecorder` wrote.
"""

import json
import os
import shutil
from random import Random
from types import SimpleNamespace

import pytest

from vtpu_manager.client.fake import FakeKubeClient as JaxFakeKubeClient
from vtpu_manager.device.types import ChipSpec as JaxChipSpec
from vtpu_manager.deviceplugin import checkpoint as jckpt
from vtpu_manager.deviceplugin import reporters as jrep
from vtpu_manager.resilience.policy import RetryPolicy as JaxRetryPolicy
from vtpu_manager.telemetry import aggregate as jagg
from vtpu_manager.telemetry import pressure as jpressure
from vtpu_manager.trace import assemble as jassemble
from vtpu_manager.trace.metrics import render_trace_metrics as jax_render
from vtpu_manager.trace.recorder import Span as JaxSpan
from vtpu_manager.trace.recorder import SpanRecorder
from vtpu_manager.util import consts as jc
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.deviceplugin import checkpoint as ckpt
from vtpu_manager_torch.deviceplugin.reporters import VcorePlugin, VmemPlugin
from vtpu_manager_torch.manager.device_manager import DeviceManager
from vtpu_manager_torch.resilience.policy import RetryPolicy
from vtpu_manager_torch.telemetry import TenantStepTelemetry
from vtpu_manager_torch.telemetry import aggregate, pressure, stepring
from vtpu_manager_torch.tpu.discovery import FakeBackend
from vtpu_manager_torch.trace import assemble
from vtpu_manager_torch.trace.metrics import render_trace_metrics
from vtpu_manager_torch.trace.recorder import Span, reap_stale_spools
from vtpu_manager_torch.util import consts


def _ring(base, pod_uid, container, trace_id=""):
    d = os.path.join(base, f"{pod_uid}_{container}", consts.TELEMETRY_SUBDIR)
    os.makedirs(d, exist_ok=True)
    return stepring.StepRingWriter(os.path.join(d, consts.STEP_RING_NAME),
                                   trace_id=trace_id)


class Both:
    """One node's rings folded by both packages' aggregators."""

    def __init__(self, base):
        self.port = aggregate.TenantStepTelemetry(base)
        self.jax = jagg.TenantStepTelemetry(base)

    def scan(self):
        assert self.port.scan() == self.jax.scan()

    def render(self, node="n1") -> str:
        text = self.port.render(node)
        assert text == self.jax.render(node)
        return text

    def render_pressure(self, node, total) -> str:
        text = self.port.render_pressure(node, total)
        assert text == self.jax.render_pressure(node, total)
        return text


# --- aggregate ----------------------------------------------------------------

def test_fold_and_render(tmp_path):
    base = str(tmp_path / "mgr")
    w = _ring(base, "uid-1", "main", trace_id="tr-1")
    for i in range(20):
        w.record(duration_ns=10_000_000, throttle_wait_ns=5_000_000,
                 hbm_highwater_bytes=1 << 30, compiled=(i == 0))
    agg = Both(base)
    agg.scan()
    text = agg.render()
    labels = '{node="n1",pod_uid="uid-1",container="main"}'
    assert f"vtpu_tenant_step_duration_seconds_count{labels} 20" in text
    assert f"vtpu_tenant_step_duration_seconds_sum{labels} 0.2" in text
    assert f"vtpu_tenant_throttle_wait_seconds_count{labels} 20" in text
    assert f"vtpu_tenant_throttle_wait_fraction{labels} 0.5" in text
    assert f"vtpu_tenant_step_ring_dropped_total{labels} 0" in text
    assert 'trace_id="tr-1"' in text
    assert "vtpu_tenant_comm_" not in text
    agg.scan()
    assert f"_count{labels} 20" in agg.render()
    w.record(duration_ns=1)
    agg.scan()
    assert f"vtpu_tenant_step_duration_seconds_count{labels} 21" in \
        agg.port.render("n1")
    w.close()


def test_overwrite_drops_surface(tmp_path):
    base = str(tmp_path / "mgr")
    w = _ring(base, "uid-1", "main")
    agg = Both(base)
    agg.scan()
    for _ in range(stepring.RING_CAPACITY + 30):
        w.record(duration_ns=1000)
    agg.scan()
    for text in (agg.port.render("n1"), agg.jax.render("n1")):
        assert ('vtpu_tenant_step_ring_dropped_total{node="n1",'
                'pod_uid="uid-1",container="main"} 30') in text
    w.close()


def test_steps_per_second_counts_lapped_records():
    for mod in (aggregate, jagg):
        state = mod._TenantState("u", "c")
        state.fold([], 0, now_monotonic=100.0)
        recs = [stepring.StepRecord(i, 0, 1000)
                for i in range(stepring.RING_CAPACITY)]
        state.fold(recs, 144, now_monotonic=101.0)
        assert state.window_rate == pytest.approx(
            stepring.RING_CAPACITY + 144)
        assert state.dropped == 144


def test_first_poll_baselines_history_not_drops(tmp_path):
    base = str(tmp_path / "mgr")
    w = _ring(base, "uid-1", "main")
    for _ in range(stepring.RING_CAPACITY + 500):
        w.record(duration_ns=1000)
    agg = Both(base)
    agg.scan()
    assert ('vtpu_tenant_step_ring_dropped_total{node="n1",'
            'pod_uid="uid-1",container="main"} 0') in agg.render()
    for _ in range(stepring.RING_CAPACITY + 40):
        w.record(duration_ns=1000)
    agg.scan()
    assert ('vtpu_tenant_step_ring_dropped_total{node="n1",'
            'pod_uid="uid-1",container="main"} 40') in agg.port.render("n1")
    w.close()


def test_pressure_rollup(tmp_path):
    base = str(tmp_path / "mgr")
    for uid, frac in (("uid-a", 0.25), ("uid-b", 0.75)):
        w = _ring(base, uid, "main")
        for _ in range(5):
            w.record(duration_ns=1_000_000,
                     throttle_wait_ns=int(1_000_000 * frac),
                     hbm_highwater_bytes=100)
        w.close()
    agg = Both(base)
    agg.scan()
    frac, headroom = agg.port.pressure(node_hbm_total=1000)
    assert (frac, headroom) == agg.jax.pressure(node_hbm_total=1000)
    assert frac == pytest.approx(0.75)
    assert headroom == 800
    text = agg.render_pressure("n1", 1000)
    assert 'vtpu_node_pressure_throttle_frac{node="n1"} 0.75' in text
    assert 'vtpu_node_pressure_hbm_headroom_bytes{node="n1"} 800' in text


def test_step_stats_for_pod_as_jax(tmp_path):
    base = str(tmp_path / "mgr")
    w = _ring(base, "uid-1", "main", trace_id="tr-1")
    for i in range(9):
        w.record(duration_ns=(i + 1) * 10**6, throttle_wait_ns=i * 10**5,
                 hbm_highwater_bytes=i << 20, compiled=(i == 0))
    w.close()
    _ring(base, "uid-2", "main").close()
    for keys in (("",), ("uid-1",), ("tr-1",), ("uid-other",),
                 ("uid-1", "tr-1")):
        assert aggregate.step_stats_for_pod(base, *keys) == \
            jagg.step_stats_for_pod(base, *keys)
    assert aggregate.step_stats_for_pod(base, "") == []
    (row,) = aggregate.step_stats_for_pod(base, "tr-1")
    assert (row["steps_total"], row["compile_steps"]) == (9, 1)


def test_vanished_tenant_series_removed(tmp_path):
    base = str(tmp_path / "mgr")
    w = _ring(base, "uid-1", "main")
    w.record(duration_ns=1)
    w.close()
    agg = Both(base)
    agg.scan()
    assert 'pod_uid="uid-1"' in agg.render()
    shutil.rmtree(os.path.join(base, "uid-1_main"))
    agg.scan()
    assert 'pod_uid="uid-1"' not in agg.render()


@pytest.mark.parametrize("comm", [False, True])
def test_comm_block_renders_only_when_on(tmp_path, comm):
    """The port's tenants write the comm block as zeros, so the exporter
    keeps `comm` off; on, a ring that carries the block renders the JAX
    package's comm families."""
    base = str(tmp_path / "mgr")
    for uid, carried in (("uid-1", True), ("uid-2", False)):
        w = _ring(base, uid, "main")
        for i in range(6):
            w.record(duration_ns=4_000_000, throttle_wait_ns=10**6,
                     comm_time_ns=10**6 * i if carried else 0,
                     bytes_transferred=(1 << 20) * i if carried else 0,
                     collective_count=i if carried else 0)
        w.close()
    port = aggregate.TenantStepTelemetry(base, comm=comm)
    jax = jagg.TenantStepTelemetry(base, comm=comm)
    port.scan()
    jax.scan()
    text = port.render("n1")
    assert text == jax.render("n1")
    assert ("vtpu_tenant_comm_time_seconds_count{node=\"n1\","
            "pod_uid=\"uid-1\",container=\"main\"} 5" in text) == comm
    assert 'vtpu_tenant_comm_time_fraction{node="n1",pod_uid="uid-2"' \
        not in text


def test_telemetry_package_exports_the_aggregator():
    assert TenantStepTelemetry is aggregate.TenantStepTelemetry


# --- the publisher and the codec ------------------------------------------

def _published(tmp_path, mod_pressure, client, agg, policy):
    pub = mod_pressure.PressurePublisher(client, "n1", agg,
                                         node_hbm_total=1000, policy=policy)
    published = pub.publish_once()
    raw = client.get_node("n1")["metadata"]["annotations"][
        consts.node_pressure_annotation()]
    return published, raw


def test_publish_once_patches_node_annotation_as_jax(tmp_path):
    base = str(tmp_path / "mgr")
    w = _ring(base, "uid-1", "main")
    for _ in range(4):
        w.record(duration_ns=1_000_000, throttle_wait_ns=400_000,
                 hbm_highwater_bytes=100)
    w.close()
    out = {}
    for side, mod, client_cls, agg_cls, pol in (
            ("torch", pressure, FakeKubeClient,
             aggregate.TenantStepTelemetry, RetryPolicy),
            ("jax", jpressure, JaxFakeKubeClient,
             jagg.TenantStepTelemetry, JaxRetryPolicy)):
        client = client_cls(upsert_on_patch=True)
        client.add_node({"metadata": {"name": "n1", "annotations": {}}})
        out[side] = _published(tmp_path, mod, client, agg_cls(base),
                               pol(rng=Random(1), sleep=lambda s: None))
    (p_t, raw_t), (p_j, raw_j) = out["torch"], out["jax"]
    assert consts.node_pressure_annotation() == jc.node_pressure_annotation()
    assert (p_t.throttle_frac, p_t.hbm_headroom_bytes) == \
        (p_j.throttle_frac, p_j.hbm_headroom_bytes)
    assert raw_t.split("@")[0] == raw_j.split("@")[0] == "0.4000:900"
    # the scheduler's decoder reads what the port wrote
    got = jpressure.parse_pressure(raw_t)
    assert got is not None
    assert got.throttle_frac == pytest.approx(0.4)
    assert got.hbm_headroom_bytes == 900
    ours = pressure.parse_pressure(raw_t)
    assert (ours.throttle_frac, ours.hbm_headroom_bytes, ours.ts) == \
        (got.throttle_frac, got.hbm_headroom_bytes, got.ts)


@pytest.mark.parametrize("frac,headroom,ts", [
    (0.42, 12345, 1000.0), (0.0, 0, 5.5), (1.0, 2**40, 1.7e9),
    (0.123456, 7, 1234.5678), (7.0, -3, 50.0)])
def test_codec_bytes_and_decode_as_jax(frac, headroom, ts):
    raw = pressure.NodePressure(frac, headroom, ts).encode()
    assert raw == jpressure.NodePressure(frac, headroom, ts).encode()
    ours = pressure.parse_pressure(raw, now=ts + 1)
    theirs = jpressure.parse_pressure(raw, now=ts + 1)
    assert (ours.throttle_frac, ours.hbm_headroom_bytes, ours.ts) == \
        (theirs.throttle_frac, theirs.hbm_headroom_bytes, theirs.ts)


@pytest.mark.parametrize("raw,now", [
    (None, 0.0), ("", 0.0), ("not-a-pressure", 0.0), ("0.5:abc@10", 11.0),
    ("nan:0@10", 11.0), ("inf:0@10", 11.0), ("0.5:0@nan", 11.0),
    ("0.9000:1@1000.000", 1121.0), ("0.9000:1@1000.000", 990.0),
    ("0.9000:1@1000.000", 999.9), ("7.0:0@50", 51.0)])
def test_stale_and_garbage_decode_as_jax(raw, now):
    ours = pressure.parse_pressure(raw, now=now)
    theirs = jpressure.parse_pressure(raw, now=now)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert (ours.throttle_frac, ours.hbm_headroom_bytes, ours.ts) == \
            (theirs.throttle_frac, theirs.hbm_headroom_bytes, theirs.ts)


def test_roundtrip_and_clamp():
    got = pressure.parse_pressure(
        pressure.NodePressure(0.42, 12345, ts=1000.0).encode(), now=1001.0)
    assert got.throttle_frac == pytest.approx(0.42)
    assert got.hbm_headroom_bytes == 12345
    clamped = pressure.parse_pressure(
        pressure.NodePressure(7.0, 0, ts=50.0).encode(), now=51.0)
    assert clamped.throttle_frac == 1.0
    assert pressure.parse_pressure(
        pressure.NodePressure(0.9, 1, ts=1000.0).encode(),
        now=1000.0 + pressure.MAX_PRESSURE_AGE_S + 1) is None


# --- kubelet's checkpoint -----------------------------------------------------

def _write(path, doc):
    with open(path, "w") as f:
        f.write(doc if isinstance(doc, str) else json.dumps(doc))


def _same(path):
    ours, theirs = ckpt.read_checkpoint(path), jckpt.read_checkpoint(path)
    assert [tuple(vars(e).values()) for e in ours] == \
        [tuple(vars(e).values()) for e in theirs]
    return ours


def test_read_kubelet_checkpoint(tmp_path):
    path = str(tmp_path / "kubelet_internal_checkpoint")
    _write(path, {"Data": {"PodDeviceEntries": [{
        "PodUID": "u1", "ContainerName": "c1",
        "ResourceName": "google.com/vtpu-number",
        "DeviceIDs": {"0": ["a::0", "a::1"]}}]}})
    entries = _same(path)
    assert entries[0].pod_uid == "u1"
    assert set(entries[0].device_ids) == {"a::0", "a::1"}
    assert _same(str(tmp_path / "nope")) == []


def test_truncated_checkpoint_reads_as_empty(tmp_path):
    path = str(tmp_path / "kubelet_internal_checkpoint")
    full = json.dumps({"Data": {"PodDeviceEntries": [{
        "PodUID": "u1", "ContainerName": "c1",
        "ResourceName": "google.com/vtpu-number",
        "DeviceIDs": {"0": ["a::0"]}}]}})
    for cut in (1, len(full) // 3, len(full) - 2):
        _write(path, full[:cut])
        assert _same(path) == []


def test_wrong_typed_device_ids_degrade_per_entry(tmp_path):
    path = str(tmp_path / "kubelet_internal_checkpoint")
    _write(path, {"Data": {"PodDeviceEntries": [
        {"PodUID": "u1", "ContainerName": "c",
         "ResourceName": "google.com/vtpu-number", "DeviceIDs": {"0": "a::0"}},
        {"PodUID": "u2", "ContainerName": "c",
         "ResourceName": "google.com/vtpu-number", "DeviceIDs": 42},
        {"PodUID": "u3", "ContainerName": "c",
         "ResourceName": "google.com/vtpu-number",
         "DeviceIDs": {"0": [7, None, "b::0"]}},
        "garbage",
        {"PodUID": "u4", "ContainerName": "c",
         "ResourceName": "google.com/vtpu-number",
         "DeviceIDs": {"0": ["c::0"]}}]}})
    by_uid = {e.pod_uid: e for e in _same(path)}
    assert by_uid["u1"].device_ids == ()
    assert by_uid["u2"].device_ids == ()
    assert by_uid["u3"].device_ids == ("b::0",)
    assert by_uid["u4"].device_ids == ("c::0",)
    held = ckpt.devices_for_resource("google.com/vtpu-number", path)
    assert held == jckpt.devices_for_resource("google.com/vtpu-number", path)
    assert held["u4"] == {"c::0"}
    assert all(isinstance(d, str) and "::" in d
               for ids in held.values() for d in ids)


@pytest.mark.parametrize("doc", [
    "[]", '"str"', '{"Data": []}',
    '{"Data": {"PodDeviceEntries": {"not": "a list"}}}'])
def test_wrong_typed_top_level_shapes(tmp_path, doc):
    path = str(tmp_path / "kubelet_internal_checkpoint")
    _write(path, doc)
    assert _same(path) == []


# --- the reporters ------------------------------------------------------------

@pytest.fixture
def manager():
    client = FakeKubeClient()
    client.add_node({"metadata": {"name": "node-1", "annotations": {}}})
    mgr = DeviceManager("node-1", client,
                        node_config=NodeConfig(device_split_count=4),
                        backends=[FakeBackend(n_chips=2)])
    mgr.init_devices()
    return mgr


def _jax_manager(mgr):
    return SimpleNamespace(chips=[JaxChipSpec(
        uuid=c.uuid, index=c.index, chip_type=c.chip_type, memory=c.memory,
        core_count=c.core_count, split_count=c.split_count, coords=c.coords,
        healthy=c.healthy) for c in mgr.chips])


def _listing(devices):
    return [(d.ID, d.health) for d in devices]


@pytest.mark.parametrize("unit_mib", [256, 1024])
def test_reporters_list_as_jax(manager, unit_mib):
    manager.mark_unhealthy(manager.chips[1].uuid)
    jmgr = _jax_manager(manager)
    cores = VcorePlugin(manager).list_devices()
    assert _listing(cores) == _listing(jrep.VcorePlugin(jmgr).list_devices())
    assert len(cores) == 200
    mem = VmemPlugin(manager, mem_unit_mib=unit_mib).list_devices()
    assert _listing(mem) == _listing(
        jrep.VmemPlugin(jmgr, mem_unit_mib=unit_mib).list_devices())
    per_card = manager.chips[0].memory // (unit_mib * 2**20)
    assert len(mem) == 2 * per_card
    assert sum(h == "Unhealthy" for _, h in _listing(mem)) == per_card
    assert (VcorePlugin(manager).resource_name,
            VmemPlugin(manager).resource_name) == (
        jc.vtpu_cores_resource(), jc.vtpu_memory_resource())
    assert (VcorePlugin(manager).socket_name,
            VmemPlugin(manager).socket_name) == (
        "vtpu-cores.sock", "vtpu-memory.sock")


def test_reporter_names_as_jax():
    for name in ("resource_domain", "annotation_domain",
                 "vtpu_number_resource", "vtpu_cores_resource",
                 "vtpu_memory_resource", "node_pressure_annotation"):
        assert getattr(consts, name)() == getattr(jc, name)()
    assert consts.TRACE_DIR == jc.TRACE_DIR
    assert consts.COMPILE_CACHE_SUBDIR == jc.COMPILE_CACHE_SUBDIR


# --- traces: spools written by the JAX package's recorder -----------------

def mk_span(stage="s", trace_id="t1", pod_uid="u1", start=100.0, dur=0.001,
            **attrs):
    return JaxSpan(stage=stage, trace_id=trace_id, pod_uid=pod_uid,
                   start_s=start, dur_s=dur, attrs=attrs)


def _spool(tmp_path, spans, service="svc", capacity=64):
    rec = SpanRecorder(service, str(tmp_path), capacity=capacity,
                       flush_at=999)
    for s in spans:
        rec.record(s)
    rec.flush()
    return rec


def _timelines(tmp_path):
    ours, drops = assemble.read_spools(str(tmp_path))
    theirs, jdrops = jassemble.read_spools(str(tmp_path))
    assert [s.to_wire() for s in ours] == [s.to_wire() for s in theirs]
    assert drops == jdrops
    tls, jtls = assemble.assemble(ours), jassemble.assemble(theirs)
    assert {k: t.to_wire() for k, t in tls.items()} == \
        {k: t.to_wire() for k, t in jtls.items()}
    return ours, tls


def test_joins_by_uid_without_trace_id(tmp_path):
    _spool(tmp_path, [
        mk_span(stage="scheduler.filter", trace_id="t1", start=1.0),
        mk_span(stage="dra.prepare", trace_id="", start=2.0),
        mk_span(stage="registry.register", trace_id="", start=3.0)])
    _, tls = _timelines(tmp_path)
    assert set(tls) == {"u1"}
    assert tls["u1"].trace_id == "t1"
    assert [s.stage for s in tls["u1"].spans] == [
        "scheduler.filter", "dra.prepare", "registry.register"]


def test_joins_by_trace_id_learning_uid(tmp_path):
    _spool(tmp_path, [mk_span(stage="webhook.mutate"),
                      mk_span(stage="shim.register", pod_uid="",
                              start=101.0)])
    _, tls = _timelines(tmp_path)
    assert set(tls) == {"u1"} and len(tls["u1"].spans) == 2


def test_find_timeline_and_critical_path(tmp_path):
    _spool(tmp_path, [
        mk_span(stage="scheduler.filter", trace_id="tid-9", pod_uid="u9",
                start=1.0, dur=0.5),
        mk_span(stage="scheduler.bind", trace_id="tid-9", pod_uid="u9",
                start=2.0, dur=0.25)])
    _, tls = _timelines(tmp_path)
    tl = assemble.find_timeline(tls, "tid-9")
    assert tl is tls["u9"] and assemble.find_timeline(tls, "nope") is None
    rows = assemble.critical_path(tl)
    assert rows == jassemble.critical_path(jassemble.find_timeline(
        jassemble.assemble(jassemble.read_spools(str(tmp_path))[0]),
        "tid-9"))
    assert rows[0]["gap_s"] == 0.0
    assert rows[1]["gap_s"] == pytest.approx(0.5)
    assert rows[1]["offset_s"] == pytest.approx(1.0)


def test_outliers_flag_only_slow_spans(tmp_path):
    _spool(tmp_path, [mk_span(stage="scheduler.filter", dur=0.002,
                              pod_uid=f"u{i}") for i in range(5)]
           + [mk_span(stage="scheduler.filter", dur=0.2, pod_uid="slow")])
    spans, _ = _timelines(tmp_path)
    found = assemble.outliers(spans)
    assert found == jassemble.outliers(
        jassemble.read_spools(str(tmp_path))[0])
    assert [o["pod_uid"] for o in found] == ["slow"]


def test_torn_spool_lines_skipped(tmp_path):
    rec = _spool(tmp_path, [mk_span(stage="ok")])
    with open(rec.spool_path, "a") as f:
        f.write('{"kind":"span","stage":"torn')
    spans, _ = _timelines(tmp_path)
    assert [s.stage for s in spans] == ["ok"]


def test_metrics_render_as_jax(tmp_path):
    rec = SpanRecorder("plugin", str(tmp_path), capacity=1, flush_at=99)
    rec.record(mk_span(stage="plugin.allocate", dur=0.004))
    rec.record(mk_span(stage="plugin.allocate"))       # dropped (full)
    rec.flush()
    sched = SpanRecorder("scheduler", str(tmp_path), capacity=2, flush_at=99)
    for stage, dur in (("scheduler.filter", 0.003), ("scheduler.bind", 0.001),
                       ("scheduler.filter", 0.001)):
        sched.record(mk_span(stage=stage, dur=dur))
    sched.flush()
    text = render_trace_metrics(str(tmp_path))
    assert text == jax_render(str(tmp_path))
    assert 'vtpu_trace_spool_dropped_total{service="plugin"} 1' in text
    assert 'vtpu_trace_spool_dropped_total{service="scheduler"} 1' in text
    assert ('vtpu_trace_stage_duration_seconds_bucket'
            '{stage="plugin.allocate",le="0.005"} 1') in text
    assert ('vtpu_trace_stage_duration_seconds_sum'
            '{stage="scheduler.bind"} 0.001') in text
    empty = render_trace_metrics(str(tmp_path / "none"))
    assert empty == jax_render(str(tmp_path / "none"))
    assert "vtpu_trace_spool_dropped_total{" not in empty


def test_span_wire_round_trips_as_jax():
    s = mk_span(stage="plugin.config", attrs_key=1)
    assert Span.from_wire(s.to_wire()).to_wire() == s.to_wire()


def test_reap_stale_spools(tmp_path):
    rec = _spool(tmp_path, [mk_span()])
    old = tmp_path / "dead.999.jsonl"
    old.write_text('{"kind":"meta","service":"dead","pid":999,"drops":0}\n')
    os.utime(str(old), (1, 1))
    (tmp_path / "dead.999.jsonl.flock").write_text("")
    os.utime(str(tmp_path / "dead.999.jsonl.flock"), (1, 1))
    assert reap_stale_spools(str(tmp_path), max_age_s=3600) == 2
    assert not old.exists()
    assert os.path.exists(rec.spool_path)
    assert reap_stale_spools(str(tmp_path / "none")) == 0
