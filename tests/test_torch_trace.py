"""Allocation-path tracing: the port's writer side against the JAX
package's, and one timeline across both.

Every case of tests/test_trace.py's recorder, gate and sampling, assembly
and tenant-side classes runs through both packages (`pkg`); the spool
lines are byte for byte the JAX writer's, and the sampling decisions of
1000 seeded uids are the JAX ones at each rate. Then the cluster path: the
JAX webhook, filter and bind admit and commit a pod, the port's device
plugin allocates it and the port's tenant client installs, marks its first
execute and compiles through the node store; both packages' `assemble`
read the joint spool dir into one timeline. The port's Allocate puts the
same trace variables and mount as the JAX plugin, its DRA driver spans
only the claims of sampled pods, nothing at all is recorded with tracing
off, and `cmd/vtrace.py` prints the JAX CLI's documents.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
import subprocess
import sys
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

import vtpu_manager.trace as jtrace
from vtpu_manager.trace import assemble as jassemble
from vtpu_manager.trace import context as jcontext
from vtpu_manager.trace.metrics import render_trace_metrics as jrender
from vtpu_manager.trace.recorder import Span as JaxSpan
from vtpu_manager.trace.recorder import SpanRecorder as JaxSpanRecorder
from vtpu_manager.trace.recorder import reap_stale_spools as jreap
from vtpu_manager.util import consts as jc
from vtpu_manager_torch import bench_allocate, trace
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin, device_id
from vtpu_manager_torch.manager.device_manager import DeviceManager
from vtpu_manager_torch.trace import assemble, context
from vtpu_manager_torch.trace.metrics import render_trace_metrics
from vtpu_manager_torch.trace.recorder import (Span, SpanRecorder,
                                               reap_stale_spools)
from vtpu_manager_torch.tpu.discovery import FakeBackend
from vtpu_manager_torch.util import consts

from test_torch_deviceplugin import (alloc, committed_pod, jax_plugin,
                                     make_manager, node_dirs)
from test_trace import _apply_annotation_patches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD_UID = "11111111-2222-3333-4444-555555555555"

PKGS = {
    "jax": SimpleNamespace(
        trace=jtrace, assemble=jassemble, context=jcontext, consts=jc,
        Span=JaxSpan, SpanRecorder=JaxSpanRecorder, render=jrender,
        reap=jreap, client="vtpu_manager.runtime.client"),
    "torch": SimpleNamespace(
        trace=trace, assemble=assemble, context=context, consts=consts,
        Span=Span, SpanRecorder=SpanRecorder, render=render_trace_metrics,
        reap=reap_stale_spools, client="vtpu_manager_torch.runtime.client"),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _tracing_off_between_tests():
    yield
    jtrace.reset()
    trace.reset()


def mk_span(pkg, stage="s", trace_id="t1", pod_uid="u1", start=100.0,
            dur=0.001, **attrs):
    return pkg.Span(stage=stage, trace_id=trace_id, pod_uid=pod_uid,
                    start_s=start, dur_s=dur, attrs=attrs)


# --- tests/test_trace.py's TestRecorder, through both packages -------------

class TestRecorder:
    def test_ring_bounds_and_drop_counter(self, pkg, tmp_path):
        rec = pkg.SpanRecorder("svc", str(tmp_path), capacity=4,
                               flush_at=99)
        for i in range(7):
            rec.record(mk_span(pkg, stage=f"s{i}"))
        assert rec.pending() == 4
        assert rec.dropped == 3

    def test_flush_drains_and_spools(self, pkg, tmp_path):
        rec = pkg.SpanRecorder("svc", str(tmp_path), capacity=8, flush_at=99)
        rec.record(mk_span(pkg, stage="a"))
        rec.record(mk_span(pkg, stage="b"))
        assert rec.flush() == 2
        assert rec.pending() == 0
        spans, drops = pkg.assemble.read_spools(str(tmp_path))
        assert sorted(s.stage for s in spans) == ["a", "b"]
        assert drops == {("svc", os.getpid()): 0}

    def test_drop_count_reaches_spool_meta(self, pkg, tmp_path):
        rec = pkg.SpanRecorder("svc", str(tmp_path), capacity=2, flush_at=99)
        for _ in range(5):
            rec.record(mk_span(pkg))
        rec.flush()
        _, drops = pkg.assemble.read_spools(str(tmp_path))
        assert drops[("svc", os.getpid())] == 3

    def test_record_does_no_io_only_wakes_flusher(self, pkg, tmp_path):
        rec = pkg.SpanRecorder("svc", str(tmp_path), capacity=4)  # wake at 2
        rec.record(mk_span(pkg, stage="a"))
        assert not rec._wake.is_set()
        rec.record(mk_span(pkg, stage="b"))
        assert rec._wake.is_set()
        assert rec.pending() == 2
        assert not os.path.exists(rec.spool_path)

    def test_background_flusher_drains_on_wake(self, pkg, tmp_path):
        rec = pkg.SpanRecorder("svc", str(tmp_path), capacity=4)
        t = threading.Thread(target=rec.run_flusher, args=(30.0,),
                             daemon=True)
        t.start()
        try:
            rec.record(mk_span(pkg, stage="a"))
            rec.record(mk_span(pkg, stage="b"))  # the threshold's wake
            deadline = time.monotonic() + 5.0
            while rec.pending() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert rec.pending() == 0
            spans, _ = pkg.assemble.read_spools(str(tmp_path))
            assert sorted(s.stage for s in spans) == ["a", "b"]
        finally:
            rec.stop_flusher()
            t.join(timeout=5)
        assert not t.is_alive()

    def test_unwritable_spool_counts_as_drops(self, pkg, tmp_path):
        blocker = tmp_path / "f"
        blocker.write_text("")
        rec = pkg.SpanRecorder("svc", str(blocker / "sub"), capacity=8,
                               flush_at=99)
        rec.record(mk_span(pkg))
        assert rec.flush() == 0
        assert rec.dropped == 1

    def test_record_and_flush_never_raise_with_spool_broken(self, pkg,
                                                            tmp_path):
        blocker = tmp_path / "f"
        blocker.write_text("")
        rec = pkg.SpanRecorder("svc", str(blocker / "sub"), capacity=4)
        for _ in range(10):
            rec.record(mk_span(pkg))
        rec.flush()

    def test_spool_rotation_bounds_growth(self, pkg, tmp_path):
        rec = pkg.SpanRecorder("svc", str(tmp_path), capacity=64,
                               flush_at=99, max_spool_bytes=2048)

        def one_round(round_):
            for i in range(20):
                rec.record(mk_span(pkg, stage=f"s{round_}",
                                   pod_uid=f"u{round_}-{i}"))
            rec.flush()

        one_round(0)
        batch = os.path.getsize(rec.spool_path)
        for round_ in range(1, 8):
            one_round(round_)
        names = [n for n in os.listdir(str(tmp_path))
                 if n.endswith(".jsonl")]
        assert len(names) == 2
        assert any(".prev." in n for n in names)
        total = sum(os.path.getsize(os.path.join(str(tmp_path), n))
                    for n in names)
        assert total <= 2 * (2048 + batch)
        spans, _ = pkg.assemble.read_spools(str(tmp_path))
        assert len(spans) > 20

    def test_reap_stale_spools(self, pkg, tmp_path):
        rec = pkg.SpanRecorder("svc", str(tmp_path), capacity=4, flush_at=99)
        rec.record(mk_span(pkg))
        rec.flush()
        old = tmp_path / "dead.999.jsonl"
        old.write_text('{"kind":"meta","service":"dead","pid":999,'
                       '"drops":0}\n')
        os.utime(str(old), (1, 1))
        assert pkg.reap(str(tmp_path), max_age_s=3600) == 1
        assert not old.exists()
        assert os.path.exists(rec.spool_path)

    def test_reset_stops_the_flusher(self, pkg, tmp_path):
        pkg.trace.configure("svc", str(tmp_path), flush_interval_s=30.0)
        (flusher,) = [t for t in threading.enumerate()
                      if t.name == "vtrace-flush"
                      and t._target.__self__ is pkg.trace.recorder()]
        pkg.trace.reset()
        flusher.join(timeout=5)
        assert not flusher.is_alive() and not pkg.trace.is_enabled()


# --- tests/test_trace.py's TestGateAndSampling ------------------------------

class TestGateAndSampling:
    def test_off_is_a_shared_null_span(self, pkg):
        pkg.trace.reset()
        ctx = pkg.trace.TraceContext(trace_id="t", pod_uid="u")
        assert pkg.trace.span(ctx, "x") is pkg.trace._NULL_SPAN
        assert pkg.trace.span(None, "x") is pkg.trace._NULL_SPAN
        assert pkg.trace.mint_for_pod({"metadata": {"uid": "u"}}) is None
        assert pkg.trace.context_for_pod({"metadata": {}}) is None
        assert pkg.trace.context_for_claim({"metadata": {"uid": "c"}}) \
            is None
        assert pkg.trace.context_from_env({consts.ENV_TRACE_ID: "t"}) is None
        assert pkg.trace.flush() == 0

    def test_sampling_zero_short_circuits(self, pkg, tmp_path):
        pkg.trace.configure("t", str(tmp_path / "spool"), sampling_rate=0.0)
        ctx = pkg.trace.mint_for_pod({"metadata": {"uid": "u1"}})
        assert ctx is not None and ctx.sampled is False
        assert pkg.trace.annotation_values(ctx)[
            pkg.consts.trace_sampled_annotation()] == "false"
        assert pkg.trace.span(ctx, "scheduler.filter") \
            is pkg.trace._NULL_SPAN
        with pkg.trace.span(ctx, "scheduler.filter"):
            pass
        pkg.trace.event(ctx, "shim.register")
        assert pkg.trace.recorder().pending() == 0
        assert pkg.trace.recorder().dropped == 0
        pkg.trace.flush()
        spans, _ = pkg.assemble.read_spools(str(tmp_path / "spool"))
        assert spans == []

    def test_sampling_is_deterministic_per_trace_id(self, pkg, tmp_path):
        pkg.trace.configure("t", str(tmp_path), sampling_rate=0.5)
        pod = {"metadata": {"uid": "uid-stable"}}
        assert len({pkg.trace.mint_for_pod(pod).sampled
                    for _ in range(10)}) == 1

    def test_unsampled_context_survives_propagation(self, pkg, tmp_path):
        pkg.trace.configure("t", str(tmp_path), sampling_rate=0.0)
        ctx = pkg.trace.mint_for_pod({"metadata": {"uid": "u1"}})
        pod = {"metadata": {"uid": "u1",
                            "annotations": pkg.trace.annotation_values(ctx)}}
        downstream = pkg.trace.context_for_pod(pod)
        assert downstream is not None and downstream.sampled is False

    def test_uid_joined_stages_recompute_the_sampling_decision(
            self, pkg, tmp_path):
        pkg.trace.configure("t", str(tmp_path), sampling_rate=0.0)
        assert pkg.trace.context_for_uid("any-uid").sampled is False
        claim = {"metadata": {"uid": "c1"},
                 "status": {"reservedFor": [{"uid": "p1"}]}}
        assert pkg.trace.context_for_claim(claim).sampled is False
        pkg.trace.configure("t", str(tmp_path), sampling_rate=0.3)
        for uid in ("u-a", "u-b", "u-c", "u-d", "u-e"):
            minted = pkg.context.mint({"metadata": {"uid": uid}}, 0.3)
            assert pkg.trace.context_for_uid(uid).sampled == minted.sampled

    def test_span_records_error_attr(self, pkg, tmp_path):
        pkg.trace.configure("t", str(tmp_path), sampling_rate=1.0)
        ctx = pkg.trace.mint_for_pod({"metadata": {"uid": "u1"}})
        with pytest.raises(ValueError):
            with pkg.trace.span(ctx, "scheduler.filter"):
                raise ValueError("boom")
        pkg.trace.flush()
        spans, _ = pkg.assemble.read_spools(str(tmp_path))
        assert spans[0].attrs.get("error") == "ValueError"


# --- tests/test_trace.py's TestAssembly -------------------------------------

class TestAssembly:
    def test_joins_by_uid_without_trace_id(self, pkg):
        spans = [mk_span(pkg, stage="scheduler.filter", trace_id="t1",
                         pod_uid="u1", start=1.0),
                 mk_span(pkg, stage="dra.prepare", trace_id="",
                         pod_uid="u1", start=2.0),
                 mk_span(pkg, stage="registry.register", trace_id="",
                         pod_uid="u1", start=3.0)]
        tls = pkg.assemble.assemble(spans)
        assert set(tls) == {"u1"}
        assert tls["u1"].trace_id == "t1"
        assert [s.stage for s in tls["u1"].spans] == [
            "scheduler.filter", "dra.prepare", "registry.register"]

    def test_joins_by_trace_id_learning_uid(self, pkg):
        spans = [mk_span(pkg, stage="webhook.mutate", trace_id="t1",
                         pod_uid="u1"),
                 mk_span(pkg, stage="shim.register", trace_id="t1",
                         pod_uid="", start=101.0)]
        tls = pkg.assemble.assemble(spans)
        assert set(tls) == {"u1"}
        assert len(tls["u1"].spans) == 2

    def test_find_timeline_by_trace_id(self, pkg):
        spans = [mk_span(pkg, stage="webhook.mutate", trace_id="tid-9",
                         pod_uid="u9")]
        tls = pkg.assemble.assemble(spans)
        assert pkg.assemble.find_timeline(tls, "u9") is tls["u9"]
        assert pkg.assemble.find_timeline(tls, "tid-9") is tls["u9"]
        assert pkg.assemble.find_timeline(tls, "nope") is None

    def test_critical_path_gaps(self, pkg):
        spans = [mk_span(pkg, stage="scheduler.filter", start=1.0, dur=0.5),
                 mk_span(pkg, stage="scheduler.bind", start=2.0, dur=0.25)]
        rows = pkg.assemble.critical_path(pkg.assemble.assemble(spans)["u1"])
        assert rows[0]["gap_s"] == 0.0
        assert rows[1]["gap_s"] == pytest.approx(0.5)
        assert rows[1]["offset_s"] == pytest.approx(1.0)

    def test_outliers_flag_only_slow_spans(self, pkg):
        spans = [mk_span(pkg, stage="scheduler.filter", dur=0.002,
                         pod_uid=f"u{i}") for i in range(5)]
        spans.append(mk_span(pkg, stage="scheduler.filter", dur=0.2,
                             pod_uid="slow"))
        assert [o["pod_uid"] for o in pkg.assemble.outliers(spans)] == \
            ["slow"]

    def test_torn_spool_lines_skipped(self, pkg, tmp_path):
        rec = pkg.SpanRecorder("svc", str(tmp_path), capacity=8, flush_at=99)
        rec.record(mk_span(pkg, stage="ok"))
        rec.flush()
        with open(rec.spool_path, "a") as f:
            f.write('{"kind":"span","stage":"torn')
        spans, _ = pkg.assemble.read_spools(str(tmp_path))
        assert [s.stage for s in spans] == ["ok"]

    def test_metrics_render(self, pkg, tmp_path):
        rec = pkg.SpanRecorder("plugin", str(tmp_path), capacity=1,
                               flush_at=99)
        rec.record(mk_span(pkg, stage="plugin.allocate", dur=0.004))
        rec.record(mk_span(pkg, stage="plugin.allocate"))   # dropped
        rec.flush()
        text = pkg.render(str(tmp_path))
        assert 'vtpu_trace_spool_dropped_total{service="plugin"} 1' in text
        assert ('vtpu_trace_stage_duration_seconds_count'
                '{stage="plugin.allocate"} 1') in text
        assert ('vtpu_trace_stage_duration_seconds_bucket'
                '{stage="plugin.allocate",le="0.005"} 1') in text


# --- tests/test_trace.py's TestTenantSideTracing ----------------------------

def _runtime_client(pkg, monkeypatch):
    rc = importlib.import_module(pkg.client)
    monkeypatch.setattr(rc, "_first_execute_marked", False)
    return rc


class TestTenantSideTracing:
    """A tenant has no gates: the trace id Allocate put in its environment
    is the gate, and its spool dir the node trace dir it was given."""

    def test_env_auto_configures_and_spools(self, pkg, tmp_path,
                                            monkeypatch):
        rc = _runtime_client(pkg, monkeypatch)
        pkg.trace.reset()
        monkeypatch.setenv(consts.ENV_TRACE_ID, "tid-1")
        monkeypatch.setenv(consts.ENV_TRACE_SAMPLED, "true")
        monkeypatch.setenv(consts.ENV_POD_UID, "u1")
        monkeypatch.setenv(consts.ENV_TRACE_DIR, str(tmp_path))
        rc.mark_first_execute()
        rc.mark_first_execute()           # once only
        assert pkg.trace.is_enabled()
        pkg.trace.flush()
        spans, _ = pkg.assemble.read_spools(str(tmp_path))
        assert [s.stage for s in spans] == ["shim.first_execute"]
        assert spans[0].trace_id == "tid-1"
        assert spans[0].service == "tenant"
        assert spans[0].attrs == {"pid": os.getpid()}

    def test_unsampled_tenant_never_configures(self, pkg, tmp_path,
                                               monkeypatch):
        rc = _runtime_client(pkg, monkeypatch)
        pkg.trace.reset()
        monkeypatch.setenv(consts.ENV_TRACE_ID, "tid-1")
        monkeypatch.setenv(consts.ENV_TRACE_SAMPLED, "false")
        monkeypatch.setenv(consts.ENV_TRACE_DIR, str(tmp_path))
        rc.mark_first_execute()
        assert not pkg.trace.is_enabled()
        assert not os.listdir(str(tmp_path))

    def test_untraced_tenant_never_configures(self, pkg, monkeypatch):
        rc = _runtime_client(pkg, monkeypatch)
        pkg.trace.reset()
        monkeypatch.delenv(consts.ENV_TRACE_ID, raising=False)
        rc.mark_first_execute()
        assert not pkg.trace.is_enabled()


def test_install_records_the_shim_install_event(tmp_path, monkeypatch):
    from vtpu_manager_torch.runtime import client as rc
    shim = tmp_path / "libvtpu-cuda-control.so"
    shim.write_bytes(b"")
    monkeypatch.delenv(consts.ENV_COMPILE_CACHE, raising=False)
    monkeypatch.setenv(consts.ENV_TRACE_ID, "tid-2")
    monkeypatch.setenv(consts.ENV_POD_UID, "u2")
    monkeypatch.setenv(consts.ENV_TRACE_DIR, str(tmp_path / "spool"))
    assert rc.install(shim_path=str(shim)) is not None
    trace.flush()
    spans, _ = assemble.read_spools(str(tmp_path / "spool"))
    assert [(s.stage, s.trace_id, s.pod_uid, s.attrs) for s in spans] == [
        ("shim.install", "tid-2", "u2", {"shim": str(shim)})]


# --- the wire: byte for byte ------------------------------------------------

WIRE_SPANS = [
    dict(stage="plugin.allocate", trace_id="t", pod_uid="u",
         service="plugin", start_s=1760000000.1234567891, dur_s=0.00012345678,
         attrs={"container": "main", "devices": 1}),
    dict(stage="shim.compile", trace_id=POD_UID, pod_uid=POD_UID,
         service="tenant", start_s=1.0000005, dur_s=12.3456785,
         attrs={"key": "0123456789abcdef"}),
    dict(stage="dra.cdi", pod_uid="p", start_s=0.0, dur_s=0.0, attrs={}),
    dict(stage="x", trace_id="ü-ñ", attrs={"error": "ValueError",
                                            "f": 0.1 + 0.2, "n": None,
                                            "b": True, "l": [1, "a"],
                                            "d": {"k": -1.5e-7}}),
]


@pytest.mark.parametrize("fields", WIRE_SPANS,
                         ids=[s["stage"] for s in WIRE_SPANS])
def test_span_wire_bytes_equal(fields):
    mine = json.dumps(Span(**fields).to_wire(), separators=(",", ":"))
    theirs = json.dumps(JaxSpan(**fields).to_wire(), separators=(",", ":"))
    assert mine == theirs
    assert Span.from_wire(json.loads(mine)) == Span(**{
        **fields, "start_s": round(fields.get("start_s", 0.0), 6),
        "dur_s": round(fields.get("dur_s", 0.0), 6)})


def test_spool_lines_byte_equal(tmp_path):
    """The same spans through both recorders: equal span lines, and meta
    lines with the same keys and values but the time stamp."""
    docs = {}
    for name, recorder_cls, span_cls in (("jax", JaxSpanRecorder, JaxSpan),
                                         ("torch", SpanRecorder, Span)):
        rec = recorder_cls("plugin", str(tmp_path / name), capacity=3,
                           flush_at=99)
        for fields in WIRE_SPANS:
            rec.record(span_cls(**fields))          # the last one drops
        assert rec.flush() == 3
        with open(rec.spool_path) as f:
            docs[name] = f.read().splitlines()
    assert docs["torch"][:3] == docs["jax"][:3]
    meta = {k: json.loads(v[3]) for k, v in docs.items()}
    assert meta["torch"].keys() == meta["jax"].keys()
    assert {k: v for k, v in meta["torch"].items() if k != "ts"} == \
        {k: v for k, v in meta["jax"].items() if k != "ts"} == \
        {"kind": "meta", "service": "plugin", "pid": os.getpid(),
         "drops": 1}


# --- sampling: the same verdicts --------------------------------------------

def _seeded_uids(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return [str(uuid.UUID(bytes=rng.bytes(16))) for _ in range(n)]


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.5, 1.0])
def test_sampling_decisions_equal(rate):
    uids = _seeded_uids()
    mine = [context._sample(u, rate) for u in uids]
    assert mine == [jcontext._sample(u, rate) for u in uids]
    assert [context.mint({"metadata": {"uid": u}}, rate) for u in uids[:50]]\
        == [context.TraceContext(**vars(jcontext.mint(
            {"metadata": {"uid": u}}, rate))) for u in uids[:50]]
    assert [context.for_uid(u, rate) for u in uids[:50]] == [
        context.TraceContext(**vars(jcontext.for_uid(u, rate)))
        for u in uids[:50]]
    if 0.0 < rate < 1.0:
        assert abs(sum(mine) / len(mine) - rate) < 0.05


def test_contexts_read_alike():
    pods = [{"metadata": {"uid": "u", "annotations": {
                consts.trace_id_annotation(): "t",
                consts.trace_sampled_annotation(): s}}}
            for s in ("true", "false", "junk")]
    pods += [{"metadata": {"uid": "u"}}, {}]
    for pod in pods:
        theirs = jcontext.from_pod(pod)
        assert context.from_pod(pod) == (
            None if theirs is None else context.TraceContext(**vars(theirs)))
    claims = [{"metadata": {"uid": "c"}},
              {"metadata": {"uid": "c"}, "status": {"reservedFor": [
                  {"resource": "deployments", "uid": "d"},
                  {"resource": "pods", "uid": "p"}]}},
              {"metadata": {}}]
    for claim in claims:
        theirs = jcontext.for_claim(claim, 0.5)
        assert context.for_claim(claim, 0.5) == (
            None if theirs is None else context.TraceContext(**vars(theirs)))
    for env in ({}, {consts.ENV_TRACE_ID: "t"},
                {consts.ENV_TRACE_ID: "t", consts.ENV_POD_UID: "u",
                 consts.ENV_TRACE_SAMPLED: "false"}):
        theirs = jcontext.from_env(env)
        assert context.from_env(env) == (
            None if theirs is None else context.TraceContext(**vars(theirs)))
    assert (consts.trace_id_annotation(), consts.trace_sampled_annotation(),
            consts.ENV_TRACE_ID, consts.ENV_TRACE_SAMPLED,
            consts.ENV_TRACE_DIR, consts.TRACE_DIR) == (
        jc.trace_id_annotation(), jc.trace_sampled_annotation(),
        jc.ENV_TRACE_ID, jc.ENV_TRACE_SAMPLED, jc.ENV_TRACE_DIR,
        jc.TRACE_DIR)


# --- the cluster path across both packages ----------------------------------

def _tracing_threads() -> set:
    return {t for t in threading.enumerate() if t.name == "vtrace-flush"}


def _pipeline(tmp_path, monkeypatch, traced: bool = True) -> dict:
    """The JAX webhook, filter and bind admit and commit a pod onto the
    port's H100 node; the port's plugin allocates it (CompileCache on);
    the port's tenant client, in the response's environment, installs,
    marks its first execute and compiles through the node store. With
    `traced` both packages trace at rate 1 into one node trace dir; else
    neither does, and the pod carries an annotated trace id all the same."""
    from vtpu_manager.client.fake import FakeKubeClient as JaxFakeKubeClient
    from vtpu_manager.scheduler.bind import BindPredicate
    from vtpu_manager.scheduler.filter import FilterPredicate
    from vtpu_manager.webhook.mutate import mutate_pod
    from vtpu_manager_torch.runtime import client as rc

    node_trace = tmp_path / "node-trace"
    monkeypatch.setattr(jc, "TRACE_DIR", str(node_trace))
    monkeypatch.setattr(consts, "TRACE_DIR", str(node_trace))
    if traced:
        jtrace.configure("webhook", str(node_trace), sampling_rate=1.0)

    client = FakeKubeClient()
    client.add_node({"metadata": {"name": "gpu-node", "annotations": {}}})
    mgr = DeviceManager("gpu-node", client,
                        node_config=NodeConfig(device_split_count=4),
                        backends=[FakeBackend(1, "nvidia-h100-sxm")])
    mgr.init_devices()
    mgr.register_node()
    jclient = JaxFakeKubeClient(upsert_on_patch=True)
    jclient.add_node(client.get_node("gpu-node"))
    pod = {"metadata": {"name": "p1", "namespace": "default",
                        "uid": POD_UID, "annotations": {}},
           "spec": {"containers": [{"name": "main", "resources": {"limits": {
               jc.vtpu_number_resource(): 1, jc.vtpu_cores_resource(): 25,
               jc.vtpu_memory_resource(): 4096}}}]},
           "status": {"phase": "Pending"}}
    _apply_annotation_patches(pod, mutate_pod(pod).patches)
    anns = pod["metadata"]["annotations"]
    assert (jc.trace_id_annotation() in anns) == traced
    if not traced:
        anns.update(trace.annotation_values(context.TraceContext(
            trace_id=POD_UID, pod_uid=POD_UID)))
    jclient.add_pod(pod)
    result = FilterPredicate(jclient).filter({"Pod": pod,
                                              "NodeNames": ["gpu-node"]})
    assert result.node_names == ["gpu-node"], result
    assert not BindPredicate(jclient).bind({
        "PodName": "p1", "PodNamespace": "default", "PodUID": POD_UID,
        "Node": "gpu-node"}).error

    if traced:
        trace.configure("plugin", str(node_trace), sampling_rate=1.0)
    client.add_pod(jclient.get_pod("default", "p1"))
    plugin = VnumPlugin(mgr, client, "gpu-node",
                        **node_dirs(tmp_path / "node"))
    plugin.compile_cache_enabled = True
    resp = alloc(plugin, device_id(mgr.chips[0].uuid, 0))
    trace.flush()
    trace.reset()

    # the tenant, in its container's environment
    env = bench_allocate.container_env(resp)
    for k in [k for k in os.environ if k.startswith("VTPU_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        if k.startswith("VTPU_"):
            monkeypatch.setenv(k, v)
    for var in (consts.ENV_INDUCTOR_CACHE_DIR, consts.ENV_TRITON_CACHE_DIR):
        monkeypatch.setenv(var, str(tmp_path / var.lower()))
    monkeypatch.setattr(rc, "_first_execute_marked", False)
    rc._reset_compile_cache()
    shim = tmp_path / "libvtpu-cuda-control.so"
    shim.write_bytes(b"")
    assert rc.install(shim_path=str(shim)) is not None
    rc.mark_first_execute()
    cache = rc.compile_cache()
    try:
        payload, outcome = cache.get_or_compile(
            "ab" * 32, lambda: b"compiled", ctx=trace.context_from_env())
    finally:
        rc._reset_compile_cache()
    assert (payload, outcome) == (b"compiled", "miss")
    traced_tenant = trace.is_enabled()
    trace.flush()
    jtrace.flush()
    return {"spool": str(node_trace), "resp": resp, "env": env,
            "traced_tenant": traced_tenant}


TIMELINE = ("webhook.mutate", "scheduler.filter", "scheduler.bind",
            "plugin.allocate", "plugin.config", "shim.install",
            "shim.first_execute", "shim.compile", "shim.compile_outcome")


def test_one_timeline_through_both_assembles(tmp_path, monkeypatch):
    run = _pipeline(tmp_path, monkeypatch)
    assert run["env"][consts.ENV_TRACE_DIR] == run["spool"]
    assert run["traced_tenant"]
    spans, drops = assemble.read_spools(run["spool"])
    jspans, jdrops = jassemble.read_spools(run["spool"])
    assert drops == jdrops and sum(drops.values()) == 0
    assert {s for s, _ in drops} == {"webhook", "plugin", "tenant"}
    tl = assemble.assemble(spans)[POD_UID]
    jtl = jassemble.assemble(jspans)[POD_UID]
    assert tl.to_wire() == jtl.to_wire()
    assert assemble.critical_path(tl) == jassemble.critical_path(jtl)
    order = [s.stage for s in tl.spans]
    assert order == [s.stage for s in jtl.spans]
    assert sorted(order) == sorted(TIMELINE), order
    # causal order along the path, by start time
    assert [st for st in order if st in TIMELINE[:4]] == list(TIMELINE[:4])
    first = {s.stage: s for s in tl.spans}
    assert first["plugin.allocate"].start_s <= first["plugin.config"].start_s
    assert first["plugin.config"].dur_s <= first["plugin.allocate"].dur_s
    assert first["plugin.allocate"].start_s + first["plugin.allocate"].dur_s \
        <= first["shim.install"].start_s <= first["shim.first_execute"]\
        .start_s <= first["shim.compile"].start_s
    assert first["shim.compile_outcome"].attrs == {
        "outcome": "miss", "key": "ab" * 8}
    assert all(row["gap_s"] >= 0 for row in assemble.critical_path(tl))


@pytest.mark.parametrize("annotated", ["sampled", "unsampled", "none"])
@pytest.mark.parametrize("gate", ["on", "off"])
def test_allocate_trace_env_and_mounts_equal_jax(tmp_path, monkeypatch,
                                                 annotated, gate):
    monkeypatch.setattr(jc, "TRACE_DIR", str(tmp_path / "node-trace"))
    monkeypatch.setattr(consts, "TRACE_DIR", str(tmp_path / "node-trace"))
    if gate == "on":
        jtrace.configure("plugin", str(tmp_path / "jspool"))
        trace.configure("plugin", str(tmp_path / "spool"))
    client = FakeKubeClient()
    mgr = make_manager(client)
    p = VnumPlugin(mgr, client, "node-1", node_config=NodeConfig(),
                   **node_dirs(tmp_path))
    anns = {} if annotated == "none" else trace.annotation_values(
        context.TraceContext(trace_id="tid-7", pod_uid="uid-p1",
                             sampled=annotated == "sampled"))
    pod = committed_pod(mgr, annotations=anns)
    jp, jclient = jax_plugin(mgr, tmp_path / "jax")
    client.add_pod(copy.deepcopy(pod))
    jclient.add_pod(copy.deepcopy(pod))
    ids = [device_id(mgr.chips[0].uuid, 0)]
    from vtpu_manager.deviceplugin.api import deviceplugin_pb2 as jpb
    mine = alloc(p, *ids)
    theirs = jp.allocate(jpb.AllocateRequest(container_requests=[
        jpb.ContainerAllocateRequest(devicesIDs=ids)])).container_responses[0]
    keys = (consts.ENV_TRACE_ID, consts.ENV_TRACE_SAMPLED)
    assert {k: mine.envs.get(k) for k in keys} == \
        {k: dict(theirs.envs).get(k) for k in keys}
    view = [(m.container_path, m.host_path, m.read_only)
            for m in mine.mounts if m.container_path == consts.TRACE_DIR]
    assert view == [(m.container_path, m.host_path, m.read_only)
                    for m in theirs.mounts
                    if m.container_path == jc.TRACE_DIR]
    expect_env = gate == "on" and annotated != "none"
    assert (consts.ENV_TRACE_ID in mine.envs) == expect_env
    assert view == ([(consts.TRACE_DIR, consts.TRACE_DIR, False)]
                    if gate == "on" and annotated == "sampled" else [])
    # the trace mount sits where the JAX plugin puts it among the others
    mine_paths = [m.container_path for m in mine.mounts]
    theirs_paths = [m.container_path for m in theirs.mounts]
    assert [c for c in mine_paths if c in theirs_paths] == \
        [c for c in theirs_paths if c in mine_paths]
    trace.flush()
    spans, _ = assemble.read_spools(str(tmp_path / "spool"))
    assert sorted(s.stage for s in spans) == (
        ["plugin.allocate", "plugin.config"]
        if gate == "on" and annotated == "sampled" else [])


def test_dra_spans_only_for_sampled_pods_claims(tmp_path):
    from vtpu_manager_torch import bench_dra
    from vtpu_manager_torch.kubeletplugin.api import messages as api
    from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
    from vtpu_manager_torch.kubeletplugin.driver import ClaimSource, DraDriver
    uids = _seeded_uids(50, seed=1)
    sampled = next(u for u in uids if context._sample(u, 0.5))
    unsampled = next(u for u in uids if not context._sample(u, 0.5))
    trace.configure("dra", str(tmp_path / "spool"), sampling_rate=0.5)
    found = FakeBackend(1).discover()
    client = FakeKubeClient()
    names = {}
    for slot, (key, pod_uid) in enumerate((("s", sampled),
                                           ("u", unsampled))):
        claim = bench_dra.allocated_claim(f"c{key}", 0, {"gpu": [slot]}, 5,
                                          1024)
        claim["status"]["reservedFor"] = [{"resource": "pods",
                                           "name": f"p{key}",
                                           "uid": pod_uid}]
        # the JAX package's verdict for the same claim
        assert jcontext.for_claim(claim, 0.5).sampled == (key == "s")
        client.add_resourceclaim(claim)
        names[key] = claim["metadata"]["uid"]
    state = DeviceState("n1", found.chips, base_dir=str(tmp_path / "dra"),
                        cdi_dir=str(tmp_path / "cdi"), minors=found.minors,
                        shim_host_dir=str(tmp_path / "d"),
                        lock_dir=str(tmp_path / "l"),
                        vmem_dir=str(tmp_path / "v"),
                        watcher_dir=str(tmp_path / "w"))
    driver = DraDriver("n1", ClaimSource(client), state)
    resp = driver.node_prepare(api.NodePrepareResourcesRequest(
        [api.Claim(uid, f"c{key}", bench_dra.NAMESPACE)
         for key, uid in names.items()]))
    assert not [e.error for e in resp.claims.values() if e.error]
    trace.flush()
    spans, _ = assemble.read_spools(str(tmp_path / "spool"))
    assert sorted((s.stage, s.pod_uid, s.service) for s in spans) == [
        ("dra.cdi", sampled, "dra"), ("dra.prepare", sampled, "dra")]
    cdi = next(s for s in spans if s.stage == "dra.cdi")
    assert cdi.attrs == {"claim": names["s"], "devices": 1}
    prep = next(s for s in spans if s.stage == "dra.prepare")
    assert prep.attrs == {"claim": names["s"]}
    assert prep.start_s <= cdi.start_s and cdi.dur_s <= prep.dur_s


def test_gate_off_pipeline_records_nothing(tmp_path, monkeypatch):
    threads = _tracing_threads()
    run = _pipeline(tmp_path, monkeypatch, traced=False)
    resp = run["resp"]
    assert consts.ENV_TRACE_ID not in resp.envs
    assert consts.ENV_TRACE_SAMPLED not in resp.envs
    assert not any(m.container_path == consts.TRACE_DIR
                   for m in resp.mounts)
    assert not run["traced_tenant"]
    assert not os.path.exists(run["spool"])
    ctx = context.TraceContext(trace_id=POD_UID)
    assert trace.span(ctx, "plugin.allocate") is trace._NULL_SPAN
    assert not trace.is_enabled() and not jtrace.is_enabled()
    assert _tracing_threads() <= threads


def _cli(argv: list[str]) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith("VTPU_")}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


PORT_VTRACE = ["-m", "vtpu_manager_torch.cmd.vtrace"]
JAX_VTRACE = [os.path.join(REPO, "scripts", "vtrace.py")]


@pytest.mark.parametrize("mode", [["--pod", POD_UID], ["--list"],
                                  ["--outliers"]],
                         ids=["pod", "list", "outliers"])
def test_vtrace_cli_prints_the_jax_documents(tmp_path, monkeypatch, mode):
    run = _pipeline(tmp_path, monkeypatch)
    steps = tmp_path / "no-rings"
    steps.mkdir()
    common = ["--spool-dir", run["spool"], "--steps-dir", str(steps),
              *mode, "--json"]
    mine = _cli(PORT_VTRACE + common)
    theirs = _cli(JAX_VTRACE + common + ["--explain-dir",
                                         str(tmp_path / "no-explain")])
    assert mine.returncode == theirs.returncode == 0, mine.stderr + \
        theirs.stderr
    doc, jdoc = json.loads(mine.stdout), json.loads(theirs.stdout)
    if mode[0] == "--pod":
        # the planes the port does not have: their keys are absent, and
        # the JAX CLI has nothing to put in them on this node
        assert {k: jdoc.pop(k) for k in ("utilization", "placement_decision",
                                         "slo")} == {
            "utilization": [], "placement_decision": None, "slo": []}
        assert [r["outcome"] for r in doc["compile_cache"]] == ["miss"]
    assert doc == jdoc


def test_vtrace_cli_text_and_exit_codes(tmp_path, monkeypatch):
    run = _pipeline(tmp_path, monkeypatch)
    args = ["--spool-dir", run["spool"], "--steps-dir", str(tmp_path)]
    mine = _cli(PORT_VTRACE + args + ["--pod", POD_UID])
    theirs = _cli(JAX_VTRACE + args + ["--pod", POD_UID, "--explain-dir",
                                       str(tmp_path / "no-explain")])
    assert mine.returncode == theirs.returncode == 0
    # the timeline and the compile-cache row print as the JAX CLI prints
    assert mine.stdout.splitlines() == [
        ln for ln in theirs.stdout.splitlines()
        if not ln.startswith(("  utilization", "  slo", "  decision"))]
    assert "compile-cache: miss" in mine.stdout
    assert _cli(PORT_VTRACE + args + ["--pod", "nobody"]).returncode == 1
    assert _cli(PORT_VTRACE + args).returncode == 2
    refused = _cli(PORT_VTRACE + args + ["--pod", POD_UID, "--explain-dir",
                                         str(tmp_path)])
    assert refused.returncode == 2
    assert "DecisionExplain is not ported" in refused.stderr


def test_trace_phase_picks_pods_by_the_mints_verdict(tmp_path):
    from vtpu_manager_torch import bench_trace
    for sampled in (True, False):
        name = bench_trace.pick_pod("pod-s", sampled)
        uid = bench_trace.bm.pod_uid(name)
        assert jcontext.mint({"metadata": {"uid": uid}},
                             bench_trace.RATE).sampled == sampled
    assert bench_trace.spool_state(str(tmp_path / "none")) == {}
