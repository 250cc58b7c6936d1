"""The port's step ring and the tenant's step telemetry, against the JAX
package's ring.

The cases of tests/test_telemetry.py (the ring, a writer subprocess
hammering it while this process reads, the gate-off contract) on the
port's ring; each package's reader on the other's rings, field for field;
and the interposer's throttle wait charged per record from a stub counter.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import time
from dataclasses import astuple

import numpy as np
import pytest

from vtpu_manager.telemetry import stepring as jring
from vtpu_manager_torch import bench_steps
from vtpu_manager_torch.runtime import client as rc
from vtpu_manager_torch.telemetry import stepring
from vtpu_manager_torch.util import consts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _telemetry_off_between_tests():
    rc._reset_step_telemetry()
    yield
    rc._reset_step_telemetry()


class TestStepRing:
    def test_roundtrip_and_cursor(self, tmp_path):
        path = str(tmp_path / "ring")
        w = stepring.StepRingWriter(path, trace_id="tid-1")
        for i in range(10):
            w.record(duration_ns=1_000_000 + i, throttle_wait_ns=i * 3,
                     hbm_highwater_bytes=i * 7, compiled=(i == 0))
        r = stepring.StepRingReader(path)
        recs, cursor, dropped = r.poll(0)
        assert cursor == 10 and dropped == 0
        assert [x.index for x in recs] == list(range(10))
        assert recs[0].compiled and not recs[1].compiled
        assert all(x.throttle_wait_ns == x.index * 3 for x in recs)
        assert r.trace_id == "tid-1" and r.writer_pid == os.getpid()
        assert r.poll(cursor) == ([], 10, 0)
        w.record(5)
        recs2, cursor2, _ = r.poll(cursor)
        assert [x.index for x in recs2] == [10] and cursor2 == 11
        w.close()
        r.close()

    def test_wraparound_counts_overwritten_as_drops(self, tmp_path):
        path = str(tmp_path / "ring")
        w = stepring.StepRingWriter(path)
        n = stepring.RING_CAPACITY + 40
        for i in range(n):
            w.record(duration_ns=i)
        r = stepring.StepRingReader(path)
        recs, cursor, dropped = r.poll(0)
        assert cursor == n and dropped == 40
        assert len(recs) == stepring.RING_CAPACITY
        assert recs[0].index == 40 and recs[-1].index == n - 1
        w.close()
        r.close()

    def test_writer_restart_continues_sequence(self, tmp_path):
        path = str(tmp_path / "ring")
        w = stepring.StepRingWriter(path, trace_id="t")
        for _ in range(5):
            w.record(duration_ns=1)
        w.close()
        w2 = stepring.StepRingWriter(path)
        assert w2.writes == 5
        w2.record(duration_ns=2)
        r = stepring.StepRingReader(path)
        recs, cursor, dropped = r.poll(0)
        assert cursor == 6 and dropped == 0
        assert [x.index for x in recs] == list(range(6))
        assert r.trace_id == "t"
        w2.close()
        r.close()

    def test_crashed_writer_odd_seq_never_validates(self, tmp_path):
        path = str(tmp_path / "ring")
        w = stepring.StepRingWriter(path)
        w.record(duration_ns=111)
        w.close()
        with open(path, "r+b") as f:          # a crash left slot 0 odd
            f.seek(stepring.record_offset(0))
            f.write(struct.pack("<Q", 7))
        r = stepring.StepRingReader(path)
        assert r.read_record(0) is None
        recs, cursor, dropped = r.poll(0)
        assert recs == [] and cursor == 1 and dropped == 1
        w2 = stepring.StepRingWriter(path)
        for i in range(stepring.RING_CAPACITY):
            w2.record(duration_ns=i)
        rec = r.read_record(stepring.RING_CAPACITY)    # slot 0, lap 1
        assert rec is not None and \
            rec.duration_ns == stepring.RING_CAPACITY - 1
        w2.close()
        r.close()

    def test_second_writer_excluded(self, tmp_path):
        path = str(tmp_path / "ring")
        w = stepring.StepRingWriter(path)
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[2])\n"
             "from vtpu_manager_torch.telemetry import stepring\n"
             "try:\n"
             "    stepring.StepRingWriter(sys.argv[1], lock_timeout_s=0.2)\n"
             "except TimeoutError:\n"
             "    sys.exit(42)\n"
             "sys.exit(0)\n", path, REPO],
            capture_output=True, text=True, timeout=60)
        assert proc.returncode == 42, proc.stderr
        w.close()

    def test_unstable_head_skips_poll(self, tmp_path, monkeypatch):
        path = str(tmp_path / "ring")
        w = stepring.StepRingWriter(path)
        w.record(duration_ns=1)
        r = stepring.StepRingReader(path)
        monkeypatch.setattr(r, "_writes", lambda: None)
        assert r.poll(0) == ([], 0, 0)
        monkeypatch.undo()
        recs, cursor, dropped = r.poll(0)
        assert len(recs) == 1 and cursor == 1 and dropped == 0
        w.close()
        r.close()

    def test_tenant_controlled_trace_id_is_sanitized(self, tmp_path):
        path = str(tmp_path / "ring")
        w = stepring.StepRingWriter(path, trace_id='"} 1\nx{n="1"} 1')
        w.close()
        r = stepring.StepRingReader(path)
        assert not set('"{}\n') & set(r.trace_id)
        r.close()

    def test_recreated_ring_resets_cursor(self, tmp_path):
        path = str(tmp_path / "ring")
        w = stepring.StepRingWriter(path)
        for _ in range(10):
            w.record(duration_ns=1)
        r = stepring.StepRingReader(path)
        _, cursor, _ = r.poll(0)
        r.close()
        w.close()
        os.unlink(path)
        w2 = stepring.StepRingWriter(path)
        w2.record(duration_ns=7)
        r2 = stepring.StepRingReader(path)
        recs, new_cursor, _ = r2.poll(cursor)
        assert [x.index for x in recs] == [0] and new_cursor == 1
        w2.close()
        r2.close()

    def test_bad_ring_refused(self, tmp_path):
        path = tmp_path / "ring"
        path.write_bytes(b"\0" * stepring.FILE_SIZE)
        with pytest.raises(ValueError):
            stepring.StepRingReader(str(path))


@pytest.mark.parametrize("name", ["HEADER_SIZE", "RECORD_SIZE", "FILE_SIZE",
                                  "MAGIC", "VERSION", "RING_CAPACITY",
                                  "HEADER_OFFSETS", "RECORD_OFFSETS",
                                  "FLAG_COMPILE", "FLAG_EXEC_ERROR"])
def test_layout_equals_jax(name):
    assert getattr(stepring, name) == getattr(jring, name)


_TORTURE_WRITER = """
import sys
sys.path.insert(0, sys.argv[3])
from vtpu_manager_torch.telemetry import stepring
w = stepring.StepRingWriter(sys.argv[1], trace_id="torture")
for i in range(int(sys.argv[2])):
    w.record(duration_ns=i * 1000 + 1, throttle_wait_ns=i * 3,
             hbm_highwater_bytes=i * 7, compiled=(i % 2 == 0),
             start_mono_ns=i * 11)
w.close()
"""


def test_concurrent_writer_never_tears_a_read(tmp_path):
    """A writer subprocess hammers the ring while this process tails it:
    every record read is whole, and the cursor never goes back."""
    path = str(tmp_path / "ring")
    n = 20000
    stepring.StepRingWriter(path).close()
    proc = subprocess.Popen([sys.executable, "-c", _TORTURE_WRITER, path,
                             str(n), REPO])
    try:
        r = stepring.StepRingReader(path)
        cursor = seen = 0
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            recs, new_cursor, _ = r.poll(cursor)
            assert new_cursor >= cursor
            for rec in recs:
                assert rec.duration_ns == rec.index * 1000 + 1
                assert rec.throttle_wait_ns == rec.index * 3
                assert rec.hbm_highwater_bytes == rec.index * 7
                assert rec.start_mono_ns == rec.index * 11
                assert rec.compiled == (rec.index % 2 == 0)
            seen += len(recs)
            cursor = new_cursor
            if cursor >= n and proc.poll() is not None:
                break
        assert cursor == n and seen > 0
        r.close()
    finally:
        proc.wait(timeout=120)
    assert proc.returncode == 0


# --- across packages ------------------------------------------------------

def _records(seed, n):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 2**40, size=(n, 4)).tolist()
    return [dict(duration_ns=d, throttle_wait_ns=w, hbm_highwater_bytes=h,
                 start_mono_ns=s, compiled=(i == 0))
            for i, (d, w, h, s) in enumerate(cols)]


@pytest.mark.parametrize("n", [3, stepring.RING_CAPACITY + 5])
def test_jax_reader_reads_the_port_ring(tmp_path, n):
    path = str(tmp_path / "ring")
    w = stepring.StepRingWriter(path, trace_id="port-1")
    for rec in _records(n, n):
        w.record(**rec)
    w.close()
    mine, theirs = stepring.StepRingReader(path), jring.StepRingReader(path)
    a, b = mine.poll(0), theirs.poll(0)
    assert [astuple(x) for x in a[0]] == [astuple(x) for x in b[0]]
    assert a[1:] == b[1:] and theirs.trace_id == "port-1"
    assert theirs.writer_pid == os.getpid()
    mine.close()
    theirs.close()


@pytest.mark.parametrize("n", [1, 40])
def test_port_reader_reads_the_jax_ring(tmp_path, n):
    path = str(tmp_path / "ring")
    w = jring.StepRingWriter(path, trace_id="jax-1")
    for rec in _records(n + 100, n):
        w.record(**rec, spilled_bytes=5, spill_events=1, comm_time_ns=9,
                 collective_count=2, spill_fill_time_ns=4)
    w.close()
    mine, theirs = stepring.StepRingReader(path), jring.StepRingReader(path)
    recs, cursor, dropped = mine.poll(0)
    assert [astuple(x) for x in recs] == \
        [astuple(x) for x in theirs.poll(0)[0]]
    assert (cursor, dropped, mine.trace_id) == (n, 0, "jax-1")
    assert recs[0].comm_time_ns == 9 and recs[-1].spill_fill_time_ns == 4
    mine.close()
    theirs.close()


def test_port_ring_file_is_byte_identical_to_jax(tmp_path, monkeypatch):
    mine, theirs = str(tmp_path / "a"), str(tmp_path / "b")
    for mod, path in ((stepring, mine), (jring, theirs)):
        w = mod.StepRingWriter(path, trace_id="same")
        for rec in _records(7, 9):
            w.record(**rec)
        w.close()
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


# --- the tenant side: step_telemetry() ------------------------------------

class TestGateOff:
    def test_no_env_no_writer_no_file(self, tmp_path, monkeypatch):
        monkeypatch.delenv(consts.ENV_STEP_TELEMETRY, raising=False)
        monkeypatch.setenv(consts.ENV_STEP_RING_PATH, str(tmp_path / "ring"))
        assert rc.step_telemetry() is None
        assert not os.path.exists(str(tmp_path / "ring"))
        monkeypatch.setenv(consts.ENV_STEP_TELEMETRY, "true")
        assert rc.step_telemetry() is None     # decided once

    def test_off_cost_is_one_branch(self, monkeypatch):
        monkeypatch.delenv(consts.ENV_STEP_TELEMETRY, raising=False)
        rc.step_telemetry()
        calls = []
        real_get = os.environ.get

        def counting_get(*a, **k):
            calls.append(a)
            return real_get(*a, **k)

        monkeypatch.setattr(os.environ.__class__, "get", counting_get)
        try:
            for _ in range(100):
                assert rc.step_telemetry() is None
        finally:
            monkeypatch.undo()
        assert calls == []

    def test_env_arms_writer(self, tmp_path, monkeypatch):
        ring = str(tmp_path / "tel" / "ring")
        monkeypatch.setenv(consts.ENV_STEP_TELEMETRY, "true")
        monkeypatch.setenv(consts.ENV_STEP_RING_PATH, ring)
        monkeypatch.setenv(consts.ENV_TRACE_ID, "trace-77")
        w = rc.step_telemetry()
        assert w is not None and rc.step_telemetry() is w
        w.record(duration_ns=123)
        r = stepring.StepRingReader(ring)
        assert r.trace_id == "trace-77" and len(r.poll(0)[0]) == 1
        r.close()

    def test_broken_mount_degrades_to_none(self, tmp_path, monkeypatch):
        blocker = tmp_path / "file"
        blocker.write_text("")
        monkeypatch.setenv(consts.ENV_STEP_TELEMETRY, "true")
        monkeypatch.setenv(consts.ENV_STEP_RING_PATH,
                           str(blocker / "sub" / "ring"))
        assert rc.step_telemetry() is None


def test_interposer_counter_absent_without_interposer():
    assert rc._interposer_counter("vtpu_throttle_wait_ns_total") is None


def test_records_charge_the_interposer_wait_deltas(tmp_path):
    totals = iter([1000, 1500, 1500, 4000, 10])
    ring = stepring.StepRingWriter(str(tmp_path / "ring"))
    w = rc._ShimWaitStepRing(ring, lambda: next(totals))
    for _ in range(4):
        w.record(duration_ns=10)
    w.record(duration_ns=10, throttle_wait_ns=77)    # the caller's value
    r = stepring.StepRingReader(str(tmp_path / "ring"))
    recs, _, _ = r.poll(0)
    # deltas 500, 0, 2500; a reloaded counter (10 < 4000) re-baselines
    assert [x.throttle_wait_ns for x in recs] == [500, 0, 2500, 0, 77]
    assert w.writes == 5
    w.close()
    r.close()


def test_quota_step_writes_one_record_per_step(tmp_path, monkeypatch):
    ring = str(tmp_path / "ring")
    monkeypatch.setenv(consts.ENV_STEP_TELEMETRY, "true")
    monkeypatch.setenv(consts.ENV_STEP_RING_PATH, ring)
    ms = bench_steps.quota_step_measure(dim=16, warmup=3, steps=5,
                                        device="cpu")
    r = stepring.StepRingReader(ring)
    recs, cursor, _ = r.poll(0)
    assert cursor == 8 and [x.compiled for x in recs] == [True] + [False] * 7
    assert all(x.duration_ns > 0 for x in recs) and ms > 0
    assert r.writer_pid == os.getpid()
    r.close()


def test_quota_step_without_the_gate_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv(consts.ENV_STEP_TELEMETRY, raising=False)
    monkeypatch.setenv(consts.ENV_STEP_RING_PATH, str(tmp_path / "ring"))
    bench_steps.quota_step_measure(dim=16, warmup=2, steps=2, device="cpu")
    assert not os.path.exists(str(tmp_path / "ring"))
