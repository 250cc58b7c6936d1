"""The port's node watcher and discovery, held to the JAX package's.

The attribution cases of tests/test_watcher.py:34-92 run on the port's
daemon; the JAX daemon and the port's, fed one ledger, write the same
feed; NVML discovery and sampling run against a stub that stands in for
the ctypes library.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import pytest

from vtpu_manager.config import vmem as jvmem
from vtpu_manager.manager.watcher import FakeSampler as JFakeSampler
from vtpu_manager.manager.watcher import TcWatcherDaemon as JDaemon
from vtpu_manager_torch.config import vmem
from vtpu_manager_torch.device.types import ChipSpec, MeshSpec
from vtpu_manager_torch.manager.watcher import (UTIL_UNKNOWN, FakeSampler,
                                                NvmlSampler, ProcReading,
                                                TcWatcherDaemon,
                                                outside_processes)
from vtpu_manager_torch.tpu import discovery


@pytest.fixture
def daemon(tmp_path):
    d = TcWatcherDaemon([0], FakeSampler(),
                        tc_path=str(tmp_path / "tc.config"),
                        vmem_path=str(tmp_path / "vmem.config"))
    yield d
    d.stop()


def shares(daemon):
    rec = daemon.tc_file.read_device(0)
    return {p.pid: p.util for p in rec.procs}


class TestAttribution:
    def test_equal_split_without_activity(self, daemon):
        daemon.vmem.record(101, 0, 2**20, owner_token=1)
        daemon.vmem.record(102, 0, 2**20, owner_token=2)
        daemon.sampler.values[0] = 80
        daemon.tick(now_ns=1)
        assert shares(daemon) == {101: 40, 102: 40}

    def test_activity_deltas_weight_shares(self, daemon):
        daemon.vmem.record(101, 0, 2**20, owner_token=1)
        daemon.vmem.record(102, 0, 2**20, owner_token=2)
        daemon.sampler.values[0] = 80
        daemon.tick(now_ns=1)
        daemon.vmem.bump_activity(101, 0, n=30, owner_token=1)
        daemon.vmem.bump_activity(102, 0, n=10, owner_token=2)
        daemon.tick(now_ns=2)
        assert shares(daemon) == {101: 60, 102: 20}
        daemon.tick(now_ns=3)        # idle tick: equal split again
        assert shares(daemon) == {101: 40, 102: 40}

    def test_lopsided_attribution_is_total(self, daemon):
        daemon.vmem.record(101, 0, 2**20, owner_token=1)
        daemon.vmem.record(102, 0, 2**20, owner_token=2)
        daemon.tick(now_ns=1)
        daemon.vmem.bump_activity(102, 0, n=50, owner_token=2)
        daemon.sampler.values[0] = 100
        daemon.tick(now_ns=2)
        assert shares(daemon) == {101: 0, 102: 100}

    def test_departed_resident_baseline_dropped(self, daemon):
        daemon.vmem.record(101, 0, 2**20, owner_token=1)
        daemon.vmem.bump_activity(101, 0, n=5, owner_token=1)
        daemon.sampler.values[0] = 50
        daemon.tick(now_ns=1)
        daemon.vmem.record(101, 0, 0)
        daemon.tick(now_ns=2)
        assert not any(k[:2] == (101, 0) for k in daemon._last_activity)
        daemon.vmem.record(101, 0, 2**20, owner_token=9)
        daemon.tick(now_ns=3)
        assert shares(daemon) == {101: 50}

    def test_feed_record_carries_bytes_and_tokens(self, daemon):
        daemon.vmem.record(101, 0, 3 << 20, owner_token=77)
        daemon.sampler.values[0] = 30
        daemon.tick(now_ns=5)
        rec = daemon.tc_file.read_device(0)
        assert (rec.timestamp_ns, rec.device_util) == (5, 30)
        assert [(p.pid, p.mem_used, p.owner_token) for p in rec.procs] == \
            [(101, 3 << 20, 77)]


class TestOutsideProcesses:
    """A process on the card that the ledger does not hold (F4's repair)."""

    def feed(self, daemon):
        rec = daemon.tc_file.read_device(0)
        return [(p.pid, p.util, p.mem_used, p.owner_token) for p in rec.procs]

    def test_outside_process_becomes_a_tokenless_resident(self, daemon):
        daemon.vmem.record(101, 0, 2**20, owner_token=1)
        daemon.sampler.values[0] = 90
        daemon.sampler.procs[0] = [ProcReading(101, 50, 3 << 20),
                                   ProcReading(555, 40, 5 << 20)]
        daemon.tick(now_ns=1)
        # the resident shares what the outside process did not take
        assert self.feed(daemon) == [(101, 50, 2**20, 1),
                                     (555, 40, 5 << 20, 0)]

    def test_split_among_residents_excludes_the_outside_share(self, daemon):
        daemon.vmem.record(101, 0, 2**20, owner_token=1)
        daemon.vmem.record(102, 0, 2**20, owner_token=2)
        daemon.sampler.values[0] = 100
        daemon.sampler.procs[0] = [ProcReading(101, 0, 0),
                                   ProcReading(102, 0, 0),
                                   ProcReading(700, 40, 0)]
        daemon.tick(now_ns=1)
        daemon.vmem.bump_activity(101, 0, n=30, owner_token=1)
        daemon.vmem.bump_activity(102, 0, n=10, owner_token=2)
        daemon.tick(now_ns=2)
        assert self.feed(daemon) == [(101, 45, 2**20, 1), (102, 15, 2**20, 2),
                                     (700, 40, 0, 0)]

    def test_outside_shares_are_capped_at_the_device(self, daemon):
        daemon.vmem.record(101, 0, 2**20, owner_token=1)
        daemon.sampler.values[0] = 30
        daemon.sampler.procs[0] = [ProcReading(101, 10, 0),
                                   ProcReading(700, 25, 0),
                                   ProcReading(701, 25, 0)]
        daemon.tick(now_ns=1)
        assert self.feed(daemon) == [(101, 0, 2**20, 1), (700, 25, 0, 0),
                                     (701, 5, 0, 0)]

    def test_a_process_of_unknown_use_is_written_as_such(self, daemon):
        """NVML on the H100 machine lists the contexts (every pid 1) and
        refuses their utilization: the process the ledger does not account
        for enters the feed of unknown use, and the residents share the
        whole card as without it."""
        daemon.vmem.record(101, 0, 2**20, owner_token=1)
        daemon.sampler.values[0] = 90
        daemon.sampler.procs[0] = [ProcReading(1, UTIL_UNKNOWN, 0),
                                   ProcReading(1, UTIL_UNKNOWN, 0)]
        daemon.tick(now_ns=1)
        assert self.feed(daemon) == [(101, 90, 2**20, 1),
                                     (1, UTIL_UNKNOWN, 0, 0)]

    def test_nvml_pids_that_match_no_ledger_pid(self, daemon):
        """The plugin's DaemonSet runs without the host's pid namespace:
        no NVML pid is a ledger pid, so count and memory decide. Two
        residents of 1 and 2 GiB, three processes on the card: the two of
        least memory at or above each resident's bytes are the residents
        (a context adds its own memory), the 4 GiB one is outside."""
        daemon.vmem.record(100, 0, 1 << 30, owner_token=1)
        daemon.vmem.record(101, 0, 2 << 30, owner_token=2)
        daemon.sampler.values[0] = 80
        daemon.sampler.procs[0] = [ProcReading(9001, 30, (2 << 30) + (5 << 28)),
                                   ProcReading(9000, 20, (1 << 30) + (1 << 29)),
                                   ProcReading(9200, 20, 4 << 30)]
        daemon.tick(now_ns=1)
        assert self.feed(daemon) == [(100, 30, 1 << 30, 1),
                                     (101, 30, 2 << 30, 2),
                                     (9200, 20, 4 << 30, 0)]
        # as many processes as residents: none is outside
        daemon.sampler.procs[0] = daemon.sampler.procs[0][:2]
        daemon.tick(now_ns=2)
        assert [p[0] for p in self.feed(daemon)] == [100, 101]

    @pytest.mark.parametrize("readings", [
        None,                                           # no per-process data
        [],                                             # NVML lists nobody
        [ProcReading(101, 35, 0), ProcReading(102, 5, 0)],  # all in the ledger
        [ProcReading(7001, 35, 2**21), ProcReading(7002, 5, 2**21)],  # other ns
    ])
    def test_every_process_in_the_ledger_leaves_the_feed_as_jax(
            self, tmp_path, readings):
        ledger_path = str(tmp_path / "vmem.config")
        mine = TcWatcherDaemon([0], FakeSampler(),
                               tc_path=str(tmp_path / "port.tc"),
                               vmem_path=ledger_path)
        theirs = JDaemon([0], JFakeSampler(),
                         tc_path=str(tmp_path / "jax.tc"),
                         vmem_path=ledger_path)
        try:
            mine.vmem.record(101, 0, 2**20, owner_token=1)
            mine.vmem.record(102, 0, 2**20, owner_token=2)
            if readings is not None:
                mine.sampler.procs[0] = readings
            for tick in range(1, 4):
                mine.vmem.bump_activity(101, 0, n=tick, owner_token=1)
                mine.sampler.values[0] = theirs.sampler.values[0] = 40
                mine.tick(now_ns=tick)
                theirs.tick(now_ns=tick)
                with open(str(tmp_path / "port.tc"), "rb") as a, \
                        open(str(tmp_path / "jax.tc"), "rb") as b:
                    assert a.read() == b.read()
        finally:
            mine.stop()
            theirs.stop()

    def test_rule_prefers_pids_when_namespaces_agree(self):
        residents = [vmem.VmemEntry(pid=10, host_index=0, bytes=5 << 30,
                                    owner_token=1, activity=0,
                                    last_update_ns=0)]
        # one pid in common: the other process is outside whatever its
        # memory says
        out = outside_processes([ProcReading(10, 1, 0),
                                 ProcReading(11, 1, 6 << 30)], residents)
        assert out == [ProcReading(11, 1, 6 << 30)]


class TestLedgerActivity:
    def test_record_update_preserves_activity(self, tmp_path):
        led = vmem.VmemLedger(str(tmp_path / "v.config"), create=True)
        led.record(os.getpid(), 0, 2**20, owner_token=7)
        led.bump_activity(os.getpid(), 0, n=3, owner_token=7)
        led.record(os.getpid(), 0, 2**21, owner_token=7)
        (entry,) = led.entries()
        assert entry.activity == 3 and entry.bytes == 2**21
        led.close()

    def test_clear_resets_activity(self, tmp_path):
        led = vmem.VmemLedger(str(tmp_path / "v.config"), create=True)
        led.record(os.getpid(), 0, 2**20)
        led.bump_activity(os.getpid(), 0)
        led.record(os.getpid(), 0, 0)
        assert led.entries() == []
        led.record(os.getpid(), 0, 2**20)
        (entry,) = led.entries()
        assert entry.activity == 0
        led.close()


@pytest.mark.parametrize("seed", range(3))
def test_same_ledger_same_feed_as_jax(seed, tmp_path):
    """Both daemons tick over one ledger with the same sampled values;
    their feeds must agree record for record."""
    rng = np.random.default_rng(seed)
    ledger_path = str(tmp_path / "vmem.config")
    mine = TcWatcherDaemon([0, 1], FakeSampler(),
                           tc_path=str(tmp_path / "port.tc"),
                           vmem_path=ledger_path)
    theirs = JDaemon([0, 1], JFakeSampler(),
                     tc_path=str(tmp_path / "jax.tc"),
                     vmem_path=ledger_path)
    writer = jvmem.VmemLedger(ledger_path)
    pids = [int(p) for p in rng.integers(1000, 10**6, size=5)]
    try:
        for tick in range(1, 8):
            for pid in pids:
                host = pid % 2
                if rng.random() < 0.5:
                    writer.record(pid, host, int(rng.integers(0, 2**34)),
                                  owner_token=pid * 7)
                if rng.random() < 0.7:
                    writer.bump_activity(pid, host,
                                         n=int(rng.integers(1, 20)),
                                         owner_token=pid * 7)
            for index in (0, 1):
                value = int(rng.integers(0, 101))
                mine.sampler.values[index] = value
                theirs.sampler.values[index] = value
            mine.tick(now_ns=tick)
            theirs.tick(now_ns=tick)
            for index in (0, 1):
                a = mine.tc_file.read_device(index)
                b = theirs.tc_file.read_device(index)
                assert (a.timestamp_ns, a.device_util) == \
                    (b.timestamp_ns, b.device_util)
                assert [(p.pid, p.util, p.mem_used, p.owner_token)
                        for p in a.procs] == \
                    [(p.pid, p.util, p.mem_used, p.owner_token)
                     for p in b.procs]
    finally:
        writer.close()
        mine.stop()
        theirs.stop()


def test_daemon_thread_ticks(tmp_path):
    import time
    d = TcWatcherDaemon([0], FakeSampler(), tc_path=str(tmp_path / "t"),
                        vmem_path=str(tmp_path / "v"), interval_ms=5)
    d.sampler.values[0] = 42
    d.start()
    try:
        deadline = time.monotonic() + 5
        while d.ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        rec = d.tc_file.read_device(0)
        assert d.ticks >= 3 and d.errors == 0
        assert rec.device_util == 42 and rec.is_fresh()
    finally:
        d.stop()


# --- NVML over ctypes, against a stub library ----------------------------


class StubNvml:
    """Stands in for libnvidia-ml.so.1: the same functions, writing
    through the same ctypes arguments, over a list of cards."""

    def __init__(self, cards, fail=None):
        self.cards = cards
        self.fail = fail or {}
        self.calls = []

    def _rc(self, name):
        self.calls.append(name)
        return self.fail.get(name, 0)

    def nvmlInit_v2(self):
        return self._rc("nvmlInit_v2")

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.cards)
        return self._rc("nvmlDeviceGetCount_v2")

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        handle._obj.value = 0x1000 + index.value
        return self._rc("nvmlDeviceGetHandleByIndex_v2")

    def _card(self, handle):
        return self.cards[handle.value - 0x1000]

    def nvmlDeviceGetUUID(self, handle, buf, size):
        buf.value = self._card(handle)["uuid"].encode()
        return self._rc("nvmlDeviceGetUUID")

    def nvmlDeviceGetName(self, handle, buf, size):
        buf.value = self._card(handle)["name"].encode()
        return self._rc("nvmlDeviceGetName")

    def nvmlDeviceGetMemoryInfo(self, handle, mem):
        mem._obj.total = self._card(handle)["memory"]
        return self._rc("nvmlDeviceGetMemoryInfo")

    def nvmlDeviceGetMemoryInfo_v2(self, handle, mem):
        assert mem._obj.version == discovery.NVML_MEMORY_V2
        mem._obj.total = self._card(handle)["memory"]
        mem._obj.reserved = self._card(handle)["reserved"]
        return self._rc("nvmlDeviceGetMemoryInfo_v2")

    def nvmlDeviceGetMinorNumber(self, handle, minor):
        minor._obj.value = self._card(handle).get("minor", 0)
        return self._rc("nvmlDeviceGetMinorNumber")

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        util._obj.gpu = self._card(handle)["util"]
        return self._rc("nvmlDeviceGetUtilizationRates")

    def nvmlDeviceGetComputeRunningProcesses_v3(self, handle, count, infos):
        procs = self._card(handle).get("procs", [])
        if infos is None or count._obj.value < len(procs):
            count._obj.value = len(procs)
            return self._rc("nvmlDeviceGetComputeRunningProcesses_v3") or (
                7 if procs else 0)
        for i, (pid, mem) in enumerate(procs):
            infos[i].pid, infos[i].usedGpuMemory = pid, mem
        count._obj.value = len(procs)
        return self._rc("nvmlDeviceGetComputeRunningProcesses_v3")

    def nvmlDeviceGetProcessUtilization(self, handle, samples, count, since):
        rows = [r for r in self._card(handle).get("samples", [])
                if r[1] > since.value]
        rc = self._rc("nvmlDeviceGetProcessUtilization")
        if rc or not rows:
            return rc or 6      # NVML_ERROR_NOT_FOUND: nothing newer
        if samples is None or count._obj.value < len(rows):
            count._obj.value = len(rows)
            return 7            # NVML_ERROR_INSUFFICIENT_SIZE
        for i, (pid, ts, sm) in enumerate(rows):
            samples[i].pid, samples[i].timeStamp = pid, ts
            samples[i].smUtil = sm
        count._obj.value = len(rows)
        return 0


H100 = {"uuid": "GPU-5f1e2d3c-aaaa-bbbb-cccc-000000000001",
        "name": "NVIDIA H100 80GB HBM3", "memory": 85520809984,
        "reserved": 489684992, "util": 37, "minor": 3}
H100_PCIE = {"uuid": "GPU-5f1e2d3c-aaaa-bbbb-cccc-000000000002",
             "name": "NVIDIA H100 PCIe", "memory": 85520809984,
             "reserved": 489684992, "util": 5, "minor": 0}


def test_nvml_backend_reads_every_card():
    nvml = discovery.Nvml(StubNvml([H100, H100_PCIE]))
    result = discovery.NvmlBackend(nvml).discover()
    assert [c.uuid for c in result.chips] == [H100["uuid"], H100_PCIE["uuid"]]
    assert [c.chip_type for c in result.chips] == ["nvidia-h100-sxm",
                                                   "nvidia-h100-pcie"]
    assert [c.core_count for c in result.chips] == [132, 114]
    # what a CUDA context sees: NVML's total less the firmware's share
    assert all(c.memory == 85520809984 - 489684992 for c in result.chips)
    assert [c.index for c in result.chips] == [0, 1]
    assert result.mesh == MeshSpec((1, 2, 1))
    assert result.chips[1].coords == (0, 1, 0)
    # the device node's minor is NVML's, not the index
    assert result.minors == {0: 3, 1: 0}


def test_nvml_failure_raises_not_falls_back():
    nvml = discovery.Nvml(StubNvml([H100], fail={"nvmlDeviceGetUUID": 999}))
    with pytest.raises(discovery.NvmlError):
        discovery.NvmlBackend(nvml).discover()
    with pytest.raises(discovery.NvmlError):
        discovery.Nvml(StubNvml([], fail={"nvmlInit_v2": 9}))


def test_nvml_sampler_reads_utilization():
    stub = StubNvml([H100, H100_PCIE])
    sampler = NvmlSampler(discovery.Nvml(stub))
    assert sampler.sample(0) == 37 and sampler.sample(1) == 5
    assert sampler.sample(0) == 37
    # one handle lookup per card, not per sample
    assert stub.calls.count("nvmlDeviceGetHandleByIndex_v2") == 2
    stub.fail["nvmlDeviceGetUtilizationRates"] = 15
    with pytest.raises(discovery.NvmlError):
        sampler.sample(0)


def test_nvml_sampler_reads_each_process(monkeypatch):
    now_us = 1_700_000_000_000_000
    monkeypatch.setattr("time.time_ns", lambda: now_us * 1000)
    card = dict(H100, procs=[(4001, 6 << 30), (4002, 2**64 - 1), (4003, 1)],
                samples=[(4001, now_us - 900_000, 20),
                         (4001, now_us - 100_000, 35),
                         (4002, now_us - 2_000_000, 60)])
    stub = StubNvml([card])
    sampler = NvmlSampler(discovery.Nvml(stub))
    # each process's newest sample; one older than a second reads 0, as
    # does a process with none; NVML's "not available" memory reads 0
    assert sampler.processes(0) == [ProcReading(4001, 35, 6 << 30),
                                    ProcReading(4002, 0, 0),
                                    ProcReading(4003, 0, 1)]
    # nothing newer: the newest sample stands
    assert sampler.processes(0)[0] == ProcReading(4001, 35, 6 << 30)
    card["samples"].append((4001, now_us - 50_000, 10))
    assert sampler.processes(0)[0] == ProcReading(4001, 10, 6 << 30)


@pytest.mark.parametrize("code", [2, 3])    # INVALID_ARGUMENT, NOT_SUPPORTED
def test_nvml_sampler_without_per_process_data_reads_none(code):
    """NVML refuses the process list for good: no reading, and it is asked
    once."""
    stub = StubNvml([dict(H100, procs=[(4001, 1)])],
                    fail={"nvmlDeviceGetComputeRunningProcesses_v3": code})
    sampler = NvmlSampler(discovery.Nvml(stub))
    assert sampler.per_process
    assert sampler.processes(0) is None
    assert sampler.processes(0) is None
    assert not sampler.per_process
    # asked once, then never again; the device's reading still works
    assert stub.calls.count("nvmlDeviceGetComputeRunningProcesses_v3") == 1
    assert sampler.sample(0) == 37


@pytest.mark.parametrize("code", [2, 3])
def test_nvml_sampler_without_per_process_utilization_reads_unknown_use(code):
    """NVML lists the card's processes and refuses their utilization for
    good (as on the H100 machine, code 3): each process is read of unknown
    use, and the utilization is asked once."""
    stub = StubNvml([dict(H100, procs=[(1, 2**64 - 1), (1, 2**64 - 1)])],
                    fail={"nvmlDeviceGetProcessUtilization": code})
    sampler = NvmlSampler(discovery.Nvml(stub))
    for _ in range(2):
        assert sampler.processes(0) == [ProcReading(1, UTIL_UNKNOWN, 0)] * 2
    assert sampler.per_process and not sampler.per_process_util
    assert stub.calls.count("nvmlDeviceGetProcessUtilization") == 1


def test_a_transient_nvml_error_costs_one_reading(monkeypatch):
    """Any other failure (a busy driver, a reset) skips that tick's reading
    and leaves per-process reading on."""
    now_us = 1_700_000_000_000_000
    monkeypatch.setattr("time.time_ns", lambda: now_us * 1000)
    card = dict(H100, procs=[(4001, 6 << 30)],
                samples=[(4001, now_us - 100_000, 35)])
    stub = StubNvml([card])
    sampler = NvmlSampler(discovery.Nvml(stub))
    assert sampler.processes(0) == [ProcReading(4001, 35, 6 << 30)]
    stub.fail["nvmlDeviceGetComputeRunningProcesses_v3"] = 999
    assert sampler.processes(0) is None
    del stub.fail["nvmlDeviceGetComputeRunningProcesses_v3"]
    stub.fail["nvmlDeviceGetProcessUtilization"] = 15  # NVML_ERROR_UNKNOWN
    # the newest sample stands
    assert sampler.processes(0) == [ProcReading(4001, 35, 6 << 30)]
    del stub.fail["nvmlDeviceGetProcessUtilization"]
    assert sampler.per_process and sampler.per_process_util
    card["samples"].append((4001, now_us - 50_000, 10))
    assert sampler.processes(0) == [ProcReading(4001, 10, 6 << 30)]


def test_nvml_sampler_without_nvml_raises(monkeypatch):
    monkeypatch.setattr(discovery.Nvml, "load", classmethod(lambda c: None))
    with pytest.raises(discovery.NvmlError):
        NvmlSampler()


def test_no_nvml_library_means_no_cards(monkeypatch):
    def missing(*a, **k):
        raise OSError("libnvidia-ml.so.1: cannot open shared object file")
    monkeypatch.setattr(ctypes, "CDLL", missing)
    assert discovery.Nvml.load() is None
    assert discovery.NvmlBackend().discover() is None


def test_discover_takes_the_first_backend_with_cards():
    class Empty:
        def discover(self):
            return None

    result = discovery.discover([Empty(), discovery.FakeBackend(2),
                                 discovery.NvmlBackend(discovery.Nvml(
                                     StubNvml([H100])))])
    assert [c.uuid for c in result.chips] == ["fake-0", "fake-1"]
    assert result.chips[0].memory == 80 * 2**30
    assert result.chips[0].core_count == 132
    assert discovery.discover([Empty()]) is None


def test_chip_spec_wire_matches_jax():
    from vtpu_manager.device.types import ChipSpec as JChip
    from vtpu_manager.device.types import MeshSpec as JMesh
    chip = discovery.FakeBackend(3).discover().chips[2]
    wire = chip.to_wire()
    assert JChip.from_wire(wire).to_wire() == wire
    assert ChipSpec.from_wire(wire) == chip
    mesh = MeshSpec((1, 3, 1), (False, True, False))
    assert JMesh.from_wire(mesh.to_wire()).to_wire() == mesh.to_wire()
    assert MeshSpec.from_wire({"shape": [2]}) == MeshSpec((2, 1, 1))
