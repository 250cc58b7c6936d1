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
from vtpu_manager_torch.manager.watcher import (FakeSampler, NvmlSampler,
                                                TcWatcherDaemon)
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
