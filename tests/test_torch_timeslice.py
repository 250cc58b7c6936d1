"""Two tenants on a time-sliced card are each charged their own device
time (ROADMAP R9, the repair of F3).

Two CUDA contexts on one card without MPS take turns in time slices: a
12 ms kernel of one tenant, launched while the other's kernel runs, ends
12 ms of its own work later plus the other's slices in between, and the
events around it measure that whole span. The fake driver's
FAKE_TIMESLICE_US models it: while both processes have work queued,
execution alternates in slices of that length. A q50 and a q25 tenant,
12 ms kernels and 2 ms slices, run together: each takes its quota of the
card (within 5 points) and is charged its own execution time (within 5 %),
not the sliced spans.

Kernels under a millisecond get no window; beside a co-tenant they are
charged the lower envelope of their spans, so 0.5 ms kernels under 2 ms
slices are held to the same bands.

The tenants' sampling windows live in a node-shared file that any process
can write; a window no tenant of the card would open (longer than the
interposer's maximum, or held by no tenant in the ledger) must hold no
tenant back.

Beside a process outside the interposer (ROADMAP R11, the repair of F4) no
window can find the card idle, since that process never stands aside. The
watcher writes it into the feed as a tokenless resident, with its own
utilization where the sampler reads one per process (the fake's
per-process busy ns standing in for NVML's) and of unknown use where it
cannot (NVML on the H100 machine), and the metered tenant measures its
long kernels by the interposer's slice clock, which leaves out the time
the card gave the other process (the fake writes the clock's record from
its own accounting of each process's busy ns): q50 beside an unmetered q25
is charged its own kernel time within 5 % and takes its quota within 5
points, either way.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import time

import pytest

from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.config.vmem import fnv64
from vtpu_manager_torch.manager.watcher import (UTIL_UNKNOWN, ProcReading,
                                                TcWatcherDaemon)

EXEC_US = 12_000
SLICE_US = 2_000
# q50 outlives q25 (150 x 24 ms against 50 x 48 ms at their quotas), so
# every q25 kernel runs beside a co-tenant
ITERS = {50: 150, 25: 50}
SHORT_US = 500   # the same seconds of work in kernels without a window
QUOTA_BAND = 5.0
CHARGE_REL = 0.05


def slice_layout(fake: str) -> dict[str, int]:
    """fake_cuda_driver.cc's SharedChip and SliceProc, as the fake itself
    lays them out (fake_slice_layout)."""
    out = (ctypes.c_uint64 * 7)()
    n = ctypes.CDLL(fake).fake_slice_layout(out, 7)
    assert n == 7
    return dict(zip(("chip_size", "chip_busy", "procs", "proc_size",
                     "proc_pid", "proc_busy", "nprocs"), out))


class BusySampler:
    """The card's utilization from the fake's shared busy counter, and
    each process's from its queue's (what NVML reads per process); with
    `per_process_util` False, the processes of unknown use (what NVML on
    the H100 machine gives)."""

    def __init__(self, state_path: str, fake: str, extra: list | None = None,
                 per_process_util: bool = True):
        self.path = state_path
        self.layout = slice_layout(fake)
        self.extra = extra or []
        self.per_process_util = per_process_util
        self.last = (0, time.monotonic_ns())
        self.last_procs: dict[int, tuple[int, int]] = {}

    def sample(self, host_index: int) -> int:
        with open(self.path, "rb") as f:
            busy, = struct.unpack_from("<Q", f.read(),
                                       self.layout["chip_busy"])
        now = time.monotonic_ns()
        prev_busy, prev_t = self.last
        self.last = (busy, now)
        return min(100, int(100 * (busy - prev_busy) / max(now - prev_t, 1)))

    def processes(self, host_index: int) -> list[ProcReading]:
        with open(self.path, "rb") as f:
            raw = f.read()
        now = time.monotonic_ns()
        lay = self.layout
        out = []
        for i in range(lay["nprocs"]):
            at = lay["procs"] + i * lay["proc_size"]
            if len(raw) < at + lay["proc_size"]:
                break
            pid, = struct.unpack_from("<i", raw, at + lay["proc_pid"])
            busy, = struct.unpack_from("<Q", raw, at + lay["proc_busy"])
            if pid == 0:
                continue
            prev_busy, prev_t = self.last_procs.get(pid, (busy, now))
            self.last_procs[pid] = (busy, now)
            util = min(100, int(100 * (busy - prev_busy) / max(now - prev_t,
                                                                1)))
            out.append(ProcReading(
                pid, util if self.per_process_util else UTIL_UNKNOWN, 0))
        return out + self.extra


def plant_window(lock_dir: str, until_ns: int, owner: int) -> None:
    """Writes device 0's sampling window (until, owner) as a process that
    is no tenant of the card could."""
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "vtpu_0.window"), "wb") as f:
        f.write(struct.pack("<QQ", until_ns, owner))


def run_pair(tmp_path, shim: str, fake: str, slice_us: int,
             window: tuple[int, int] | None = None,
             exec_us: int = EXEC_US, unmetered: int | None = None,
             extra: list | None = None,
             outside_iters: int | None = None,
             per_process_util: bool = True) -> dict:
    """The q50 + q25 pair, the same seconds of work in kernels of
    `exec_us`; `window` (until_ns, owner) is planted first. The tenant of
    quota `unmetered` runs without the interposer (no ledger entry, no
    throttle, no counters); `extra` readings join the sampler's processes
    (processes on the card that run nothing); with `outside_iters` a third
    process without the interposer starts first and runs that many
    kernels; `per_process_util` False hides each process's utilization
    from the watcher."""
    iters = {q: n * EXEC_US // exec_us for q, n in ITERS.items()}
    world = bench_quota.World(str(tmp_path / "node"))
    if window is not None:
        plant_window(world.lock_dir, *window)
    state = str(tmp_path / "card.state")
    with open(state, "wb") as f:
        f.write(b"\0" * 16)
    watcher = TcWatcherDaemon([0], BusySampler(state, fake, extra,
                                               per_process_util),
                              tc_path=world.tc_path,
                              vmem_path=world.vmem_path, interval_ms=20)
    watcher.start()
    outside = None
    try:
        procs = {}
        if outside_iters:
            env = world.env(shim, "uid-outside", hard_core=100)
            env.pop("LD_PRELOAD")
            env.update({"SHIM_PATH": fake,
                        "VTPU_REAL_CUDA_LIBRARY_PATH": fake,
                        "FAKE_SHARED_STATE": state,
                        "FAKE_EXEC_US": str(exec_us),
                        "FAKE_TIMESLICE_US": str(slice_us),
                        "SHIM_TEST_ITERS": str(outside_iters)})
            outside = subprocess.Popen(
                [str(build.build_shim_test()), "--throttle-only"], env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            time.sleep(0.3)     # its kernels run, and the feed shows them
        for quota, n in iters.items():
            env = world.env(shim, f"uid-q{quota}", hard_core=quota)
            env.update({"SHIM_PATH": env["LD_PRELOAD"],
                        "VTPU_REAL_CUDA_LIBRARY_PATH": fake,
                        "FAKE_SHARED_STATE": state,
                        "FAKE_EXEC_US": str(exec_us),
                        "FAKE_TIMESLICE_US": str(slice_us),
                        "SHIM_TEST_ITERS": str(n)})
            if quota == unmetered:
                env.pop("LD_PRELOAD")
                env["SHIM_PATH"] = fake
            procs[quota] = subprocess.Popen(
                [str(build.build_shim_test()), "--throttle-only"], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out = {}
        for quota, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=120)
            assert proc.returncode == 0, stdout + stderr
            out[quota] = bench_quota.parse_harness(stdout)
        if outside is not None:
            assert outside.wait(timeout=120) == 0
    finally:
        if outside is not None and outside.poll() is None:
            outside.kill()
            outside.wait()
        watcher.stop()
    for quota, o in out.items():
        o["share"] = 100.0 * iters[quota] * exec_us / 1000 / o["wall_ms"]
        if quota != unmetered:
            own_ns = o["vtpu_launches_total"] * exec_us * 1000
            o["charge_rel"] = o["vtpu_charged_ns_total"] / own_ns - 1.0
    return out


@pytest.mark.parametrize("quota", sorted(ITERS))
def test_each_tenant_takes_its_quota_and_is_charged_its_own_time(
        tmp_path, quota):
    out = run_pair(tmp_path, str(build.build_shim()),
                   str(build.build_fake_driver()), SLICE_US)
    o = out[quota]
    assert abs(o["share"] - quota) <= QUOTA_BAND, out
    assert abs(o["charge_rel"]) <= CHARGE_REL, out


# an hour ahead, held by a token with no ledger entry, or by the q50
# tenant itself: the window is void to q25 either way (too long)
@pytest.mark.parametrize("owner", ["stranger", "co-tenant"])
def test_a_planted_window_holds_no_tenant_back(tmp_path, owner):
    token = 0x5EED if owner == "stranger" else fnv64("uid-q50/main")
    out = run_pair(tmp_path, str(build.build_shim()),
                   str(build.build_fake_driver()), SLICE_US,
                   window=(time.monotonic_ns() + 3600 * 10**9, token))
    for quota, o in out.items():
        assert abs(o["share"] - quota) <= QUOTA_BAND, out
        assert abs(o["charge_rel"]) <= CHARGE_REL, out
        # the co-tenant's own windows hold it a few percent of its run; a
        # honoured planted window would hold every launch
        assert o["vtpu_stand_aside_ns_total"] < 0.05 * o["wall_ms"] * 1e6, out


def test_short_kernels_beside_a_co_tenant_are_charged_their_own_time(
        tmp_path):
    out = run_pair(tmp_path, str(build.build_shim()),
                   str(build.build_fake_driver()), SLICE_US,
                   exec_us=SHORT_US)
    for quota, o in out.items():
        assert o["vtpu_windows_total"] == 0, out
        assert abs(o["share"] - quota) <= QUOTA_BAND, out
        assert abs(o["charge_rel"]) <= CHARGE_REL, out


def test_a_tenant_beside_an_unmetered_process_is_charged_its_own_time(
        tmp_path):
    """F4's pin: q25 runs without the interposer, so q50 can open no
    window; the feed carries q25 as a tokenless resident using the card,
    and q50's long kernels are measured by the slice clock."""
    out = run_pair(tmp_path, str(build.build_shim()),
                   str(build.build_fake_driver()), SLICE_US, unmetered=25)
    o = out[50]
    # (a window may open at the start, before the feed shows q25 using the
    # card; the clock's first sample then replaces what it learned)
    assert o["vtpu_clocked_total"] > 0, out
    assert abs(o["charge_rel"]) <= CHARGE_REL, out
    assert abs(o["share"] - 50) <= QUOTA_BAND, out


def test_a_tenant_beside_a_process_of_unknown_use_is_charged_its_own_time(
        tmp_path):
    """F4's pin where the watcher cannot read the card per process (NVML
    on the H100 machine lists the contexts, not their use): q25, unmetered,
    is in the feed as a tokenless resident of unknown use, and q50's clock
    finds its slices."""
    out = run_pair(tmp_path, str(build.build_shim()),
                   str(build.build_fake_driver()), SLICE_US, unmetered=25,
                   per_process_util=False)
    o = out[50]
    assert o["vtpu_clocked_total"] > 0, out
    assert abs(o["charge_rel"]) <= CHARGE_REL, out
    assert abs(o["share"] - 50) <= QUOTA_BAND, out


def test_no_window_beside_an_outside_resident(tmp_path):
    """Both tenants metered, and a process outside the ledger already
    running kernels on the card when they start: beside it neither tenant
    opens a window or stands aside for one, and each is charged its own
    kernel time by its slice clock. (No share band: while the unthrottled
    process runs, the card's round robin gives each of the three a third,
    less than q50's quota.)"""
    out = run_pair(tmp_path, str(build.build_shim()),
                   str(build.build_fake_driver()), SLICE_US,
                   outside_iters=150)
    for o in out.values():
        assert o["vtpu_windows_total"] == 0, out
        assert o["vtpu_stand_aside_ns_total"] == 0, out
        assert o["vtpu_clocked_total"] > 0, out
        assert abs(o["charge_rel"]) <= CHARGE_REL, out
    assert out[50]["share"] > out[25]["share"], out


def test_an_idle_context_outside_the_ledger_leaves_the_windows(tmp_path):
    """A process that holds a context on the card and runs nothing (the
    sampler reads it at 0 %) takes no slices: the tenants keep R9's
    windows and its bands."""
    out = run_pair(tmp_path, str(build.build_shim()),
                   str(build.build_fake_driver()), SLICE_US,
                   extra=[ProcReading(pid=2**22 + 7, util=0, mem=1 << 30)])
    for quota, o in out.items():
        assert o["vtpu_windows_total"] > 0, out
        assert abs(o["share"] - quota) <= QUOTA_BAND, out
        assert abs(o["charge_rel"]) <= CHARGE_REL, out


def test_the_fake_reports_the_layout_it_uses():
    """The watcher's stand-in reads the shared card through the layout the
    fake reports, which must describe a file of the card's size."""
    lay = slice_layout(str(build.build_fake_driver()))
    assert lay["chip_busy"] == 0
    assert lay["procs"] + lay["nprocs"] * lay["proc_size"] == lay["chip_size"]
    assert lay["proc_pid"] + 4 <= lay["proc_busy"]
    assert lay["proc_busy"] + 8 <= lay["proc_size"]
