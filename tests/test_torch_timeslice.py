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
             per_process_util: bool = True,
             fake_env: dict | None = None,
             exec_by_quota: dict | None = None) -> dict:
    """The q50 + q25 pair, the same seconds of work in kernels of
    `exec_us`; `window` (until_ns, owner) is planted first. The tenant of
    quota `unmetered` runs without the interposer (no ledger entry, no
    throttle, no counters); `extra` readings join the sampler's processes
    (processes on the card that run nothing); with `outside_iters` a third
    process without the interposer starts first and runs that many
    kernels; `per_process_util` False hides each process's utilization
    from the watcher; `fake_env` is added to every process's environment
    (the fake driver's knobs); `exec_by_quota` gives a tenant kernels of
    its own length."""
    execs = {q: (exec_by_quota or {}).get(q, exec_us) for q in ITERS}
    iters = {q: n * EXEC_US // execs[q] for q, n in ITERS.items()}
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
                        "FAKE_EXEC_US": str(execs[quota]),
                        "FAKE_TIMESLICE_US": str(slice_us),
                        "SHIM_TEST_ITERS": str(n), **(fake_env or {})})
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
        o["share"] = (100.0 * iters[quota] * execs[quota] / 1000
                      / o["wall_ms"])
        if quota != unmetered:
            own_ns = o["vtpu_launches_total"] * execs[quota] * 1000
            o["charge_rel"] = o["vtpu_charged_ns_total"] / own_ns - 1.0
            # against its own busy time on the card, the switches' cost
            # (FAKE_SWITCH_US) included
            if o.get("own_busy_ns", 0) > 0:
                o["own_rel"] = (o["vtpu_charged_ns_total"] / o["own_busy_ns"]
                                - 1.0)
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
    """Both tenants metered, and a process outside the ledger running
    kernels on the card from before they start until after they end (300
    kernels: once it has left, a tenant may open windows again): beside it
    neither tenant
    opens a window or stands aside for one, and each is charged its own
    kernel time by its slice clock. (No share band: while the unthrottled
    process runs, the card's round robin gives each of the three a third,
    less than q50's quota.)"""
    out = run_pair(tmp_path, str(build.build_shim()),
                   str(build.build_fake_driver()), SLICE_US,
                   outside_iters=300)
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


PIN_PAIRS = 3


def test_a_void_window_beside_an_idle_context_of_unknown_use_keeps_windows(
        tmp_path):
    """F5's pin. The card machine's NVML reads no process's use, so every
    phase's own idle context is on the card as a resident of unknown use
    beside the ledger tenants. q25's kernels (40 ms) outlast q50's drain
    budget (24 ms), so now and then a q50 window finds no idle card: a
    busy card, given up as any other. The parent's interposer took one
    such window for proof of the unknown context's slices, put q50 on the
    slice clock, and kept it there while the clock's gaps (q25's slices)
    renewed the mark; the clock's samples beside a busy co-tenant hold the
    switches' cost (here 300 us a switch, as the card runs a kernel slower
    beside another busy context), so q50 was charged 5-10 % over its
    kernels' time alone in 21 of 24 pairs on the fake driver. Now the
    clock takes over only after kVoidsForSlices windows in a row void,
    its gaps mark the card sliced only where no ledger co-tenant explains
    them, and a window's sample replaces what the clock learned.

    PIN_PAIRS pairs in turn (a pair without a void window passes either
    interposer), each held: q50's charge within 5 % of its kernels' time
    alone (what its windows measure); q25's, whose few 40 ms kernels are
    sampled beside q50 as well as in windows, no less than 5 % under its
    kernels' time alone and no more than 5 % over its own busy time with
    the switches' cost (the fake's account of the process); and the
    shares, which the switches' cost takes from both tenants, in their
    order."""
    shim, fake = str(build.build_shim()), str(build.build_fake_driver())
    for i in range(PIN_PAIRS):
        out = run_pair(tmp_path / f"pair{i}", shim, fake, SLICE_US,
                       extra=[ProcReading(pid=2**22 + 9, util=UTIL_UNKNOWN,
                                          mem=1 << 30)],
                       per_process_util=False,
                       fake_env={"FAKE_SWITCH_US": "300"},
                       exec_by_quota={25: 40_000})
        assert abs(out[50]["charge_rel"]) <= CHARGE_REL, (i, out)
        assert out[25]["charge_rel"] >= -CHARGE_REL, (i, out)
        assert out[25]["own_rel"] <= CHARGE_REL, (i, out)
        assert out[50]["share"] > out[25]["share"], (i, out)


def run_sliced_tenant(tmp_path, shim: str, fake: str) -> dict:
    """C1's input: a 90 % tenant of two 2 ms kernels a step (the harness's
    `--steps`, 100 steps, a stream synchronisation each, its step ring
    armed) beside a 50 % ledger co-tenant of 12 ms kernels that keeps the
    card busy throughout, FAKE_TIMESLICE_US=2000, the node watcher on the
    fake's busy counter. The tenant's parsed counters, with `charge_rel`,
    its charge over its kernels' time less one."""
    world = bench_quota.World(str(tmp_path / "node"))
    state = tmp_path / "card.state"
    state.write_bytes(b"\0" * 16)
    ring = tmp_path / "ring"

    def env_for(uid, exec_us, quota, **extra):
        env = world.env(shim, uid, hard_core=quota)
        env.update({"SHIM_PATH": env["LD_PRELOAD"],
                    "VTPU_REAL_CUDA_LIBRARY_PATH": fake,
                    "FAKE_SHARED_STATE": str(state),
                    "FAKE_EXEC_US": str(exec_us),
                    "FAKE_TIMESLICE_US": str(SLICE_US), **extra})
        return env
    watcher = TcWatcherDaemon([0], BusySampler(str(state), fake),
                              tc_path=world.tc_path,
                              vmem_path=world.vmem_path, interval_ms=20)
    watcher.start()
    busy = None
    try:
        busy = subprocess.Popen(
            [str(build.build_shim_test()), "--throttle-only"],
            env=env_for("uid-busy", EXEC_US, 50, SHIM_TEST_ITERS="150"),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        time.sleep(0.3)
        res = subprocess.run(
            [str(build.build_shim_test()), "--steps"],
            env=env_for("uid-idle", C1_EXEC_US, 90, SHIM_TEST_ITERS="100",
                        SHIM_TEST_KERNELS=str(C1_KERNELS),
                        SHIM_TEST_SYNC="stream",
                        VTPU_STEP_TELEMETRY="true",
                        VTPU_STEP_RING_PATH=str(ring)),
            capture_output=True, text=True, timeout=120, check=False)
        assert res.returncode == 0, res.stderr[-2000:]
        ran_beside = busy.poll() is None
    finally:
        if busy is not None:
            busy.kill()
            busy.wait()
        watcher.stop()
    o = bench_quota.parse_harness(res.stdout)
    o["beside"] = ran_beside
    own_ns = o["vtpu_launches_total"] * C1_EXEC_US * 1000
    o["charge_rel"] = o["vtpu_charged_ns_total"] / own_ns - 1.0
    return o


C1_EXEC_US, C1_KERNELS = 2000, 2
C1_RUNS = 10


def test_a_time_sliced_tenant_beside_long_kernels_is_charged_its_own_time(
        tmp_path):
    """C1's pin (ROADMAP Queue 3). An unthrottled metered tenant's 2 ms
    kernels wait behind a ledger co-tenant's 12 ms kernels in 2 ms slices;
    in each of C1_RUNS runs its charge lies within 5 % of its kernels'
    time. The parent's interposer charged it 0.56-0.88 of that time in
    about one run in ten."""
    shim, fake = str(build.build_shim()), str(build.build_fake_driver())
    runs = [run_sliced_tenant(tmp_path / f"run{i}", shim, fake)
            for i in range(C1_RUNS)]
    keys = ("charge_rel", "beside", "vtpu_launches_total",
            "vtpu_charged_ns_total", "vtpu_windows_total",
            "vtpu_sampled_launches_total", "vtpu_probes_total",
            "vtpu_obs_overhead_ns", "vtpu_clocked_total",
            "vtpu_gap_bypass_total")
    table = [{k: o.get(k) for k in keys} for o in runs]
    assert all(o["beside"] for o in runs), table
    assert all(abs(o["charge_rel"]) <= CHARGE_REL for o in runs), table


def test_the_fake_reports_the_layout_it_uses():
    """The watcher's stand-in reads the shared card through the layout the
    fake reports, which must describe a file of the card's size."""
    lay = slice_layout(str(build.build_fake_driver()))
    assert lay["chip_busy"] == 0
    assert lay["procs"] + lay["nprocs"] * lay["proc_size"] == lay["chip_size"]
    assert lay["proc_pid"] + 4 <= lay["proc_busy"]
    assert lay["proc_busy"] + 8 <= lay["proc_size"]
