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
"""

from __future__ import annotations

import os
import struct
import subprocess
import time

import pytest

from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.config.vmem import fnv64
from vtpu_manager_torch.manager.watcher import TcWatcherDaemon

EXEC_US = 12_000
SLICE_US = 2_000
# q50 outlives q25 (150 x 24 ms against 50 x 48 ms at their quotas), so
# every q25 kernel runs beside a co-tenant
ITERS = {50: 150, 25: 50}
SHORT_US = 500   # the same seconds of work in kernels without a window
QUOTA_BAND = 5.0
CHARGE_REL = 0.05


class BusySampler:
    """The card's utilization from the fake's shared busy counter."""

    def __init__(self, state_path: str):
        self.path = state_path
        self.last = (0, time.monotonic_ns())

    def sample(self, host_index: int) -> int:
        with open(self.path, "rb") as f:
            busy, = struct.unpack("<Q", f.read(8))
        now = time.monotonic_ns()
        prev_busy, prev_t = self.last
        self.last = (busy, now)
        return min(100, int(100 * (busy - prev_busy) / max(now - prev_t, 1)))


def plant_window(lock_dir: str, until_ns: int, owner: int) -> None:
    """Writes device 0's sampling window (until, owner) as a process that
    is no tenant of the card could."""
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "vtpu_0.window"), "wb") as f:
        f.write(struct.pack("<QQ", until_ns, owner))


def run_pair(tmp_path, shim: str, fake: str, slice_us: int,
             window: tuple[int, int] | None = None,
             exec_us: int = EXEC_US, unmetered: int | None = None) -> dict:
    """The q50 + q25 pair, the same seconds of work in kernels of
    `exec_us`; `window` (until_ns, owner) is planted first. The tenant of
    quota `unmetered` runs without the interposer (no ledger entry, no
    throttle, no counters)."""
    iters = {q: n * EXEC_US // exec_us for q, n in ITERS.items()}
    world = bench_quota.World(str(tmp_path / "node"))
    if window is not None:
        plant_window(world.lock_dir, *window)
    state = str(tmp_path / "card.state")
    with open(state, "wb") as f:
        f.write(b"\0" * 16)
    watcher = TcWatcherDaemon([0], BusySampler(state), tc_path=world.tc_path,
                              vmem_path=world.vmem_path, interval_ms=20)
    watcher.start()
    try:
        procs = {}
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
    finally:
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


if __name__ == "__main__":
    # S2 (ROADMAP Queue 3): the pair with q25 run without the interposer,
    # beside the pair as the tests run it; prints q50's share and charge
    import pathlib
    import tempfile
    for label, unmetered in (("both metered", None), ("q25 unmetered", 25)):
        with tempfile.TemporaryDirectory() as d:
            o = run_pair(pathlib.Path(d), str(build.build_shim()),
                         str(build.build_fake_driver()), SLICE_US,
                         unmetered=unmetered)[50]
        print(f"S2 {label}: q50 share {o['share']:.2f} charge_rel "
              f"{o['charge_rel']:+.4f} windows {o['vtpu_windows_total']}")
