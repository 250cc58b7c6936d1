"""Every launch path is metered and every allocation entry is capped.

The interposer against the fake driver, as tests/test_torch_shim.py runs
it: CUDA-graph replays (cuGraphLaunch) and cooperative launches are paced
like cuLaunchKernel, a launch into a capturing stream is neither charged
nor sampled and leaves the capture valid, and each allocating entry of the
driver API beyond cuMemAlloc_v2 is held to the memory cap, its free
returning the credit.
"""

import pytest

from vtpu_manager_torch import bench_quota

SHARE_BAND = 15.0
OOM = 2                     # CUDA_ERROR_OUT_OF_MEMORY
MIB = 2**20
CAP = 64 * MIB
ENTRIES = ("pitch", "managed", "pool", "pool_ptsz", "array", "array3d",
           "mipmap")
NEW_LOOKUPS = (
    "proc:cuGraphLaunch", "proc:cuGraphLaunch/ptsz",
    "proc:cuLaunchCooperativeKernel", "proc:cuLaunchCooperativeKernel/ptsz",
    "proc:cuLaunchCooperativeKernelMultiDevice", "proc:cuMemAllocPitch",
    "proc:cuMemAllocManaged", "proc:cuMemAllocFromPoolAsync",
    "proc:cuMemAllocFromPoolAsync/ptsz", "proc:cuArrayCreate",
    "proc:cuArray3DCreate", "proc:cuMipmappedArrayCreate",
    "proc:cuArrayDestroy", "proc:cuMipmappedArrayDestroy",
    "dlsym:cuMemAllocManaged", "dlsym:cuGraphLaunch")


def _fields(stdout: str, tag: str) -> dict:
    line = next(ln for ln in stdout.splitlines() if ln.startswith(tag + " "))
    return {k: int(v) for k, v in (f.split("=") for f in line.split()[1:])}


def test_lookups_of_every_new_name_return_the_hook():
    res = bench_quota.run_fake_harness("--routes")
    out = res["stdout"]
    for label in NEW_LOOKUPS:
        assert f"ROUTE {label} ok" in out, out
    assert res["rc"] == 0 and "ROUTES OK" in out


@pytest.mark.parametrize("launch", ["graph", "coop"])
def test_fake_sweep_through_each_path_tracks_quota(launch):
    # the same band as tests/test_torch_shim.py::test_fake_sweep_tracks_quota
    times = bench_quota.run_fake_sweep(launch=launch)
    assert times is not None
    shares = {q: 100.0 * times[100] / t for q, t in times.items()}
    for quota in (50, 25):
        assert abs(shares[quota] - quota) <= SHARE_BAND, shares
    assert bench_quota.tracking_mae(shares) <= SHARE_BAND


@pytest.mark.parametrize("quota", [50, 0])
def test_capture_is_charged_nothing_and_replays_are(quota):
    n = 9
    res = bench_quota.run_fake_harness(
        "--capture", VTPU_CORE_LIMIT=quota, MANAGER_VISIBLE_DEVICES="0,1",
        FAKE_EXEC_US=500, SHIM_TEST_CAPTURE=n)
    assert res["rc"] == 0, res["stderr"]
    c = _fields(res["stdout"], "CAPTURE")
    # the capture stays valid: nothing the interposer did touched it
    assert c["begin_rc"] == 0 and c["end_rc"] == 0 and c["failed"] == 0, c
    assert c["charged_during"] == 0 and c["sampled_during"] == 0, c
    # every launch is counted; a metered tenant's captured ones apart
    assert c["launches_during"] == n, c
    assert c["captured_counter"] == (n if quota else 0), c
    # the legacy stream under a global capture: the driver's refusal
    # (CUDA_ERROR_STREAM_CAPTURE_IMPLICIT), nothing charged for it
    assert c["implicit_rc"] == 906 and c["charged_implicit"] == 0, c
    assert c["inst_rc"] == 0
    assert c["graph_launches"] == c["fake_graph_launches"] == c["replays"], c
    # a metered tenant pays for each replay; an unmetered one pays nothing
    assert (c["charged_replays"] > 0) == (quota > 0), c
    assert c["multi_rc"] == 0 and c["multi_launches"] == 2, c


@pytest.mark.parametrize("entry", ENTRIES)
def test_each_allocation_entry_is_capped(entry):
    res = bench_quota.run_fake_harness(
        "--entry-caps", VTPU_MEM_LIMIT_0=CAP, SHIM_TEST_ENTRY=entry,
        SHIM_TEST_BIG=256 * MIB, SHIM_TEST_SMALL=32 * MIB)
    assert res["rc"] == 0, res["stderr"]
    v = res["verdicts"]
    out = res["stdout"]
    assert v["over"] == OOM, out              # 256 MiB under a 64 MiB cap
    assert v["granted"] == 0, out             # 32 MiB
    asked = int(next(ln.split()[1] for ln in out.splitlines()
                     if ln.startswith("ASKED ")))
    held = next(ln for ln in out.splitlines() if ln.startswith("MEMINFO held"))
    freed = next(ln for ln in out.splitlines()
                 if ln.startswith("MEMINFO freed"))
    assert held == f"MEMINFO held free={CAP - asked} total={CAP}", out
    assert freed == f"MEMINFO freed free={CAP} total={CAP}", out
    assert v["free"] == 0 and v["again"] == 0 and v["free_again"] == 0, out
    assert "FAKE_USED 0" in out
