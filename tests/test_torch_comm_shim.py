"""The interposer's communication accounting on the fake driver.

The harness's `--comm` mode issues copies of every entry the interposer
hooks and launches of NCCL-named kernels, each in a step of its own, with
the step ring armed; the interposer counts what it moved
(`vtpu_comm_time_ns_total`, `vtpu_comm_bytes_total`,
`vtpu_collectives_total`) and writes each step's share into the ring's
comm block. Held here: the gate off (zeros everywhere), bytes by
direction with card-to-card and host-to-host copies not counted, only
NCCL's kernels counted as collectives, each with its span, a throttled
tenant accounted like an unthrottled one, a copy and an NCCL launch into a
capturing stream leaving the capture valid, and the quota sweep unchanged
with the gate on.
"""

import pytest

from vtpu_manager_torch import bench_quota
from vtpu_manager_torch.telemetry.stepring import StepRingReader

SHARE_BAND = 15.0      # tests/test_torch_shim.py's band
EXEC_US = 500          # a kernel's time on the fake card
# op: bytes the interposer counts for one `op:4096`
BY_DIRECTION = {
    "htod": 4096, "dtoh": 4096, "htod_async": 4096, "dtoh_async": 4096,
    "unified_htod": 4096, "unified_dtoh": 4096, "unified_async_htod": 4096,
    "unified_async_dtoh": 4096,
    "dtod_async": 0, "unified_dtod": 0, "unified_hh": 0,
}


def comm_run(tmp_path, spec, armed=True, **extra):
    ring = tmp_path / "ring"
    res = bench_quota.run_fake_harness(
        "--comm", SHIM_TEST_COMM=spec, FAKE_EXEC_US=EXEC_US,
        VTPU_STEP_TELEMETRY="true", VTPU_STEP_RING_PATH=str(ring),
        VTPU_LOGGER_LEVEL=2, **({"VTPU_COMM_TELEMETRY": "true"}
                                if armed else {}), **extra)
    assert res["rc"] == 0, res["stderr"][-2000:]
    line = next(l for l in res["stdout"].splitlines()
                if l.startswith("COMM "))
    out = {k: int(v) for k, v in (p.split("=") for p in line.split()[1:])}
    reader = StepRingReader(str(ring))
    try:
        records, _, _ = reader.poll(0)
    finally:
        reader.close()
    out["records"] = records
    out["stderr"] = res["stderr"]
    return out


def block_sums(records):
    return (sum(r.comm_time_ns for r in records),
            sum(r.bytes_transferred for r in records),
            sum(r.collective_count for r in records))


def test_gate_off_zeros(tmp_path):
    out = comm_run(tmp_path, ",".join(f"{op}:4096" for op in BY_DIRECTION)
                   + ",nccl:2,nccl_kernel:1", armed=False,
                   SHIM_TEST_CAPTURE="1")
    assert (out["comm_time_ns"], out["comm_bytes"], out["collectives"]) == \
        (0, 0, 0)
    assert out["copies"] == len(BY_DIRECTION)
    assert len(out["records"]) == len(BY_DIRECTION) + 3
    assert block_sums(out["records"]) == (0, 0, 0)
    assert "copy entry" not in out["stderr"]


@pytest.mark.parametrize("ptds", ["0", "1"])
@pytest.mark.parametrize("op", sorted(BY_DIRECTION))
def test_bytes_by_direction(tmp_path, op, ptds):
    """Each entry alone, in both stream forms: host-card bytes counted with
    a span, card-to-card and host-to-host not at all; the ring's comm
    block sums to the totals."""
    out = comm_run(tmp_path, f"{op}:4096", SHIM_TEST_PTDS=ptds)
    want = BY_DIRECTION[op]
    assert out["comm_bytes"] == want
    assert (out["comm_time_ns"] > 0) == (want > 0)
    assert out["collectives"] == 0
    assert out["copies"] == 1
    assert block_sums(out["records"]) == (
        out["comm_time_ns"], out["comm_bytes"], out["collectives"])


def test_mixed_copies_sum_and_entries_logged(tmp_path):
    spec = ",".join(f"{op}:{1000 + 10 * i}"
                    for i, op in enumerate(sorted(BY_DIRECTION)))
    out = comm_run(tmp_path, spec)
    want = sum(1000 + 10 * i for i, op in enumerate(sorted(BY_DIRECTION))
               if BY_DIRECTION[op])
    assert out["comm_bytes"] == want
    assert block_sums(out["records"])[1] == want
    for entry in ("cuMemcpyHtoD_v2", "cuMemcpyDtoH_v2",
                  "cuMemcpyHtoDAsync_v2", "cuMemcpyDtoHAsync_v2",
                  "cuMemcpy", "cuMemcpyAsync"):
        assert f"copy entry {entry} in use" in out["stderr"]


@pytest.mark.parametrize("spec,collectives", [
    ("nccl:3", 3), ("nccl_kernel:2", 2), ("kernel:3", 0),
    ("nccl:1,kernel:2,nccl_kernel:1", 2)])
def test_only_nccl_kernels_are_collectives(tmp_path, spec, collectives):
    """A launch of an NCCL-named CUfunction (cuFuncGetName) or CUkernel
    (cuKernelGetName) counts one collective and its span, no bytes; any
    other kernel nothing."""
    out = comm_run(tmp_path, spec)
    assert out["collectives"] == collectives
    assert out["comm_bytes"] == 0
    # each collective's span is its kernel's time on the fake card
    assert out["comm_time_ns"] >= collectives * EXEC_US * 1000 * 0.9
    if not collectives:
        assert out["comm_time_ns"] == 0
    assert block_sums(out["records"]) == (
        out["comm_time_ns"], 0, collectives)


@pytest.mark.parametrize("quota", [100, 50])
def test_throttled_or_not_accounted(tmp_path, quota):
    out = comm_run(tmp_path, "htod:2048,nccl:2,dtoh_async:1024",
                   VTPU_CORE_LIMIT_0=quota if quota < 100 else 0)
    assert (out["comm_bytes"], out["collectives"]) == (3072, 2)
    assert block_sums(out["records"]) == (
        out["comm_time_ns"], out["comm_bytes"], out["collectives"])


@pytest.mark.parametrize("quota", [100, 50])
def test_capture_stays_valid(tmp_path, quota):
    """An async copy and an NCCL launch into a stream captured in the
    global mode: the capture ends without 901; the copy's bytes and the
    collective are counted, with no span."""
    out = comm_run(tmp_path, "kernel:1", SHIM_TEST_CAPTURE="1",
                   VTPU_CORE_LIMIT_0=quota if quota < 100 else 0)
    assert out["capture_rc"] == 0
    assert (out["comm_bytes"], out["collectives"]) == (4096, 1)
    assert out["comm_time_ns"] == 0


def test_quota_sweep_unchanged_with_the_gate_on():
    """tests/test_torch_shim.py's band and MAE, every run armed."""
    sweep = bench_quota.paired_fake_sweep(VTPU_COMM_TELEMETRY="true")
    assert sweep is not None
    _, shares = sweep
    for quota in (50, 25):
        assert abs(shares[quota] - quota) <= SHARE_BAND, shares
    assert bench_quota.tracking_mae(shares) <= SHARE_BAND
