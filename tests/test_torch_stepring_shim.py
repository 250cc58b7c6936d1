"""The interposer's own step ring (`csrc/shim/enforce_rate.cc`, "Steps"),
against the fake driver and the JAX package.

The ring's layout (`csrc/shim/vtpu_telemetry_abi.h`) is compiled beside
`library/include/vtpu_telemetry.h` and must give every size and offset
alike. A tenant with no Python (the harness's `--steps`) writes one record
per synchronisation boundary, through each synchronising entry and each
lookup route, one per graph replay, and one a second when it never
synchronises; the port's reader and the JAX one decode the same records.
A Python writer that arms after the interposer takes the ring over and
continues its index; one that arms first leaves the interposer nothing to
write.
"""

import os
import subprocess
import sys

import pytest

from vtpu_manager.telemetry import stepring as jstepring
from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.telemetry import TenantStepTelemetry, stepring
from vtpu_manager_torch.util import consts

REPO = build.REPO
EXEC_US = 500
MIB = 2**20


def _layout_probe(tmp_path, header, namespace):
    structs = {
        "StepRingHeader": ["magic", "version", "capacity", "record_size",
                           "writer_pid", "writes", "trace_id"],
        "StepRecord": ["seq", "index", "start_mono_ns", "duration_ns",
                       "throttle_wait_ns", "hbm_highwater_bytes", "flags",
                       "spilled_bytes", "spill_events", "fill_events",
                       "comm_time_ns", "bytes_transferred",
                       "collective_count", "spill_fill_time_ns"]}
    lines = [f'#include "{header}"', "#include <cstdio>",
             "#include <cstddef>", f"using namespace {namespace};",
             "int main() {"]
    for struct, fields in structs.items():
        lines.append(f'  printf("{struct} %zu\\n", sizeof({struct}));')
        lines += [f'  printf("{struct}.{f} %zu\\n", offsetof({struct}, {f}));'
                  for f in fields]
    lines += ['  printf("magic %u version %u capacity %d size %zu flag %u\\n",'
              ' kStepRingMagic, kStepRingVersion, kStepRingCapacity,'
              ' kStepRingFileSize, kStepFlagCompile);', "  return 0;", "}"]
    src = tmp_path / f"ring_{namespace}.cc"
    src.write_text("\n".join(lines))
    exe = tmp_path / f"ring_{namespace}"
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    return subprocess.run([str(exe)], check=True, capture_output=True,
                          text=True).stdout


def test_ring_layout_matches_the_jax_header(tmp_path):
    mine = _layout_probe(
        tmp_path, REPO / "vtpu_manager_torch/csrc/shim/vtpu_telemetry_abi.h",
        "vtpu_abi")
    theirs = _layout_probe(tmp_path, REPO / "library/include/vtpu_telemetry.h",
                           "vtpu")
    assert mine == theirs
    got = dict(line.rsplit(" ", 1) for line in mine.splitlines()
               if not line.startswith("magic"))
    assert int(got["StepRingHeader"]) == stepring.HEADER_SIZE
    assert int(got["StepRecord"]) == stepring.RECORD_SIZE
    assert f"size {stepring.FILE_SIZE} " in mine
    assert f"magic {stepring.MAGIC} version {stepring.VERSION} " in mine


def _steps(tmp_path, timeout=60, ring=True, **extra):
    """One `--steps` run; its parsed output, the ring's path and records
    as the port's reader and the JAX reader decode them."""
    path = tmp_path / "telemetry" / consts.STEP_RING_NAME
    path.parent.mkdir(parents=True, exist_ok=True)
    env = {"FAKE_EXEC_US": EXEC_US, **extra}
    if ring:
        env.update({consts.ENV_STEP_TELEMETRY: "true",
                    consts.ENV_STEP_RING_PATH: str(path),
                    consts.ENV_TRACE_ID: "trace-steps"})
    res = bench_quota.run_fake_harness("--steps", timeout=timeout, **env)
    assert res["rc"] == 0, res["stderr"][-2000:]
    out = {"path": path, "res": res, "steps": [], "records": None}
    for line in res["stdout"].splitlines():
        parts = line.split()
        if parts[:1] == ["STEP"]:
            out["steps"].append((int(parts[2]), int(parts[3])))
        elif parts[:1] == ["STEPS"]:
            out["records"] = int(parts[1].split("=")[1])
        elif parts[:1] == ["CAPTURED"]:
            out["captured_rc"] = int(parts[1].split("=")[1])
    if ring and path.exists():
        reader = stepring.StepRingReader(str(path))
        out["recs"], out["head"], out["drops"] = reader.poll(0)
        reader.close()
        jreader = jstepring.StepRingReader(str(path))
        out["jax"] = jreader.poll(0)
        jreader.close()
    return out


def _fields(r):
    return (r.index, r.start_mono_ns, r.duration_ns, r.throttle_wait_ns,
            r.hbm_highwater_bytes, r.flags, r.spilled_bytes, r.comm_time_ns)


SYNCS = ["stream", "stream_ptsz", "ctx", "event"]
ROUTES = ["proc", "dlsym", "export"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sync", SYNCS)
def test_one_record_per_synchronisation(sync, route, tmp_path):
    iters = 6
    out = _steps(tmp_path, SHIM_TEST_ITERS=iters, SHIM_TEST_SYNC=sync,
                 SHIM_TEST_ROUTE=route)
    # the captured launch and the failed synchronisation of the capturing
    # stream wrote nothing; each step's second synchronisation neither
    assert out["captured_rc"] != 0
    assert out["records"] == iters == len(out["recs"]) == out["head"]
    assert out["drops"] == 0
    recs = out["recs"]
    assert [r.index for r in recs] == list(range(iters))
    for r, (t0, t1) in zip(recs, out["steps"]):
        # from the step's first launch to its synchronisation's return
        assert t0 <= r.start_mono_ns <= r.start_mono_ns + r.duration_ns <= t1
        assert r.duration_ns >= 3 * EXEC_US * 1000
        assert (r.spilled_bytes, r.comm_time_ns, r.collective_count) == (0,) * 3
    # the JAX reader decodes the same records
    jrecs, jhead, jdrops = out["jax"]
    assert (jhead, jdrops) == (out["head"], 0)
    assert [_fields(r) for r in jrecs] == [_fields(r) for r in recs]


SYNC_ROUTES = ["proc:cuStreamSynchronize", "proc:cuStreamSynchronize/ptsz",
               "proc:cuCtxSynchronize", "proc:cuEventSynchronize",
               "proc-v1:cuStreamSynchronize", "dlsym:cuCtxSynchronize",
               "dlsym:cuEventSynchronize"]


def test_every_lookup_route_lands_on_the_synchronisation_hooks():
    res = bench_quota.run_fake_harness("--routes")
    out = res["stdout"]
    for label in SYNC_ROUTES:
        assert f"ROUTE {label} ok" in out, out
    assert res["rc"] == 0 and "ROUTES OK" in out


def test_header_names_the_writer_and_the_trace(tmp_path):
    out = _steps(tmp_path, SHIM_TEST_ITERS=3)
    data = out["path"].read_bytes()
    import struct
    magic, version, cap, size, pid, _, writes, trace = struct.unpack_from(
        "<IIiiiiQ48s", data)
    assert (magic, version, cap, size) == (stepring.MAGIC, stepring.VERSION,
                                           stepring.RING_CAPACITY,
                                           stepring.RECORD_SIZE)
    assert writes == 3 and pid > 0
    assert trace.rstrip(b"\0") == b"trace-steps"
    assert len(data) == stepring.FILE_SIZE


@pytest.mark.parametrize("replays", [1, 3])
def test_one_record_per_graph_replay(replays, tmp_path):
    iters = 4
    out = _steps(tmp_path, SHIM_TEST_ITERS=iters, SHIM_TEST_LAUNCH="graph",
                 SHIM_TEST_REPLAYS=replays)
    assert out["records"] == iters * replays == len(out["recs"])
    # each replay's record starts at its launch
    starts = [r.start_mono_ns for r in out["recs"]]
    assert starts == sorted(starts) and len(set(starts)) == len(starts)


def test_a_tenant_that_never_synchronises_writes_a_record_a_second(tmp_path):
    # launches 0.3 s apart, never a synchronisation: the step opened by the
    # first launch closes at the first launch 1 s or more after it
    out = _steps(tmp_path, timeout=60, SHIM_TEST_ITERS=9,
                 SHIM_TEST_SYNC="none", SHIM_TEST_GAP_US=300_000,
                 SHIM_TEST_KERNELS=1)
    recs = out["recs"]
    assert len(recs) == 2
    for r in recs:
        assert 1.0e9 <= r.duration_ns <= 1.5e9
    assert recs[1].start_mono_ns == recs[0].start_mono_ns + recs[0].duration_ns


def test_compiled_marks_the_steps_that_launch_new_kernels(tmp_path):
    out = _steps(tmp_path, SHIM_TEST_ITERS=8, SHIM_TEST_NEW_AT=5)
    assert [r.compiled for r in out["recs"]] == [
        True, False, False, False, False, True, False, False]


def test_throttle_wait_adds_up_to_the_counter(tmp_path):
    out = _steps(tmp_path, SHIM_TEST_ITERS=12, VTPU_CORE_LIMIT_0=50,
                 FAKE_EXEC_US=2000)
    waits = [r.throttle_wait_ns for r in out["recs"]]
    total = out["res"]["vtpu_throttle_wait_ns_total"]
    assert total > 0 and sum(waits) == total
    # the throttled steps take about twice their kernels' time
    durs = sorted(r.duration_ns for r in out["recs"])
    assert durs[len(durs) // 2] >= 1.6 * 3 * 2000 * 1000


def test_hbm_highwater_is_the_caps_peak(tmp_path):
    out = _steps(tmp_path, SHIM_TEST_ITERS=5, SHIM_TEST_STEP_ALLOC=MIB,
                 VTPU_MEM_LIMIT_0=64 * MIB)
    assert [r.hbm_highwater_bytes for r in out["recs"]] == [
        MIB, 2 * MIB, 3 * MIB, 3 * MIB, 3 * MIB]


def test_unarmed_writes_no_ring(tmp_path):
    out = _steps(tmp_path, ring=False, SHIM_TEST_ITERS=3)
    assert out["records"] == 0
    assert not out["path"].exists()


def test_a_held_ring_makes_the_interposer_yield(tmp_path):
    path = tmp_path / "telemetry" / consts.STEP_RING_NAME
    path.parent.mkdir()
    holder = stepring.StepRingWriter(str(path))
    holder.record(1000)
    try:
        out = _steps(tmp_path, SHIM_TEST_ITERS=4)
    finally:
        holder.close()
    assert out["records"] == 0 and out["head"] == 1


def test_the_exporters_fold_reads_the_interposers_ring(tmp_path):
    base = tmp_path / "base"
    cdir = base / "uid-steps_main"
    out = _steps(cdir, SHIM_TEST_ITERS=7)
    assert out["path"] == cdir / "telemetry" / consts.STEP_RING_NAME
    tel = TenantStepTelemetry(str(base))
    tel.scan()
    text = tel.render("n1")
    assert ('vtpu_tenant_step_duration_seconds_count{node="n1",'
            'pod_uid="uid-steps",container="main"} 7') in text


# A Python tenant under the interposer over the fake driver: it launches
# through the interposer's exports and synchronises `before` times, arms
# the Python writer, then steps `after` times recording each step itself.
_PY_TENANT = r"""
import ctypes, sys
from vtpu_manager_torch.runtime import client
lib = ctypes.CDLL(None)
launch, sync = lib.cuLaunchKernel, lib.cuStreamSynchronize
launch.argtypes = [ctypes.c_void_p] + [ctypes.c_uint] * 7 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
sync.argtypes = [ctypes.c_void_p]
order, before, after = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

def step():
    assert launch(0x5000, 1, 1, 1, 1, 1, 1, 0, 0x10, None, None) == 0
    assert sync(0x10) == 0

tel = client.step_telemetry() if order == "python-first" else None
for _ in range(before):
    step()
if tel is None:
    tel = client.step_telemetry()
for _ in range(after):
    step()
    tel.record(1234)
print("RECORDS", lib.vtpu_step_records_total())
"""


@pytest.mark.parametrize("order", ["interposer-first", "python-first"])
def test_one_stream_whichever_writer_arms_first(order, tmp_path):
    path = tmp_path / "telemetry" / consts.STEP_RING_NAME
    path.parent.mkdir()
    env = bench_quota.fake_harness_env(
        FAKE_EXEC_US=EXEC_US, PYTHONPATH=str(REPO),
        **{consts.ENV_STEP_TELEMETRY: "true",
           consts.ENV_STEP_RING_PATH: str(path)})
    res = subprocess.run([sys.executable, "-c", _PY_TENANT, order, "5", "4"],
                         env=env, capture_output=True, text=True, timeout=120,
                         cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    shim_records = int(res.stdout.split("RECORDS")[1])
    reader = stepring.StepRingReader(str(path))
    recs, head, drops = reader.poll(0)
    reader.close()
    assert drops == 0 and head == len(recs)
    assert [r.index for r in recs] == list(range(len(recs)))
    python = [r for r in recs if r.duration_ns == 1234]
    assert len(python) == 4 and recs[-4:] == python
    if order == "interposer-first":
        # the interposer's five steps, then the Python writer's four
        assert shim_records == 5 and len(recs) == 9
        assert recs[0].compiled and not any(r.compiled for r in recs[1:5])
    else:
        assert shim_records == 0 and len(recs) == 4


def test_the_interposers_ring_survives_a_restart(tmp_path):
    first = _steps(tmp_path, SHIM_TEST_ITERS=3)
    second = _steps(tmp_path, SHIM_TEST_ITERS=4)
    assert first["head"] == 3 and second["head"] == 7
    assert [r.index for r in second["recs"]] == list(range(7))


def test_a_python_tenant_without_the_interposer_still_writes(tmp_path,
                                                            monkeypatch):
    from vtpu_manager_torch.runtime import client
    path = tmp_path / consts.STEP_RING_NAME
    monkeypatch.setenv(consts.ENV_STEP_TELEMETRY, "true")
    monkeypatch.setenv(consts.ENV_STEP_RING_PATH, str(path))
    client._reset_step_telemetry()
    try:
        tel = client.step_telemetry()
        tel.record(10)
    finally:
        client._reset_step_telemetry()
    reader = stepring.StepRingReader(str(path))
    assert reader.poll(0)[1] == 1
    reader.close()


def test_env_names_match_the_reference():
    # the interposer arms from the names Allocate sets
    src = (REPO / "vtpu_manager_torch/csrc/shim/enforce_rate.cc").read_text()
    for name in (consts.ENV_STEP_TELEMETRY, consts.ENV_STEP_RING_PATH,
                 consts.ENV_TRACE_ID):
        assert f'getenv("{name}")' in src
    assert os.path.basename(consts.STEP_RING_NAME) == "step_telemetry.ring"
