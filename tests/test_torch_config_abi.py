"""The node's shared files, written and read by the port and by the JAX
package: the per-container config (vtpu.config v6), the memory ledger
(vmem_node.config v3) and the utilization feed (tc_util.config v2).

Fields are made from a seed with numpy and handed to both writers; the
files must be byte-identical and each side must read the other's. The
interposer's header (csrc/shim/vtpu_abi.h) and the JAX package's
(library/include/vtpu_config.h) are compiled with g++ and must give every
struct the same size and every field the same offset.
"""

import dataclasses
import os
import subprocess

import numpy as np
import pytest

from vtpu_manager.config import tc_watcher as jtc
from vtpu_manager.config import vmem as jvmem
from vtpu_manager.config import vtpu_config as jvc
from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.config import tc_watcher as tc
from vtpu_manager_torch.config import vmem
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.registry import server as registry
from vtpu_manager_torch.util import consts

REPO = build.REPO


def _name(rng, n):
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz0123456789-"),
                              size=int(rng.integers(0, n))))


def _device_fields(rng):
    return dict(
        uuid="GPU-" + _name(rng, 40),
        total_memory=int(rng.integers(0, 2**40)),
        real_memory=int(rng.integers(0, 2**40)),
        hard_core=int(rng.integers(0, 101)),
        soft_core=int(rng.integers(0, 101)),
        core_limit=int(rng.integers(0, 3)),
        memory_limit=bool(rng.integers(0, 2)),
        memory_oversold=bool(rng.integers(0, 2)),
        host_index=int(rng.integers(0, 64)),
        mesh=tuple(int(v) for v in rng.integers(0, 8, size=3)),
        lease_core=int(rng.integers(-50, 50)),
        virtual_hbm_bytes=int(rng.integers(0, 2**40)),
        spill_budget_bytes=int(rng.integers(0, 2**40)),
        ici_link_pct=int(rng.integers(0, 101)))


def _config_fields(rng):
    return dict(
        pod_uid=_name(rng, 47), pod_name=_name(rng, 63),
        pod_namespace=_name(rng, 63), container_name=_name(rng, 63),
        compat_mode=int(rng.integers(0, 16)),
        compile_cache_dir="/" + _name(rng, 62),
        workload_class=int(rng.integers(0, 3)),
        quota_epoch=int(rng.integers(0, 2**32)),
        migration_freeze=int(rng.integers(0, 2)),
        freeze_epoch=int(rng.integers(0, 2**32)))


@pytest.mark.parametrize("seed", range(6))
def test_config_bytes_match_the_jax_writer(seed, tmp_path):
    rng = np.random.default_rng(seed)
    n_dev = int(rng.integers(0, 9))
    fields = _config_fields(rng)
    devs = [_device_fields(rng) for _ in range(n_dev)]
    mine = vc.VtpuConfig(**fields, devices=[vc.DeviceConfig(**d)
                                           for d in devs])
    theirs = jvc.VtpuConfig(**fields, devices=[jvc.DeviceConfig(**d)
                                               for d in devs])
    assert len(mine.pack()) == vc.CONFIG_SIZE == jvc.CONFIG_SIZE == 9560
    assert mine.pack() == theirs.pack()
    # each side reads the other's file
    vc.write_config(str(tmp_path / "port.config"), mine)
    jvc.write_config(str(tmp_path / "jax.config"), theirs)
    from_jax = vc.read_config(str(tmp_path / "jax.config"))
    from_port = jvc.read_config(str(tmp_path / "port.config"))
    assert dataclasses.asdict(from_jax) == dataclasses.asdict(mine)
    assert dataclasses.asdict(from_port) == dataclasses.asdict(theirs)


def test_offset_tables_match():
    assert vc.DEVICE_OFFSETS == jvc.DEVICE_OFFSETS
    assert vc.HEADER_OFFSETS == jvc.HEADER_OFFSETS
    assert (vc.MAGIC, vc.VERSION) == (jvc.MAGIC, jvc.VERSION)


def _corrupt(raw: bytes, kind: str) -> bytes:
    b = bytearray(raw)
    if kind == "magic":
        b[0] ^= 0xFF
    elif kind == "version":
        b[4] = 5
    elif kind == "size":
        return bytes(b[:-8])
    elif kind == "checksum":
        b[300] ^= 0x01                    # a header byte under the checksum
    elif kind == "footer_pad":
        b[-1] = 1
    return bytes(b)


CORRUPTIONS = ["magic", "version", "size", "checksum", "footer_pad"]


@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_python_readers_reject_a_bad_file(kind):
    raw = vc.VtpuConfig(pod_uid="u", devices=[
        vc.DeviceConfig(uuid="GPU-0", total_memory=1, real_memory=1)]).pack()
    if kind in ("magic", "version"):
        # re-seal, so only the field itself is wrong
        body = _corrupt(raw, kind)[:-8]
        import struct
        raw_bad = body + struct.pack("<II", vc.fnv1a(body), 0)
    else:
        raw_bad = _corrupt(raw, kind)
    with pytest.raises(ValueError):
        vc.VtpuConfig.unpack(raw_bad)
    with pytest.raises(ValueError):
        jvc.VtpuConfig.unpack(raw_bad)


@pytest.mark.parametrize("kind", ["good"] + CORRUPTIONS)
def test_interposer_reads_only_a_valid_file(kind, tmp_path):
    """A 1 MiB cap from the file refuses 2 MiB; a damaged file is
    ignored (no limit in the environment either, so 2 MiB is granted)."""
    path = tmp_path / "vtpu.config"
    cfg = bench_quota.tenant_config(str(path), "uid-x", cap=1 << 20)
    raw = cfg.pack()
    if kind != "good":
        if kind in ("magic", "version"):
            import struct
            body = _corrupt(raw, kind)[:-8]
            raw = body + struct.pack("<II", vc.fnv1a(body), 0)
        else:
            raw = _corrupt(raw, kind)
        path.write_bytes(raw)
    out = bench_quota.run_fake_harness(
        "--alloc", SHIM_TEST_ALLOCS=2 << 20, VTPU_CONFIG_PATH=str(path))
    assert out["rc"] == 0, out["stderr"]
    assert out["verdicts"]["alloc0"] == (2 if kind == "good" else 0)
    if kind != "good":
        assert "config" in out["stderr"]         # said so, loudly


def test_file_wins_over_the_environment(tmp_path):
    path = tmp_path / "vtpu.config"
    bench_quota.tenant_config(str(path), "uid-x", cap=4 << 20)
    out = bench_quota.run_fake_harness(
        "--alloc", SHIM_TEST_ALLOCS=f"{3 << 20},{2 << 20}",
        VTPU_CONFIG_PATH=str(path), VTPU_MEM_LIMIT_0=1 << 20)
    # 3 MiB fits the file's 4 MiB (the env's 1 MiB would refuse it)
    assert out["verdicts"] == {"alloc0": 0, "alloc1": 2}


# --- the memory ledger ---------------------------------------------------


def _ledger_ops(rng, pid):
    ops = []
    for _ in range(40):
        kind = rng.integers(0, 3)
        host = int(rng.integers(0, 4))
        token = int(rng.integers(1, 2**63))
        if kind == 0:
            ops.append(("record", pid + int(rng.integers(0, 3)), host,
                        int(rng.integers(0, 2**36)), token))
        elif kind == 1:
            ops.append(("record", pid, host, 0, token))
        else:
            ops.append(("bump", pid, host, int(rng.integers(1, 50)), token))
    return ops


def _apply(ledger, ops):
    for op, pid, host, n, token in ops:
        if op == "record":
            ledger.record(pid, host, n, owner_token=token)
        else:
            ledger.bump_activity(pid, host, n=n, owner_token=token)


def _entries(ledger):
    return [(e.pid, e.host_index, e.bytes, e.owner_token, e.activity,
             e.spilled) for e in ledger.entries()]


@pytest.mark.parametrize("seed", range(3))
def test_ledger_matches_the_jax_ledger(seed, tmp_path):
    rng = np.random.default_rng(seed)
    ops = _ledger_ops(rng, os.getpid())
    mine = vmem.VmemLedger(str(tmp_path / "port.vmem"), create=True)
    theirs = jvmem.VmemLedger(str(tmp_path / "jax.vmem"), create=True)
    try:
        _apply(mine, ops)
        _apply(theirs, ops)
        assert _entries(mine) == _entries(theirs)
        assert os.path.getsize(tmp_path / "port.vmem") == \
            jvmem.FILE_SIZE == vmem.FILE_SIZE
        for host in range(4):
            assert mine.device_total(host) == theirs.device_total(host)
    finally:
        mine.close()
        theirs.close()
    # each side reads the other's file
    cross_mine = vmem.VmemLedger(str(tmp_path / "jax.vmem"))
    cross_theirs = jvmem.VmemLedger(str(tmp_path / "port.vmem"))
    assert _entries(cross_mine) == _entries(cross_theirs)
    cross_mine.close()
    cross_theirs.close()


def test_ledger_reaps_a_dead_stale_entry(tmp_path, monkeypatch):
    # a reaped child's pid: dead in this namespace, never a guess
    child = subprocess.Popen(["true"])
    child.wait()
    monkeypatch.setenv("VTPU_VMEM_STALE_S", "0.05")
    led = vmem.VmemLedger(str(tmp_path / "v.config"), create=True)
    led.record(child.pid, 0, 1 << 20, owner_token=7)
    led.record(os.getpid(), 0, 1 << 10, owner_token=8)
    import time
    time.sleep(0.1)
    assert led.device_total(0) == 1 << 10       # the dead entry is skipped
    assert [e.pid for e in led.entries()] == [os.getpid()]   # and reaped
    led.close()


@pytest.mark.parametrize("value", [None, "", "0", "-5", "nan", "garbage",
                                   "1e12", "inf", "2.5", "120"])
def test_stale_window_parity(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("VTPU_VMEM_STALE_S", raising=False)
    else:
        monkeypatch.setenv("VTPU_VMEM_STALE_S", value)
    assert vmem.stale_reap_ns() == jvmem._stale_reap_ns()


def test_owner_token_matches(monkeypatch):
    monkeypatch.setenv("VTPU_POD_UID", "uid-abc")
    monkeypatch.setenv("VTPU_CONTAINER_NAME", "main")
    assert vmem.owner_token_from_env() == jvmem.owner_token_from_env()
    monkeypatch.delenv("VTPU_POD_UID")
    assert vmem.owner_token_from_env() == jvmem.owner_token_from_env()


# --- the utilization feed ------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_feed_bytes_match_the_jax_writer(seed, tmp_path):
    rng = np.random.default_rng(seed)
    mine = tc.TcUtilFile(str(tmp_path / "port.tc"), create=True)
    theirs = jtc.TcUtilFile(str(tmp_path / "jax.tc"), create=True)
    for _ in range(5):
        index = int(rng.integers(0, 64))
        ts = int(rng.integers(0, 2**62))
        util = int(rng.integers(0, 101))
        procs = [(int(rng.integers(1, 2**31)), int(rng.integers(0, 101)),
                  int(rng.integers(0, 2**40)), int(rng.integers(0, 2**63)))
                 for _ in range(int(rng.integers(0, 40)))]
        mine.write_device(index, tc.DeviceUtil(ts, util, [
            tc.ProcUtil(*p) for p in procs]))
        theirs.write_device(index, jtc.DeviceUtil(ts, util, [
            jtc.ProcUtil(*p) for p in procs]))
    table = [(int(g), int(e)) for g, e in rng.integers(0, 10**6,
                                                       size=(10, 2))]
    mine.write_calibration(table, now_ns=123)
    theirs.write_calibration(table, now_ns=123)
    mine.close()
    theirs.close()
    assert (tmp_path / "port.tc").read_bytes() == \
        (tmp_path / "jax.tc").read_bytes()
    cross = tc.TcUtilFile(str(tmp_path / "jax.tc"))
    jcross = jtc.TcUtilFile(str(tmp_path / "port.tc"))
    for i in range(64):
        a, b = cross.read_device(i), jcross.read_device(i)
        assert (a.timestamp_ns, a.device_util) == (b.timestamp_ns,
                                                   b.device_util)
        assert [dataclasses.astuple(p) for p in a.procs] == \
            [dataclasses.astuple(p) for p in b.procs]
    assert cross.read_calibration() == jcross.read_calibration()
    cross.close()
    jcross.close()


def test_feed_freshness_matches():
    for ts, now in [(0, 10**9), (10**9, 10**9 + 4 * 10**9),
                    (10**9, 10**9 + 6 * 10**9), (5 * 10**9, 10**9)]:
        assert tc.DeviceUtil(ts, 0).is_fresh(now_ns=now) == \
            jtc.DeviceUtil(ts, 0).is_fresh(now_ns=now)


# --- the C++ layouts -----------------------------------------------------

STRUCTS = {
    "VtpuDevice": ["uuid", "total_memory", "real_memory", "hard_core",
                   "soft_core", "core_limit", "memory_limit",
                   "memory_oversold", "host_index", "mesh_x", "mesh_y",
                   "mesh_z", "lease_core", "virtual_hbm_bytes",
                   "spill_budget_bytes", "ici_link_pct"],
    "VtpuConfig": ["magic", "version", "pod_uid", "pod_name",
                   "pod_namespace", "container_name", "device_count",
                   "compat_mode", "compile_cache_dir", "workload_class",
                   "quota_epoch", "migration_freeze", "freeze_epoch",
                   "devices", "checksum"],
    "TcProcUtil": ["pid", "util", "mem_used", "owner_token"],
    "TcDeviceRecord": ["seq", "timestamp_ns", "device_util", "proc_count",
                       "procs"],
    "TcUtilFile": ["magic", "version", "device_count", "records"],
    "TcCalibration": ["seq", "timestamp_ns", "n_points", "gap_us",
                      "excess_us"],
    "VmemEntry": ["pid", "host_index", "bytes", "last_update_ns",
                  "owner_token", "activity", "spilled"],
    "VmemFile": ["magic", "version", "max_entries", "entries"],
    "PidsFileHeader": ["magic", "version", "count", "pad_"],
}


def _layout_probe(tmp_path, header, namespace):
    lines = [f'#include "{header}"', "#include <cstdio>",
             "#include <cstddef>", f"using namespace {namespace};",
             "int main() {"]
    for struct, fields in STRUCTS.items():
        lines.append(f'  printf("{struct} %zu\\n", sizeof({struct}));')
        for f in fields:
            lines.append(f'  printf("{struct}.{f} %zu\\n", '
                         f'offsetof({struct}, {f}));')
    lines += [
        '  const char* s = "uid-abc/main";',
        '  printf("fnv64 %llu\\n", (unsigned long long)Fnv1a64(s));',
        '  printf("fnv32 %u\\n", Fnv1a((const uint8_t*)s, 12));',
        '  const char* v[] = {nullptr, "", "0", "-5", "nan", "x", "1e12",'
        ' "2.5"};',
        '  for (const char* x : v) printf("stale %llu\\n",'
        ' (unsigned long long)VmemStaleReapNsFromEnv(x));',
        '  printf("kCompatHost %d\\n", (int)kCompatHost);',
        '  printf("kCompatClient %d\\n", (int)kCompatClient);',
        '  printf("kPidsMagic %u\\n", (unsigned)kPidsMagic);',
        "  return 0;", "}"]
    src = tmp_path / f"probe_{namespace}.cc"
    src.write_text("\n".join(lines))
    exe = tmp_path / f"probe_{namespace}"
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    return subprocess.run([str(exe)], check=True, capture_output=True,
                          text=True).stdout


def test_cxx_layouts_match_the_jax_header(tmp_path):
    mine = _layout_probe(
        tmp_path, REPO / "vtpu_manager_torch/csrc/shim/vtpu_abi.h",
        "vtpu_abi")
    theirs = _layout_probe(tmp_path, REPO / "library/include/vtpu_config.h",
                           "vtpu")
    assert mine == theirs
    got = dict(line.rsplit(" ", 1) for line in mine.splitlines()
               if not line.startswith("stale"))
    assert int(got["VtpuConfig"]) == vc.CONFIG_SIZE
    assert int(got["VmemFile"]) == vmem.FILE_SIZE
    assert int(got["TcUtilFile"]) + int(got["TcCalibration"]) == tc.FILE_SIZE
    for field, off in vc.DEVICE_OFFSETS.items():
        assert int(got[f"VtpuDevice.{field}"]) == off
    for field, off in vc.HEADER_OFFSETS.items():
        assert int(got[f"VtpuConfig.{field}"]) == off
    assert int(got["fnv64"]) == vmem.fnv64("uid-abc/main")
    assert int(got["fnv32"]) == vc.fnv1a(b"uid-abc/main")
    assert int(got["kCompatHost"]) == consts.COMPAT_HOST
    assert int(got["kCompatClient"]) == consts.COMPAT_CLIENT
    assert int(got["kPidsMagic"]) == registry.PIDS_MAGIC
