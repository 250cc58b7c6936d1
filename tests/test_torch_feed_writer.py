"""The utilization feed's writer against a reader in another process.

A writer subprocess rewrites device 0's record and the calibration block
of one feed file as fast as it can while this process reads both: every
record read is whole (its fields agree with its timestamp) and no read
goes back to an older one or to the empty record. The seqs and the
record's head are stored as whole 8-byte words
(`vtpu_manager_torch/config/tc_watcher.py`): `struct.pack_into` zero-fills
a field's bytes before it writes them, and a reader that sees the seq at 0
twice in a row, as one does when the writer is preempted between the two,
takes a zeroed head for a stable record.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from vtpu_manager_torch.config.tc_watcher import TcUtilFile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TORTURE_WRITER = """
import sys
sys.path.insert(0, sys.argv[3])
from vtpu_manager_torch.config import tc_watcher as tw
f = tw.TcUtilFile(sys.argv[1])
for k in range(1, int(sys.argv[2]) + 1):
    f.write_device(0, tw.DeviceUtil(
        timestamp_ns=k * 1000 + 1, device_util=k % 101,
        procs=[tw.ProcUtil(pid=k, util=j, mem_used=k * 3,
                           owner_token=k * 5 + j)
               for j in range(k % 4)]))
    f.write_calibration([(k + g, k * 2 + g) for g in range(k % 3 + 1)],
                        now_ns=k * 1000 + 1)
f.close()
"""


def _check_record(rec, last: int) -> int:
    k = (rec.timestamp_ns - 1) // 1000
    assert rec.timestamp_ns == k * 1000 + 1 and k >= 1, rec
    assert rec.timestamp_ns >= last, (rec.timestamp_ns, last)
    assert rec.device_util == k % 101, rec
    assert [(p.pid, p.util, p.mem_used, p.owner_token) for p in rec.procs] \
        == [(k, j, k * 3, k * 5 + j) for j in range(k % 4)], rec
    return rec.timestamp_ns


def _check_calibration(cal, last: int) -> int:
    table, ts = cal
    k = (ts - 1) // 1000
    assert ts == k * 1000 + 1 and k >= 1, cal
    assert ts >= last, (ts, last)
    assert table == [(k + g, k * 2 + g) for g in range(k % 3 + 1)], cal
    return ts


def test_concurrent_feed_writer_never_tears_a_read(tmp_path):
    path = str(tmp_path / "tc_util.config")
    n = 20000
    TcUtilFile(path, create=True).close()
    proc = subprocess.Popen([sys.executable, "-c", _TORTURE_WRITER, path,
                             str(n), REPO])
    try:
        reader = TcUtilFile(path)
        last_rec = last_cal = reads = 0
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            done = proc.poll() is not None
            rec = reader.read_device(0)
            if rec is not None and (last_rec or rec.timestamp_ns):
                # the empty record only before the first write
                last_rec = _check_record(rec, last_rec)
                reads += 1
            cal = reader.read_calibration_full()
            if cal is not None:
                last_cal = _check_calibration(cal, last_cal)
            if done:
                break
        assert last_rec == n * 1000 + 1 and last_cal == n * 1000 + 1
        assert reads > 0
        reader.close()
    finally:
        proc.wait(timeout=120)
    assert proc.returncode == 0
