#!/usr/bin/env python3
"""The CLIENT-mode registrar, standard library only.

The counterpart of `library/tools/vtpu_device_client.py`. A CLIENT-mode
tenant's interposer runs it to announce the container to the node
registry (`vtpu_manager_torch/registry/server.py`), which attests the
caller's pid by SO_PEERCRED and writes the container's `pids.config`.
Tenant images need not carry the `vtpu_manager_torch` package, so the
node installs this one file beside the interposer in the driver dir,
which is mounted into every tenant, and the interposer runs it with the
image's own python3. It imports nothing of either package: the names
below are `util/consts.py`'s, copied.

Protocol: one length-prefixed JSON object over the registry's unix
socket (a little-endian u32 length, then the bytes), answered by a
little-endian i32 status, 0 when accepted. Retries for a few seconds:
a container's start can race the registry's restart, and a missed
registration would leave the container's processes unattested for its
lifetime.

A tenant admitted under tracing (`VTPU_TRACE_ID`, sampled) gets the
`shim.register` span of each attempt in its spool, as the port's trace
recorder writes one (`trace/recorder.py`: JSON lines in
`tenant.<pid>.jsonl` under `VTPU_TRACE_DIR`, appended under the spool's
flock), so the pod's timeline holds the tenant's side of each
registration beside the registry's.

Usage: VTPU_REGISTRY_SOCKET=<socket> VTPU_POD_UID=<uid>
VTPU_CONTAINER_NAME=<name> python3 vtpu_device_client.py
"""

from __future__ import annotations

import fcntl
import json
import os
import socket
import struct
import sys
import time

DEFAULT_SOCKET = "/etc/vtpu-manager/registry/socket.sock"
DEFAULT_TRACE_DIR = "/etc/vtpu-manager/trace"


def register_once(path: str, timeout_s: float = 5.0) -> bool:
    payload = json.dumps({
        "pod_name": os.environ.get("VTPU_POD_NAME", ""),
        "pod_namespace": os.environ.get("VTPU_POD_NAMESPACE", ""),
        "pod_uid": os.environ.get("VTPU_POD_UID", ""),
        "container": os.environ.get("VTPU_CONTAINER_NAME", ""),
        "register_uuid": os.environ.get("VTPU_REGISTER_UUID", ""),
    }).encode()
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
            sock.settimeout(timeout_s)
            sock.connect(path)
            sock.sendall(struct.pack("<I", len(payload)) + payload)
            raw = sock.recv(4)
    except OSError:
        return False
    return len(raw) == 4 and struct.unpack("<i", raw)[0] == 0


def record_span(start_s: float, dur_s: float) -> None:
    """Appends one `shim.register` span to this process's spool when the
    tenant is traced and sampled; a spool that cannot be written loses
    the span, never the registration."""
    trace_id = os.environ.get("VTPU_TRACE_ID", "")
    if not trace_id or os.environ.get("VTPU_TRACE_SAMPLED",
                                      "true") != "true":
        return
    spool_dir = os.environ.get("VTPU_TRACE_DIR") or DEFAULT_TRACE_DIR
    path = os.path.join(spool_dir, f"tenant.{os.getpid()}.jsonl")
    lines = [{"kind": "span", "stage": "shim.register", "trace": trace_id,
              "pod": os.environ.get("VTPU_POD_UID", ""),
              "service": "tenant", "start": round(start_s, 6),
              "dur": round(dur_s, 6)},
             {"kind": "meta", "service": "tenant", "pid": os.getpid(),
              "drops": 0, "ts": round(time.time(), 3)}]
    try:
        os.makedirs(spool_dir, exist_ok=True)
        fd = os.open(f"{path}.flock", os.O_CREAT | os.O_RDWR, 0o666)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            with open(path, "a") as f:
                f.write("".join(json.dumps(d, separators=(",", ":")) + "\n"
                                for d in lines))
        finally:
            os.close(fd)
    except OSError:
        pass


def main(attempts: int = 6) -> int:
    path = os.environ.get("VTPU_REGISTRY_SOCKET", DEFAULT_SOCKET)
    delay = 0.5
    for attempt in range(1, attempts + 1):
        start, t0 = time.time(), time.perf_counter()
        accepted = register_once(path)
        record_span(start, time.perf_counter() - t0)
        if accepted:
            print("vtpu device-client: registered", file=sys.stderr)
            return 0
        if attempt < attempts:
            time.sleep(delay)
            delay = min(delay * 2, 8.0)
    print(f"vtpu device-client: registration FAILED after {attempts} "
          f"attempts ({path})", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
