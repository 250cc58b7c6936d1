"""The node registry (ClientMode): kernel-attested pid sets of the node's
tenant containers.

The port of the JAX package's `registry/server.py`: the `pids.config`
writer and reader (`write_pids_config`, `read_pids_config`, the same
bytes), SO_PEERCRED (`_peercred`), the cgroup lookups
(`default_cgroup_of_pid`, `default_pids_in_cgroup`,
`pod_uid_from_cgroup`) and `RegistryServer` with its cgroup-leaf binding,
`handle_request` (the `registry.register` failpoint and span),
`reap_orphans`, `start` and `stop`.

A tenant's device client (`runtime/client.py`, which the interposer
starts in CLIENT compat mode) connects to the unix socket and sends its
pod identity as length-prefixed JSON; the kernel tells the server the
peer's pid, and the pid's cgroup path must embed the claimed pod uid
(kubelet names pod cgroups `...pod<uid>...`), so a container cannot
register as another pod. The server writes the attested cgroup's pids to
`<base>/<uid>_<container>/config/pids.config`, which Allocate mounts into
the container, where the interposer reads it to tell its own processes
from co-tenants in the ledger and the feed. The JAX package's caller of
`reap_orphans` is the reschedule controller, which the port does not
have: the method is here, tested, and has no caller yet. Unlike the JAX
writer, `write_pids_config` names its temp file by thread as well as by
process, so that two registrations of one container at once (one per
tenant process) both land.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import struct
import threading
from typing import Callable

from vtpu_manager_torch import trace
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)

SO_PEERCRED = getattr(socket, "SO_PEERCRED", 17)

PIDS_MAGIC = 0x53444950  # "PIDS"
_PIDS_HEADER = "<IIii"   # magic, version, count, pad


def write_pids_config(path: str, pids: list[int]) -> None:
    # one temp file per thread: the server attests registrations on a
    # thread each, and two of one container at once would otherwise share
    # a temp name (the JAX writer's `.tmp.<pid>`), one replace then
    # finding the other's file gone
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack(_PIDS_HEADER, PIDS_MAGIC, 1, len(pids), 0))
        for pid in pids:
            f.write(struct.pack("<i", pid))
    os.replace(tmp, path)


def read_pids_config(path: str) -> list[int]:
    with open(path, "rb") as f:
        raw = f.read()
    magic, version, count, _ = struct.unpack_from(_PIDS_HEADER, raw, 0)
    if magic != PIDS_MAGIC or version != 1 or count < 0:
        raise ValueError(f"bad pids.config {path}")
    return [struct.unpack_from("<i", raw, 16 + 4 * i)[0]
            for i in range(count)]


def _peercred(conn: socket.socket) -> tuple[int, int, int]:
    raw = conn.getsockopt(socket.SOL_SOCKET, SO_PEERCRED,
                          struct.calcsize("3i"))
    return struct.unpack("3i", raw)   # pid, uid, gid


def default_cgroup_of_pid(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cgroup") as f:
            for line in f:
                parts = line.strip().split(":", 2)
                if len(parts) == 3:
                    return parts[2]
    except OSError:
        pass
    return ""


def default_pids_in_cgroup(cgroup_path: str) -> list[int]:
    procs = f"/sys/fs/cgroup{cgroup_path}/cgroup.procs"
    try:
        with open(procs) as f:
            return [int(line) for line in f if line.strip()]
    except OSError:
        return []


# kubelet embeds the pod uid in the cgroup path as `pod<uid>`, with the
# uid's dashes kept (cgroupfs driver) or replaced by underscores (systemd
# driver).  Reference peercred.go extracts the uid by regex and requires
# equality with the claim — a substring test would let a generic claim like
# "kubepods" pass attestation.
_POD_UID_RE = re.compile(
    r"pod([0-9a-fA-F]{8}[-_][0-9a-fA-F]{4}[-_][0-9a-fA-F]{4}"
    r"[-_][0-9a-fA-F]{4}[-_][0-9a-fA-F]{12})")
_UUID_RE = re.compile(
    r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}"
    r"-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$")
# container names are DNS labels (RFC 1123): lowercase alnum + '-', ≤63.
_DNS_LABEL_RE = re.compile(r"^[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?$")


def pod_uid_from_cgroup(cgroup: str) -> str:
    """Extract the UUID-shaped pod uid embedded in a kubelet cgroup path,
    normalized to canonical dashed lowercase; '' if none is present."""
    m = _POD_UID_RE.search(cgroup)
    if not m:
        return ""
    return m.group(1).replace("_", "-").lower()


def _uid_in_cgroup(cgroup: str, pod_uid: str) -> bool:
    extracted = pod_uid_from_cgroup(cgroup)
    return bool(extracted) and extracted == pod_uid.replace("_", "-").lower()


class RegistryServer:
    def __init__(self, socket_path: str = consts.REGISTRY_SOCKET,
                 base_dir: str = consts.MANAGER_BASE_DIR,
                 cgroup_of_pid: Callable[[int], str] = default_cgroup_of_pid,
                 pids_in_cgroup: Callable[[str], list[int]] =
                 default_pids_in_cgroup):
        self.socket_path = socket_path
        self.base_dir = base_dir
        self.cgroup_of_pid = cgroup_of_pid
        self.pids_in_cgroup = pids_in_cgroup
        self._sock: socket.socket | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.registrations: list[dict] = []   # observability for tests
        # cgroup-leaf binding: one live runtime container (cgroup leaf) may
        # only register as one container name at a time, and vice versa.
        # This NARROWS the within-pod hole (the pod uid attests only the
        # pod): a leaf cannot claim two names, and a sibling cannot take
        # over a name after its legitimate owner registered.  It cannot
        # prevent a first-claim race before the owner registers — the
        # registry has no runtime source for name↔leaf truth (the reference
        # resolves this via the container runtime; see NRI hook).  A stale
        # binding whose cgroup has no live pids is released, so container
        # restarts (new leaf) re-register cleanly.
        self._bind: dict[tuple[str, str], str] = {}   # (uid, name) -> cgroup
        self._bind_lock = threading.Lock()
        # two-strike ledger for reap_orphans: a binding must look dead
        # on two CONSECUTIVE reaps before removal (see below)
        self._orphan_suspects: set[tuple[str, str]] = set()

    # -- request handling ---------------------------------------------------

    def _admit_binding(self, pod_uid: str, container: str, cgroup: str,
                       peer_pid: int) -> bool:
        """Conflict-check (caller holds _bind_lock; nothing is recorded
        here — bindings are written only after the full request succeeds).
        A binding whose cgroup no longer has live pids is stale (the
        container restarted under a new leaf) and is released."""
        bound = self._bind.get((pod_uid, container))
        if bound is not None and bound != cgroup:
            if self.pids_in_cgroup(bound):
                log.warning("registry: container %s/%s already bound to "
                            "live cgroup %r; rejecting pid %d from %r",
                            pod_uid, container, bound, peer_pid, cgroup)
                return False
            log.info("registry: releasing stale binding %s/%s -> %r",
                     pod_uid, container, bound)
            del self._bind[(pod_uid, container)]
        for (uid, name), cg in self._bind.items():
            if uid == pod_uid and cg == cgroup and name != container:
                log.warning("registry: cgroup %r already registered as "
                            "%s/%s; rejecting claim for container %r",
                            cgroup, pod_uid, name, container)
                return False
        return True

    def handle_request(self, payload: dict, peer_pid: int) -> int:
        """0 on success; nonzero error codes mirror the reference's status
        replies. The peer pid is kernel-attested."""
        pod_uid = str(payload.get("pod_uid", ""))
        container = str(payload.get("container", ""))
        if not pod_uid or not container:
            return 2   # malformed identity
        # Shape-validate before any path use: pod_uid must be a UUID and
        # container a DNS label, so neither can smuggle '/' or '..' into the
        # allocation-dir join below.
        if not _UUID_RE.match(pod_uid) or not _DNS_LABEL_RE.match(container):
            log.warning("registry: malformed identity pod=%r container=%r "
                        "from pid %d", pod_uid, container, peer_pid)
            return 2
        cgroup = self.cgroup_of_pid(peer_pid)
        if not cgroup or not _uid_in_cgroup(cgroup, pod_uid):
            log.warning("registry spoof attempt: pid %d cgroup %r does not "
                        "match claimed pod %s", peer_pid, cgroup, pod_uid)
            return 3   # identity not attested by the kernel
        with self._bind_lock:
            if not self._admit_binding(pod_uid, container, cgroup, peer_pid):
                return 3
        failpoints.fire("registry.register", pod_uid=pod_uid,
                        container=container)
        # vtrace: the registration is the last daemon-side stage of the
        # allocation path (the tenant is up and announcing itself); joined
        # by pod uid — the socket protocol carries no trace id
        with trace.span(trace.context_for_uid(pod_uid), "registry.register",
                        container=container):
            return self._register_attested(pod_uid, container, cgroup,
                                           peer_pid)

    def _register_attested(self, pod_uid: str, container: str, cgroup: str,
                           peer_pid: int) -> int:
        pids = self.pids_in_cgroup(cgroup)
        if peer_pid not in pids:
            pids.append(peer_pid)
        cont_dir = os.path.join(self.base_dir, f"{pod_uid}_{container}")
        # Defense in depth: the resolved dir must live directly under
        # base_dir even if a symlink was planted inside it.
        real = os.path.realpath(cont_dir)
        if os.path.dirname(real) != os.path.realpath(self.base_dir):
            log.warning("registry: allocation dir %r escapes base dir", real)
            return 4
        if not os.path.isdir(cont_dir):
            log.warning("registry: no allocation dir for %s/%s", pod_uid,
                        container)
            return 4   # not an allocated container on this node
        # Record the binding only once every check has passed, so a failed
        # attempt cannot poison the (pod, container) slot.  Reap bindings
        # whose cgroups have no live pids while we're here (bounds growth
        # across pod churn; registrations are rare — container starts).
        with self._bind_lock:
            dead = [k for k, cg in self._bind.items()
                    if cg != cgroup and not self.pids_in_cgroup(cg)]
            for k in dead:
                del self._bind[k]
            self._bind[(pod_uid, container)] = cgroup
        # inside config/: that subdir is what Allocate mounts into the
        # container, so the shim can read its own pid set
        write_pids_config(os.path.join(cont_dir, "config",
                                       consts.PIDS_CONFIG_NAME),
                          sorted(set(pids)))
        self.registrations.append({"pod_uid": pod_uid,
                                   "container": container,
                                   "peer_pid": peer_pid,
                                   "pids": sorted(set(pids))})
        return 0

    def reap_orphans(self, live_pod_uids: set[str]) -> int:
        """Drop bindings whose pod no longer exists (the reschedule
        controller feeds the live set each reconcile). The existing
        dead-cgroup reaping inside registration covers churn while
        registrations keep arriving; this covers the quiet node — a
        crashed tenant's binding must not squat its (pod, container)
        slot until the next unrelated registration.

        Two-strike rule: the caller's live set is a snapshot taken at
        the START of its reconcile, so a pod that registered during the
        pass looks dead once (TOCTOU). Removal requires looking dead on
        two consecutive reaps — a genuinely live binding is vindicated
        by the next pass's fresher list."""
        removed = 0
        with self._bind_lock:
            dead = {key for key in self._bind
                    if key[0] not in live_pod_uids}
            confirmed = dead & self._orphan_suspects
            for key in confirmed:
                del self._bind[key]
                removed += 1
            self._orphan_suspects = dead - confirmed
        if removed:
            log.info("registry: reaped %d orphan binding(s)", removed)
        return removed

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5)
            pid, _, _ = _peercred(conn)
            raw_len = conn.recv(4)
            if len(raw_len) < 4:
                return
            (length,) = struct.unpack("<I", raw_len)
            if length > 64 * 1024:
                conn.sendall(struct.pack("<i", 1))
                return
            data = b""
            while len(data) < length:
                chunk = conn.recv(length - len(data))
                if not chunk:
                    return
                data += chunk
            try:
                payload = json.loads(data)
            except ValueError:
                # ValueError covers both JSONDecodeError and the
                # UnicodeDecodeError raw non-UTF-8 bytes raise (the wire
                # fuzz found the latter escaping and killing the thread)
                conn.sendall(struct.pack("<i", 1))
                return
            if not isinstance(payload, dict):
                # valid JSON that is not an object (list/number/string)
                # would raise inside handle_request and leave the client
                # hanging with no status byte
                conn.sendall(struct.pack("<i", 1))
                return
            try:
                status = self.handle_request(payload, pid)
            except Exception:  # noqa: BLE001 — a handler bug must answer
                # the client (it blocks on the status int) and must not
                # kill this connection thread silently
                log.exception("registry request handler failed")
                status = 1
            conn.sendall(struct.pack("<i", status))
        except OSError:
            pass
        finally:
            conn.close()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        os.makedirs(os.path.dirname(self.socket_path), exist_ok=True)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        os.chmod(self.socket_path, 0o666)   # tenants must be able to connect
        self._sock.listen(16)
        self._sock.settimeout(0.5)

        def loop():
            while not self._stop.is_set():
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="vtpu-registry")
        self._thread.start()
        log.info("registry serving on %s", self.socket_path)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        if self._sock:
            self._sock.close()
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
