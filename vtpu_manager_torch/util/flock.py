"""Cross-process file locks with a timeout and backoff.

The port's own copy of the JAX package's `util/flock.py:25-78`: flock(2)
on a dedicated lock file (per open file description, so two opens in one
process exclude each other), backoff from 1 ms doubling to 10 ms, and
`LockTimeout` after `timeout_s` instead of a hang, and the
`flock.acquire` failpoint at entry. The interposer takes the ledger's lock
by the same protocol (`csrc/shim/enforce_mem.cc`).
"""

from __future__ import annotations

import errno
import fcntl
import os
import time

from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.util import consts


class LockTimeout(TimeoutError):
    pass


class FileLock:
    """Non-reentrant; `with FileLock(path):` or acquire() / release()."""

    def __init__(self, path: str, timeout_s: float = consts.LOCK_TIMEOUT_S):
        self.path = path
        self.timeout_s = timeout_s
        self._fd: int | None = None

    def acquire(self) -> None:
        # latency models a wedged peer's contention; an error (arm with
        # exc=LockTimeout) the timeout firing
        failpoints.fire("flock.acquire", path=self.path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o666)
        deadline = time.monotonic() + self.timeout_s
        backoff = 0.001
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                self._fd = fd
                return
            except OSError as e:
                if e.errno not in (errno.EAGAIN, errno.EACCES):
                    os.close(fd)
                    raise
            if time.monotonic() >= deadline:
                os.close(fd)
                raise LockTimeout(f"lock {self.path} not acquired within "
                                  f"{self.timeout_s}s")
            time.sleep(backoff)
            backoff = min(backoff * 2, 0.010)

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
