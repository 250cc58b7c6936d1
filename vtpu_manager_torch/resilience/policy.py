"""Retries of the node agent's API calls.

The port of the JAX package's `resilience/policy.py:50-140` (`RetryPolicy`,
`is_retryable`): jittered exponential backoff under a deadline, the API
server's Retry-After honoured, and only transient failures retried (404,
403, 409 and 422 mean the world changed, not the wire: they surface at
once). The circuit breaker and the per-process counters are not ported yet.
"""

from __future__ import annotations

import logging
import time
from random import Random
from typing import Callable

from vtpu_manager_torch.client.kube import KubeError

log = logging.getLogger(__name__)

# throttling, transient server errors, and 0 (a transport failure)
RETRYABLE_STATUSES = frozenset({0, 408, 429, 500, 502, 503, 504})


def is_retryable(exc: BaseException) -> bool:
    if isinstance(exc, KubeError):
        return exc.status in RETRYABLE_STATUSES
    return isinstance(exc, (ConnectionError, TimeoutError))


class RetryPolicy:
    """`run(fn, op=...)` retries retryable failures until `deadline_s`
    (monotonic) or `max_attempts` is spent, then raises the last error;
    other errors raise at once. `rng`, `sleep` and `clock` are for tests."""

    def __init__(self, max_attempts: int = 5, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, deadline_s: float = 30.0,
                 rng: Random | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        self.max_attempts = max(1, max_attempts)
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.deadline_s = deadline_s
        self._rng = rng or Random()
        self._sleep = sleep
        self._clock = clock

    def backoff_s(self, attempt: int,
                  retry_after: float | None = None) -> float:
        """Full-jitter delay after the attempt-th failure (1-based), at
        least the server's Retry-After when it sent one."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * (2 ** max(0, attempt - 1)))
        delay = cap * (0.5 + 0.5 * self._rng.random())
        if retry_after is not None:
            delay = max(delay, retry_after)
        return delay

    def run(self, fn: Callable, op: str = "kube"):
        start = self._clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - classified, re-raised
                if not is_retryable(e):
                    raise
                delay = self.backoff_s(attempt,
                                       getattr(e, "retry_after", None))
                elapsed = self._clock() - start
                if attempt >= self.max_attempts or \
                        elapsed + delay > self.deadline_s:
                    log.warning("%s: giving up after %d attempt(s) "
                                "(%.2fs elapsed): %s", op, attempt,
                                elapsed, e)
                    raise
                log.debug("%s: attempt %d failed (%s); retrying in %.3fs",
                          op, attempt, e, delay)
                self._sleep(delay)
