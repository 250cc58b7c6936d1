"""Retries of the node agent's API calls.

The port of the JAX package's `resilience/policy.py:50-260`
(`RetryPolicy`, `is_retryable`, `CircuitBreaker`, `KubeResilience`):
jittered exponential backoff under a deadline, the API server's
Retry-After honoured, and only transient failures retried (404, 403, 409
and 422 mean the world changed, not the wire: they surface at once); a
breaker that, after consecutive failed calls, rejects calls locally for a
while instead of queueing doomed ones. `render_resilience_metrics` (the
JAX package's `:245`) renders this process's counters; the node exporter
appends it to /metrics, so it shows the exporter's own counters, not
those of the plugins that retry. Its failpoint block is the JAX
registry's output with nothing armed: fault injection is not ported.
"""

from __future__ import annotations

import logging
import threading
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


class _Counters:
    """(op, event) -> count for this process; dict adds under the GIL."""

    def __init__(self) -> None:
        self.data: dict[tuple[str, str], int] = {}

    def bump(self, op: str, event: str, n: int = 1) -> None:
        key = (op, event)
        self.data[key] = self.data.get(key, 0) + n


COUNTERS = _Counters()


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
                result = fn()
            except Exception as e:  # noqa: BLE001 - classified, re-raised
                if not is_retryable(e):
                    COUNTERS.bump(op, "terminal")
                    raise
                delay = self.backoff_s(attempt,
                                       getattr(e, "retry_after", None))
                elapsed = self._clock() - start
                if attempt >= self.max_attempts or \
                        elapsed + delay > self.deadline_s:
                    COUNTERS.bump(op, "exhausted")
                    log.warning("%s: giving up after %d attempt(s) "
                                "(%.2fs elapsed): %s", op, attempt,
                                elapsed, e)
                    raise
                COUNTERS.bump(op, "retries")
                log.debug("%s: attempt %d failed (%s); retrying in %.3fs",
                          op, attempt, e, delay)
                self._sleep(delay)
                continue
            if attempt > 1:
                COUNTERS.bump(op, "recovered")
            return result


class CircuitOpenError(RuntimeError):
    """Raised instead of calling a dependency whose circuit is open."""


class CircuitBreaker:
    """Consecutive-failure breaker for one dependency.

    closed -> (`failure_threshold` consecutive failures) -> open for
    `reset_timeout_s` (calls rejected) -> one half-open probe -> a success
    closes it, a failure opens it again. Thread-safe; `clock` is for
    tests."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, name: str = "kube", failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._state == self.OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout_s:
            self._state = self.HALF_OPEN
            self._probing = False
        return self._state

    def allow(self) -> bool:
        """True when a call may proceed. Half-open lets exactly one caller
        probe; the rest are rejected until it reports."""
        with self._lock:
            state = self._state_locked()
            if state == self.CLOSED:
                return True
            if state == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            COUNTERS.bump(self.name, "circuit_rejected")
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state != self.CLOSED:
                COUNTERS.bump(self.name, "circuit_closed")
                log.info("circuit %s closed", self.name)
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            state = self._state_locked()
            self._failures += 1
            if state == self.HALF_OPEN or (
                    state == self.CLOSED
                    and self._failures >= self.failure_threshold):
                if self._state != self.OPEN:
                    COUNTERS.bump(self.name, "circuit_opened")
                    log.warning("circuit %s opened after %d consecutive "
                                "failure(s)", self.name, self._failures)
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probing = False


class KubeResilience:
    """Retries under a breaker: the breaker gates the whole retried call,
    and only a call that fails after its retries counts against it (a 503
    that a retry absorbed is not a failure)."""

    def __init__(self, policy: RetryPolicy | None = None,
                 breaker: CircuitBreaker | None = None):
        self.policy = policy or RetryPolicy()
        self.breaker = breaker or CircuitBreaker()

    def call(self, fn: Callable, op: str = "kube"):
        if not self.breaker.allow():
            raise CircuitOpenError(
                f"{self.breaker.name} circuit open; rejecting {op}")
        try:
            result = self.policy.run(fn, op=op)
        except Exception:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return result


# -- metrics -----------------------------------------------------------------

def render_failpoint_metrics() -> str:
    """The JAX registry's block with nothing armed (fault injection is not
    ported, so nothing here ever fires)."""
    return ("# TYPE vtpu_failpoint_fires_total counter\n"
            "# TYPE vtpu_failpoint_evaluations_total counter\n"
            "vtpu_failpoint_evaluations_total 0")


def render_resilience_metrics() -> str:
    """This process's counters as Prometheus text, appended to the node
    exporter's /metrics; the same families and lines as the JAX
    package's with no breaker passed."""
    events: dict[str, list[tuple[str, int]]] = {}
    for (op, event), count in sorted(COUNTERS.data.items()):
        events.setdefault(event, []).append((op, count))
    lines: list[str] = []
    for event, metric in (("retries", "vtpu_resilience_retries_total"),
                          ("terminal",
                           "vtpu_resilience_terminal_errors_total"),
                          ("exhausted", "vtpu_resilience_exhausted_total"),
                          ("recovered", "vtpu_resilience_recovered_total"),
                          ("circuit_rejected",
                           "vtpu_circuit_rejected_total")):
        lines.append(f"# TYPE {metric} counter")
        for op, count in events.get(event, ()):
            lines.append(f'{metric}{{op="{op}"}} {count}')
    total_failures = sum(
        count for (op, event), count in COUNTERS.data.items()
        if op == "reschedule.reconcile" and event == "failure")
    lines.append("# TYPE vtpu_reschedule_reconcile_failures_total counter\n"
                 f"vtpu_reschedule_reconcile_failures_total {total_failures}")
    lines.append(render_failpoint_metrics())
    return "\n".join(lines)
