"""Allocation-path tracing: where a pod's time from admission to its first
step went, across the processes it passed through.

The port of the JAX package's `trace/`. Behind the Tracing gate (off by
default) the device plugin and the DRA kubelet plugin record spans of
their stages (`plugin.allocate`, `plugin.config`, `dra.prepare`,
`dra.cdi`), and a tenant whose Allocate response carries a sampled trace
id records its own (`shim.install`, `shim.first_execute`, `shim.compile`
with `shim.compile_outcome`), joined by the trace id minted at admission
or, where annotations cannot reach (DRA claims), by the pod's uid.

This module is the seam. Until `configure()` runs, every entry point
returns a constant after one `is None` check: no clock read, no
allocation, no recorder. With tracing on and a pod unsampled, `span()`
returns the same shared null span, so the sampling rate bounds the cost.

    ctx = trace.context_for_pod(pod)       # None when off or untraced
    with trace.span(ctx, "plugin.allocate", container=cont):
        ...

Each process spools its own spans (recorder.py); the exporter's /traces,
its `vtpu_trace_*` families and `cmd/vtrace.py` assemble them into per-pod
timelines (assemble.py, metrics.py).
"""

from __future__ import annotations

import atexit
import threading
import time

from vtpu_manager_torch.trace import context as _context
from vtpu_manager_torch.trace.context import TraceContext
from vtpu_manager_torch.trace.recorder import (DEFAULT_CAPACITY,
                                               DEFAULT_FLUSH_INTERVAL_S,
                                               Span, SpanRecorder)
from vtpu_manager_torch.util import consts

__all__ = ["TraceContext", "Span", "SpanRecorder", "configure", "reset",
           "is_enabled", "sampling_rate", "recorder", "flush",
           "mint_for_pod", "context_for_pod", "context_for_claim",
           "context_for_uid", "context_from_env", "span", "event",
           "annotation_values"]


class _Config:
    __slots__ = ("service", "rate", "recorder")

    def __init__(self, service: str, rate: float, rec: SpanRecorder):
        self.service = service
        self.rate = rate
        self.recorder = rec


_cfg: _Config | None = None
_atexit_registered = False


def configure(service: str, spool_dir: str | None = None,
              sampling_rate: float = 1.0,
              capacity: int = DEFAULT_CAPACITY,
              flush_interval_s: float = DEFAULT_FLUSH_INTERVAL_S) -> None:
    """Turns tracing on for this process (the commands call it when the
    Tracing gate is on) and starts the flusher: every spool write runs on
    that daemon thread or at exit, never on an instrumented thread. A
    second call replaces the recorder and its flusher; the flush at exit
    is registered once."""
    global _cfg, _atexit_registered
    if _cfg is not None:
        _cfg.recorder.stop_flusher()
    rate = min(1.0, max(0.0, sampling_rate))
    rec = SpanRecorder(service, spool_dir or consts.TRACE_DIR,
                       capacity=capacity)
    _cfg = _Config(service, rate, rec)
    threading.Thread(target=rec.run_flusher, args=(flush_interval_s,),
                     daemon=True, name="vtrace-flush").start()
    if not _atexit_registered:
        atexit.register(flush)
        _atexit_registered = True


def reset() -> None:
    """Turns tracing off (the zero-cost path again)."""
    global _cfg
    if _cfg is not None:
        _cfg.recorder.stop_flusher()
    _cfg = None


def is_enabled() -> bool:
    return _cfg is not None


def sampling_rate() -> float:
    return _cfg.rate if _cfg is not None else 0.0


def recorder() -> SpanRecorder | None:
    return _cfg.recorder if _cfg is not None else None


def flush() -> int:
    return _cfg.recorder.flush() if _cfg is not None else 0


# -- context factories (each None while tracing is off) ---------------------

def mint_for_pod(pod: dict) -> TraceContext | None:
    """The admission-time mint. An unsampled pod gets a context too: the
    decision propagates, so later stages skip alike instead of deciding
    again."""
    if _cfg is None:
        return None
    return _context.mint(pod, _cfg.rate)


def context_for_pod(pod: dict) -> TraceContext | None:
    if _cfg is None:
        return None
    return _context.from_pod(pod)


def context_for_claim(claim: dict) -> TraceContext | None:
    if _cfg is None:
        return None
    return _context.for_claim(claim, _cfg.rate)


def context_for_uid(pod_uid: str) -> TraceContext | None:
    if _cfg is None:
        return None
    return _context.for_uid(pod_uid, _cfg.rate)


def context_from_env(environ: dict | None = None) -> TraceContext | None:
    if _cfg is None:
        return None
    return _context.from_env(environ)


def annotation_values(ctx: TraceContext) -> dict[str, str]:
    """The annotations that carry a context from one process to the next."""
    return {consts.trace_id_annotation(): ctx.trace_id,
            consts.trace_sampled_annotation():
                "true" if ctx.sampled else "false"}


# -- spans ------------------------------------------------------------------

class _NullSpan:
    """The shared no-op context manager of the off and unsampled paths."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("_cfg", "_ctx", "_stage", "_attrs", "_start", "_t0")

    def __init__(self, cfg: _Config, ctx: TraceContext, stage: str,
                 attrs: dict):
        self._cfg = cfg
        self._ctx = ctx
        self._stage = stage
        self._attrs = attrs

    def __enter__(self) -> TraceContext:
        self._start = time.time()
        self._t0 = time.perf_counter()
        return self._ctx

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        attrs = self._attrs
        if exc_type is not None:
            # a failed stage is the span an operator looks for
            attrs = dict(attrs, error=exc_type.__name__)
        self._cfg.recorder.record(Span(
            stage=self._stage, trace_id=self._ctx.trace_id,
            pod_uid=self._ctx.pod_uid, service=self._cfg.service,
            start_s=self._start, dur_s=dur, attrs=attrs))
        return False


def span(ctx: TraceContext | None, stage: str, **attrs):
    """A timed span. Off, unsampled or without a context it is the shared
    null span: no object is made, no clock read."""
    cfg = _cfg
    if cfg is None or ctx is None or not ctx.sampled:
        return _NULL_SPAN
    return _LiveSpan(cfg, ctx, stage, attrs)


def event(ctx: TraceContext | None, stage: str, **attrs) -> None:
    """A zero-duration marker (a tenant's first execute, say)."""
    cfg = _cfg
    if cfg is None or ctx is None or not ctx.sampled:
        return
    cfg.recorder.record(Span(
        stage=stage, trace_id=ctx.trace_id, pod_uid=ctx.pod_uid,
        service=cfg.service, start_s=time.time(), dur_s=0.0, attrs=attrs))
