"""Span spools -> per-stage duration histograms on the exporter's /metrics.

The port of the JAX package's `trace/metrics.py`, rendered fresh from the
node's spools on each scrape. `vtpu_trace_spool_dropped_total` is the
tracer's own health: non-zero means a process's ring dropped spans and
its timelines have holes.
"""

from __future__ import annotations

from vtpu_manager_torch.trace.assemble import read_spools, stage_durations
from vtpu_manager_torch.trace.recorder import Span

# admission/bind stages sit in the low milliseconds; shim startup can
# reach seconds — one bucket ladder covers both ends
BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

HIST_NAME = "vtpu_trace_stage_duration_seconds"
DROP_NAME = "vtpu_trace_spool_dropped_total"


def _fmt(value: float) -> str:
    return f"{value:g}"


def render_spans(spans: list[Span],
                 drops: dict[tuple[str, int], int]) -> str:
    lines = [
        f"# HELP {HIST_NAME} Duration of each vtrace allocation-path "
        f"stage, from the node's span spools",
        f"# TYPE {HIST_NAME} histogram",
    ]
    for stage, durs in sorted(stage_durations(spans).items()):
        cumulative = 0
        for le in BUCKETS_S:
            cumulative = sum(1 for d in durs if d <= le)
            lines.append(f'{HIST_NAME}_bucket{{stage="{stage}",'
                         f'le="{_fmt(le)}"}} {cumulative}')
        lines.append(f'{HIST_NAME}_bucket{{stage="{stage}",le="+Inf"}} '
                     f'{len(durs)}')
        lines.append(f'{HIST_NAME}_sum{{stage="{stage}"}} '
                     f'{_fmt(round(sum(durs), 6))}')
        lines.append(f'{HIST_NAME}_count{{stage="{stage}"}} {len(durs)}')
    lines += [
        f"# HELP {DROP_NAME} Spans dropped by each process's bounded "
        f"ring (nonzero = timelines have holes)",
        f"# TYPE {DROP_NAME} counter",
    ]
    by_service: dict[str, int] = {}
    for (service, _pid), count in drops.items():
        by_service[service] = by_service.get(service, 0) + count
    for service in sorted(by_service):
        lines.append(f'{DROP_NAME}{{service="{service}"}} '
                     f'{by_service[service]}')
    return "\n".join(lines) + "\n"


def render_trace_metrics(spool_dir: str) -> str:
    """One-call render for the monitor's scrape path."""
    spans, drops = read_spools(spool_dir)
    return render_spans(spans, drops)
