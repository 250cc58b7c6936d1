"""The node's read side of the step rings: tail them, fold per-pod metrics.

The port of the JAX package's `telemetry/aggregate.py`. The node exporter
owns one `TenantStepTelemetry`. Each scrape calls `scan`, which finds the
rings under the container config root
(`<base>/<entry>/telemetry/step_telemetry.ring`), tails each by its own
cursor and folds the new records into cumulative per-pod histograms: a
Prometheus histogram never goes back, and a ring remembers only its last
RING_CAPACITY steps, so the fold is the record.

Per tenant it derives the throttle-wait fraction and steps per second over
the last window (between the two newest polls), the count of records
overwritten before they were read, and the memory high-water. The node
rollup (the largest throttle-wait fraction, and the memory left under the
high-waters) feeds the exporter's gauges and the pressure annotation
(`telemetry/pressure.py`).

With `comm` on (the exporter's CommTelemetry) the fold also takes the
rings' communication block, which the interposer fills for a tenant that
CommTelemetry armed, into the `vtpu_tenant_comm_*` families; off, none of
them is rendered.
"""

from __future__ import annotations

import logging
import os
import time

from vtpu_manager_torch.telemetry import stepring
from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)

# step + throttle-wait ladder: sub-ms steps up to multi-second ones that
# pay a compile
DURATION_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                      0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# memory high-water ladder: 16 MiB .. 64 GiB (the JAX package's buckets;
# an 80 GB card's top step falls in +Inf)
HBM_BUCKETS_BYTES = tuple(1 << s for s in range(24, 37))
# per-step bytes-moved ladder of the comm block: 1 KiB .. 4 GiB in
# powers of 4
COMM_BUCKETS_BYTES = tuple(1 << s for s in range(10, 33, 2))

STEP_HIST = "vtpu_tenant_step_duration_seconds"
WAIT_HIST = "vtpu_tenant_throttle_wait_seconds"
HBM_HIST = "vtpu_tenant_hbm_highwater_bytes"
WAIT_FRAC = "vtpu_tenant_throttle_wait_fraction"
STEPS_PER_S = "vtpu_tenant_steps_per_second"
DROPS = "vtpu_tenant_step_ring_dropped_total"
INFO = "vtpu_tenant_step_info"
PRESSURE_FRAC = "vtpu_node_pressure_throttle_frac"
PRESSURE_HEADROOM = "vtpu_node_pressure_hbm_headroom_bytes"
# comm-block families (rendered only with `comm` on)
COMM_HIST = "vtpu_tenant_comm_time_seconds"
COMM_BYTES_HIST = "vtpu_tenant_comm_bytes"
COMM_FRAC = "vtpu_tenant_comm_time_fraction"


class _Hist:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.counts[i] += 1
        self.sum += value
        self.count += 1

    def render(self, name: str, labels: str, lines: list[str]) -> None:
        # counts are ALREADY cumulative (observe increments every bucket
        # >= value) — do not sum here like the fresh-per-scrape trace
        # renderer does, that would double-count
        for le, n in zip(self.buckets, self.counts):
            lines.append(f'{name}_bucket{{{labels},le="{le:g}"}} {n}')
        lines.append(f'{name}_bucket{{{labels},le="+Inf"}} {self.count}')
        lines.append(f'{name}_sum{{{labels}}} {round(self.sum, 9):g}')
        lines.append(f'{name}_count{{{labels}}} {self.count}')


class _TenantState:
    """Cumulative fold + last-window derivatives for one ring."""

    __slots__ = ("pod_uid", "container", "trace_id", "cursor", "dropped",
                 "step_hist", "wait_hist", "hbm_hist", "hbm_highwater",
                 "window_frac", "window_rate", "last_poll_monotonic",
                 "primed", "comm_hist", "comm_bytes_hist",
                 "comm_window_frac")

    def __init__(self, pod_uid: str, container: str):
        self.pod_uid = pod_uid
        self.container = container
        self.trace_id = ""
        self.cursor = 0
        self.dropped = 0
        # False until the first poll: history already overwritten before
        # this aggregator ever looked is a baseline, not reader lag —
        # charging it as drops would fire data-loss alerts on every
        # monitor restart
        self.primed = False
        self.step_hist = _Hist(DURATION_BUCKETS_S)
        self.wait_hist = _Hist(DURATION_BUCKETS_S)
        self.hbm_hist = _Hist(HBM_BUCKETS_BYTES)
        self.hbm_highwater = 0
        self.window_frac = 0.0
        self.window_rate = 0.0
        self.last_poll_monotonic = 0.0
        # vtcomm (folded only when the aggregator's comm flag is on):
        # per-step measured comm-time / bytes-moved histograms + the
        # comm fraction of step time over the last window
        self.comm_hist = _Hist(DURATION_BUCKETS_S)
        self.comm_bytes_hist = _Hist(COMM_BUCKETS_BYTES)
        self.comm_window_frac = 0.0

    def fold(self, records: list[stepring.StepRecord], dropped: int,
             now_monotonic: float, comm: bool = False) -> None:
        self.dropped += dropped
        dur_sum = 0.0
        wait_sum = 0.0
        comm_sum = 0.0
        for rec in records:
            dur = rec.duration_ns / 1e9
            wait = rec.throttle_wait_ns / 1e9
            self.step_hist.observe(dur)
            self.wait_hist.observe(wait)
            self.hbm_hist.observe(rec.hbm_highwater_bytes)
            self.hbm_highwater = max(self.hbm_highwater,
                                     rec.hbm_highwater_bytes)
            dur_sum += dur
            wait_sum += wait
            # the ledger's no-signal rule: an all-zero comm block (gate
            # off at the shim, pre-arm, pre-v3 writer) is NOT a
            # measured zero — only comm-carrying records feed the
            # histograms, and a tenant with none stays series-less
            if comm and (rec.comm_time_ns or rec.bytes_transferred
                         or rec.collective_count):
                self.comm_hist.observe(rec.comm_time_ns / 1e9)
                self.comm_bytes_hist.observe(rec.bytes_transferred)
                comm_sum += rec.comm_time_ns / 1e9
        if records:
            # window derivatives from the records themselves, not the
            # poll interval: wall-vs-step time needs no clock agreement
            # with the tenant, and an idle window decays both to 0
            self.window_frac = wait_sum / dur_sum if dur_sum else 0.0
            if comm and self.comm_hist.count:
                # comm-measured tenants only: a window of genuine zero
                # comm decays the gauge, but a never-measured tenant
                # keeps no gauge at all (no signal != measured zero)
                self.comm_window_frac = comm_sum / dur_sum \
                    if dur_sum else 0.0
            if self.last_poll_monotonic:
                window_s = max(now_monotonic - self.last_poll_monotonic,
                               1e-9)
                # dropped records still HAPPENED: a tenant faster than
                # RING_CAPACITY per scrape must not read slower than it
                # is just because the ring lapped
                self.window_rate = (len(records) + dropped) / window_s
        elif self.last_poll_monotonic and now_monotonic \
                - self.last_poll_monotonic > 0:
            self.window_frac = 0.0
            self.window_rate = 0.0
            self.comm_window_frac = 0.0
        self.last_poll_monotonic = now_monotonic


class TenantStepTelemetry:
    """Node-wide scan/fold/render over every tenant's step ring."""

    def __init__(self, base_dir: str = consts.MANAGER_BASE_DIR,
                 comm: bool = False):
        self.base_dir = base_dir
        # vtcomm (CommTelemetry gate): fold + render the comm block's
        # histograms and the comm-fraction gauge. Off (the default) is
        # the gate-off contract — zero vtpu_tenant_comm_* series even
        # though v3 rings carry the (zeroed) block.
        self.comm = comm
        self._tenants: dict[tuple[str, str], _TenantState] = {}

    # -- discovery (same dir shapes as the collector's config join) ---------

    def _ring_paths(self) -> dict[tuple[str, str], str]:
        out: dict[tuple[str, str], str] = {}
        if not os.path.isdir(self.base_dir):
            return out
        for entry in sorted(os.listdir(self.base_dir)):
            ring = os.path.join(self.base_dir, entry,
                                consts.TELEMETRY_SUBDIR,
                                consts.STEP_RING_NAME)
            if not os.path.isfile(ring):
                continue
            pod_uid, _, container = entry.partition("_")
            out[(pod_uid, container)] = ring
        return out

    # -- scrape-path fold ----------------------------------------------------

    def scan(self) -> int:
        """Tail every ring once; tolerate rings appearing, vanishing, or
        being mid-create — a broken ring must cost its own tenant's
        freshness, never the scrape. Returns how many existing rings
        could not be read, so the collector's last-scrape-error flag can
        surface a wedged ring instead of silently serving stale
        series."""
        failed = 0
        now = time.monotonic()
        paths = self._ring_paths()
        # a removed tenant's series go with it (same lifecycle as the
        # per-container limit gauges)
        for key in list(self._tenants):
            if key not in paths:
                del self._tenants[key]
        for key, path in paths.items():
            state = self._tenants.get(key)
            if state is None:
                state = self._tenants[key] = _TenantState(*key)
            try:
                reader = stepring.StepRingReader(path)
            except (OSError, ValueError) as e:
                log.warning("step ring %s unreadable: %s", path, e)
                failed += 1
                continue
            try:
                if reader.trace_id:
                    state.trace_id = reader.trace_id
                records, cursor, dropped = reader.poll(state.cursor)
                state.cursor = cursor
                if not state.primed:
                    state.primed = True
                    dropped = 0
                state.fold(records, dropped, now, comm=self.comm)
            finally:
                reader.close()
        return failed

    # -- outputs -------------------------------------------------------------

    def tenants(self) -> list[_TenantState]:
        return list(self._tenants.values())

    def pressure(self, node_hbm_total: int) -> tuple[float, int]:
        """(max tenant throttle-wait fraction over the last window, HBM
        headroom = node HBM minus the sum of tenant high-waters, floored
        at 0). The scheduler's soft signal: a node whose tenants stall in
        the throttle, or whose high-waters approach physical HBM, scores
        down without ever failing the capacity gate."""
        max_frac = 0.0
        highwater_sum = 0
        for state in self._tenants.values():
            max_frac = max(max_frac, state.window_frac)
            highwater_sum += state.hbm_highwater
        return max_frac, max(0, node_hbm_total - highwater_sum)

    def render(self, node_name: str) -> str:
        lines = [
            f"# HELP {STEP_HIST} Tenant step duration from the step-"
            f"telemetry rings",
            f"# TYPE {STEP_HIST} histogram",
        ]
        tenants = sorted(self._tenants.values(),
                         key=lambda s: (s.pod_uid, s.container))
        for s in tenants:
            labels = (f'node="{node_name}",pod_uid="{s.pod_uid}",'
                      f'container="{s.container}"')
            s.step_hist.render(STEP_HIST, labels, lines)
        lines += [f"# HELP {WAIT_HIST} Time each step stalled in the "
                  f"compute throttle",
                  f"# TYPE {WAIT_HIST} histogram"]
        for s in tenants:
            labels = (f'node="{node_name}",pod_uid="{s.pod_uid}",'
                      f'container="{s.container}"')
            s.wait_hist.render(WAIT_HIST, labels, lines)
        lines += [f"# HELP {HBM_HIST} Per-step HBM high-water",
                  f"# TYPE {HBM_HIST} histogram"]
        for s in tenants:
            labels = (f'node="{node_name}",pod_uid="{s.pod_uid}",'
                      f'container="{s.container}"')
            s.hbm_hist.render(HBM_HIST, labels, lines)
        lines += [f"# HELP {WAIT_FRAC} Fraction of step time stalled in "
                  f"the throttle over the last scrape window",
                  f"# TYPE {WAIT_FRAC} gauge"]
        for s in tenants:
            lines.append(f'{WAIT_FRAC}{{node="{node_name}",'
                         f'pod_uid="{s.pod_uid}",'
                         f'container="{s.container}"}} '
                         f"{round(s.window_frac, 6)}")
        lines += [f"# HELP {STEPS_PER_S} Steps per second over the last "
                  f"scrape window",
                  f"# TYPE {STEPS_PER_S} gauge"]
        for s in tenants:
            lines.append(f'{STEPS_PER_S}{{node="{node_name}",'
                         f'pod_uid="{s.pod_uid}",'
                         f'container="{s.container}"}} '
                         f"{round(s.window_rate, 3)}")
        if self.comm:
            # vtcomm families (gate on only — the off branch renders
            # exactly the pre-v3 text, asserted byte-identical). Only
            # comm-MEASURED tenants get series: an unarmed tenant's
            # zeroed comm pad must not render as "measured zero"
            # (headers stay discoverable, the vttel convention).
            measured = [s for s in tenants if s.comm_hist.count]
            lines += [f"# HELP {COMM_HIST} Measured collective+transfer "
                      f"time inside each step (v3 comm block)",
                      f"# TYPE {COMM_HIST} histogram"]
            for s in measured:
                labels = (f'node="{node_name}",pod_uid="{s.pod_uid}",'
                          f'container="{s.container}"')
                s.comm_hist.render(COMM_HIST, labels, lines)
            lines += [f"# HELP {COMM_BYTES_HIST} Bytes observed moving "
                      f"per step (H2D/D2H transfers + collective "
                      f"payload lower bound)",
                      f"# TYPE {COMM_BYTES_HIST} histogram"]
            for s in measured:
                labels = (f'node="{node_name}",pod_uid="{s.pod_uid}",'
                          f'container="{s.container}"')
                s.comm_bytes_hist.render(COMM_BYTES_HIST, labels, lines)
            lines += [f"# HELP {COMM_FRAC} Fraction of step time spent "
                      f"in measured communication over the last scrape "
                      f"window",
                      f"# TYPE {COMM_FRAC} gauge"]
            for s in measured:
                lines.append(f'{COMM_FRAC}{{node="{node_name}",'
                             f'pod_uid="{s.pod_uid}",'
                             f'container="{s.container}"}} '
                             f"{round(s.comm_window_frac, 6)}")
        lines += [f"# HELP {DROPS} Step records overwritten before the "
                  f"monitor tailed them (reader lagged the ring)",
                  f"# TYPE {DROPS} counter"]
        for s in tenants:
            lines.append(f'{DROPS}{{node="{node_name}",'
                         f'pod_uid="{s.pod_uid}",'
                         f'container="{s.container}"}} {s.dropped}')
        lines += [f"# HELP {INFO} Step-telemetry stream identity; the "
                  f"trace_id label joins the vtrace timeline",
                  f"# TYPE {INFO} gauge"]
        for s in tenants:
            lines.append(f'{INFO}{{node="{node_name}",'
                         f'pod_uid="{s.pod_uid}",'
                         f'container="{s.container}",'
                         f'trace_id="{s.trace_id}"}} 1')
        return "\n".join(lines) + "\n"

    def render_pressure(self, node_name: str, node_hbm_total: int) -> str:
        frac, headroom = self.pressure(node_hbm_total)
        return (
            f"# HELP {PRESSURE_FRAC} Max tenant throttle-wait fraction "
            f"on this node (vttel pressure rollup)\n"
            f"# TYPE {PRESSURE_FRAC} gauge\n"
            f'{PRESSURE_FRAC}{{node="{node_name}"}} {round(frac, 6)}\n'
            f"# HELP {PRESSURE_HEADROOM} Node HBM minus the sum of "
            f"tenant step high-waters\n"
            f"# TYPE {PRESSURE_HEADROOM} gauge\n"
            f'{PRESSURE_HEADROOM}{{node="{node_name}"}} {headroom}\n')


def _quantile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def step_stats_for_pod(base_dir: str, *keys: str) -> list[dict]:
    """Steady-state step stats for one pod, straight off its rings —
    the `vtrace --pod` splice. Any of ``keys`` may match the config-dir
    pod uid or the ring's vtrace trace id (records carry it so the step
    stream and the allocation timeline join on the same key); one
    directory pass serves every key. One ring holds only the last
    RING_CAPACITY steps; the dict says how many of the total that is."""
    out: list[dict] = []
    # empty keys must match NOTHING: rings written without a trace id
    # store "" too, and "" == "" would splice every untraced tenant's
    # steps onto whatever pod was asked about
    wanted = {k for k in keys if k}
    if not wanted or not os.path.isdir(base_dir):
        return out
    for entry in sorted(os.listdir(base_dir)):
        ring_path = os.path.join(base_dir, entry,
                                 consts.TELEMETRY_SUBDIR,
                                 consts.STEP_RING_NAME)
        if not os.path.isfile(ring_path):
            continue
        pod_uid, _, container = entry.partition("_")
        try:
            reader = stepring.StepRingReader(ring_path)
        except (OSError, ValueError):
            continue
        try:
            if not (wanted & {pod_uid, reader.trace_id}):
                continue
            records, head, _ = reader.poll(0)
            durs = sorted(r.duration_ns / 1e9 for r in records)
            waits = [r.throttle_wait_ns / 1e9 for r in records]
            dur_sum = sum(durs)
            row = {
                "pod_uid": pod_uid,
                "container": container,
                "trace_id": reader.trace_id,
                "steps_total": head,
                "steps_resident": len(records),
                "compile_steps": sum(1 for r in records if r.compiled),
                "p50_s": round(_quantile(durs, 0.5), 6),
                "p99_s": round(_quantile(durs, 0.99), 6),
                "throttle_wait_frac": round(
                    sum(waits) / dur_sum, 6) if dur_sum else 0.0,
                "hbm_highwater_bytes": max(
                    (r.hbm_highwater_bytes for r in records), default=0),
            }
            # vtcomm splice: present ONLY when the ring carries a
            # measured comm block (CommTelemetry armed this tenant) —
            # a gate-off ring's zeroed pad adds no keys, so the CLI
            # output stays byte-identical
            comm_ns = sum(r.comm_time_ns for r in records)
            comm_bytes = sum(r.bytes_transferred for r in records)
            collectives = sum(r.collective_count for r in records)
            if comm_ns or comm_bytes or collectives:
                row["comm_time_frac"] = round(
                    comm_ns / 1e9 / dur_sum, 6) if dur_sum else 0.0
                row["comm_bytes_per_step"] = (
                    comm_bytes // len(records)) if records else 0
                row["collectives"] = collectives
            out.append(row)
        finally:
            reader.close()
    return out
