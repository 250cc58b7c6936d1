"""vtrace: a pod's allocation-path timeline, from the node's span spools.

    python -m vtpu_manager_torch.cmd.vtrace --pod <uid>          # one pod
    python -m vtpu_manager_torch.cmd.vtrace --list               # every pod
    python -m vtpu_manager_torch.cmd.vtrace --outliers           # slow spans
    python -m vtpu_manager_torch.cmd.vtrace --pod <uid> --json   # as JSON

The port of the JAX package's `scripts/vtrace.py` on the port's
`trace/assemble.py`. It reads the per-process JSONL spools the Tracing gate
writes (`--spool-dir`, default the node trace dir), joins them into
per-pod timelines and prints where the time from admission to the first
step went: each stage's duration and the gaps between stages (queueing,
kubelet's own work, a container's start), which are usually the finding.
Under a pod's timeline come its step rings' statistics (`--steps-dir`,
the containers' config root), its compile-cache outcomes and the
scheduler's headroom events. The JAX report's utilization, SLO and
placement-decision rows belong to planes the port does not have; their
keys are absent from `--json`, and `--explain-dir` is refused.

Exit codes: 0 ok, 1 no matching trace, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys

from vtpu_manager_torch.trace import assemble
from vtpu_manager_torch.util import consts


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1000.0:9.3f}"


def _print_timeline(tl: assemble.Timeline) -> None:
    print(f"pod {tl.pod_uid or '?'}  trace {tl.trace_id or '?'}  "
          f"total {tl.total_s() * 1000.0:.3f} ms "
          f"({len(tl.spans)} spans)")
    print(f"  {'offset ms':>9}  {'dur ms':>9}  {'gap ms':>9}  stage")
    rows = assemble.critical_path(tl)
    slowest = max((row["dur_s"] for row in rows), default=0.0)
    for row in rows:
        marker = "  <- slowest" if (slowest and row["dur_s"] == slowest) \
            else ""
        attrs = ""
        if row["attrs"]:
            attrs = "  " + ",".join(f"{k}={v}"
                                    for k, v in sorted(row["attrs"].items()))
        print(f"  {_fmt_ms(row['offset_s'])}  {_fmt_ms(row['dur_s'])}  "
              f"{_fmt_ms(row['gap_s'])}  {row['stage']}"
              f" [{row['service']}]{attrs}{marker}")
    missing = [s for s in ("webhook.mutate", "scheduler.filter",
                           "scheduler.bind")
               if s not in tl.stages()]
    if missing:
        print(f"  (incomplete: no {', '.join(missing)} span — stage not "
              f"traced in that process, or spool not on this node)")


def compile_cache_rows(tl: assemble.Timeline) -> list[dict]:
    """One row per `shim.compile` span of the timeline, with the outcome
    of its `shim.compile_outcome` event: the nth span of a key pairs with
    the nth outcome of that key, both in start order, since one key
    compiles more than once on a pod's timeline (a miss, then hits)."""
    ordered = sorted(tl.spans, key=lambda s: s.start_s)
    outcomes: dict[str, list[str]] = {}
    for s in ordered:
        if s.stage == "shim.compile_outcome":
            outcomes.setdefault(s.attrs.get("key", ""), []).append(
                s.attrs.get("outcome", "?"))
    rows = []
    for s in ordered:
        if s.stage != "shim.compile":
            continue
        key = s.attrs.get("key", "")
        queue = outcomes.get(key, [])
        rows.append({"key": key,
                     "outcome": queue.pop(0) if queue else "?",
                     "dur_s": s.dur_s, "start_s": s.start_s})
    return rows


def pod_report(tl: assemble.Timeline, steps_dir: str, pod: str) -> dict:
    """The `--pod --json` document."""
    from vtpu_manager_torch.telemetry.aggregate import step_stats_for_pod
    return {"timeline": tl.to_wire(),
            "critical_path": assemble.critical_path(tl),
            "steps": step_stats_for_pod(steps_dir, tl.trace_id,
                                        tl.pod_uid or pod),
            "compile_cache": compile_cache_rows(tl),
            "placement_headroom": [
                {"node": s.attrs.get("node", ""),
                 "signal": s.attrs.get("signal"),
                 "score_input": s.attrs.get("score_input"),
                 "reclaim_core_pct": s.attrs.get("reclaim_core_pct")}
                for s in tl.spans if s.stage == "scheduler.headroom"]}


def _print_pod(tl: assemble.Timeline, doc: dict) -> None:
    _print_timeline(tl)
    for s in doc["steps"]:
        comm = ""
        if "comm_time_frac" in s:
            comm = (f"  comm {s['comm_time_frac'] * 100:.1f}% of step/"
                    f"{s['comm_bytes_per_step']} B/step/"
                    f"{s['collectives']} collective(s)")
        print(f"  steps [{s['container']}]: {s['steps_total']} total "
              f"({s['steps_resident']} resident, "
              f"{s['compile_steps']} compile)  "
              f"p50 {s['p50_s'] * 1000:.3f} ms  "
              f"p99 {s['p99_s'] * 1000:.3f} ms  "
              f"throttle-wait {s['throttle_wait_frac'] * 100:.1f}%"
              f"  hbm-hw {s['hbm_highwater_bytes']}{comm}")
    for c in doc["compile_cache"]:
        hint = ""
        if c["outcome"] == "miss":
            hint = "  <- this tenant compiled; replicas hit"
        print(f"  compile-cache: {c['outcome']} "
              f"({c['dur_s'] * 1000:.3f} ms, key {c['key']})" + hint)
    for h in doc["placement_headroom"]:
        sig = (f"reclaimable {h['reclaim_core_pct']}% core on the node"
               if h.get("signal") else "no headroom signal")
        print(f"  headroom-at-placement [{h['node']}]: {sig} "
              f"(observe-only score input {h['score_input']})")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="vtrace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--spool-dir", default=consts.TRACE_DIR)
    parser.add_argument("--steps-dir", default=consts.MANAGER_BASE_DIR,
                        help="the containers' config root, scanned for "
                        "step rings (default: %(default)s)")
    parser.add_argument("--explain-dir", default=None,
                        help="refused: DecisionExplain is not ported")
    parser.add_argument("--pod", default="",
                        help="pod uid (or trace id) to reconstruct")
    parser.add_argument("--list", action="store_true", dest="list_pods",
                        help="list traced pods with total latency")
    parser.add_argument("--outliers", action="store_true",
                        help="flag spans slower than 3x their stage median")
    parser.add_argument("--outlier-factor", type=float, default=3.0)
    parser.add_argument("--json", action="store_true", dest="as_json")
    args = parser.parse_args(argv)

    if args.explain_dir is not None:
        print("vtrace: --explain-dir: DecisionExplain is not ported yet",
              file=sys.stderr)
        return 2
    if not (args.pod or args.list_pods or args.outliers):
        parser.print_usage(sys.stderr)
        print("vtrace: one of --pod / --list / --outliers required",
              file=sys.stderr)
        return 2

    spans, drops = assemble.read_spools(args.spool_dir)
    timelines = assemble.assemble(spans)
    total_drops = sum(drops.values())
    if total_drops and not args.as_json:
        print(f"warning: {total_drops} span(s) dropped at record time — "
              f"timelines may have holes", file=sys.stderr)

    if args.pod:
        tl = assemble.find_timeline(timelines, args.pod)
        if tl is None:
            print(f"vtrace: no trace for pod {args.pod!r} under "
                  f"{args.spool_dir} ({len(timelines)} pod(s) present)",
                  file=sys.stderr)
            return 1
        doc = pod_report(tl, args.steps_dir, args.pod)
        if args.as_json:
            print(json.dumps(doc, indent=2))
        else:
            _print_pod(tl, doc)
        return 0

    if args.list_pods:
        ordered = sorted(timelines.values(),
                         key=lambda t: t.total_s(), reverse=True)
        if args.as_json:
            print(json.dumps([t.to_wire() for t in ordered], indent=2))
        else:
            print(f"{'total ms':>10}  {'spans':>5}  pod")
            for tl in ordered:
                print(f"{tl.total_s() * 1000.0:10.3f}  "
                      f"{len(tl.spans):5d}  {tl.key()}")
        return 0

    found = assemble.outliers(spans, factor=args.outlier_factor)
    if args.as_json:
        print(json.dumps(found, indent=2))
    else:
        if not found:
            print("no stage-level outliers")
        for row in found:
            print(f"{row['stage']}: {row['dur_s'] * 1000.0:.3f} ms "
                  f"({row['factor']}x the {row['median_s'] * 1000.0:.3f} ms "
                  f"median) pod={row['pod_uid'] or row['trace_id']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
