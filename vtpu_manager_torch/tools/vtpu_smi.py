#!/usr/bin/env python3
"""vtpu-smi: the cluster's utilization view, chips x tenants.

The port's copy of the JAX package's `scripts/vtpu_smi.py`. It renders
the exporter's /utilization document (`cmd/device_monitor.py` under the
UtilizationLedger gate): each tenant's quota, live use, throttle wait and
memory high-water, each chip's reclaimable headroom, the node's pressure
and compile-cache state. A tenant's live rows are node-local, so point
--endpoint at the node whose tenants you inspect; quota rows and each
chip's headroom are cluster-wide.

    python -m vtpu_manager_torch.tools.vtpu_smi                # the cluster
    python -m vtpu_manager_torch.tools.vtpu_smi --node node-1  # one node
    python -m vtpu_manager_torch.tools.vtpu_smi --pod trainer-0
    python -m vtpu_manager_torch.tools.vtpu_smi --watch 5      # refresh
    python -m vtpu_manager_torch.tools.vtpu_smi --json         # the document
    python -m vtpu_manager_torch.tools.vtpu_smi --from-file doc.json

--from-file renders a saved document (offline, tests); --token-file sends
the bearer token /metrics takes.

Exit codes: 0 ok, 1 endpoint unreachable / no data, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.parse
import urllib.request


def fetch(endpoint: str, token_file: str | None,
          node: str, pod: str) -> dict:
    url = endpoint
    params = []
    if node:
        params.append(f"node={urllib.parse.quote(node)}")
    if pod:
        params.append(f"pod={urllib.parse.quote(pod)}")
    if params:
        url += ("&" if "?" in url else "?") + "&".join(params)
    req = urllib.request.Request(url)
    if token_file:
        with open(token_file) as f:
            req.add_header("Authorization", f"Bearer {f.read().strip()}")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read().decode())


def _pct(v) -> str:
    return "-" if v is None else f"{v:6.1f}%"


def _gib(v) -> str:
    return "-" if v is None else f"{v / (1 << 30):6.2f}G"


def _conf(row: dict) -> str:
    c = row.get("confidence")
    if c is None:
        return "-"
    if c <= 0.0:
        return "no-signal"
    return f"{c:.2f}"


def render(doc: dict, out=None) -> None:
    out = out or sys.stdout
    cluster = doc.get("cluster") or {}
    local = doc.get("node") or {}
    quota = doc.get("quota")
    market = ""
    if quota is not None:
        market = (f"  market: {quota.get('leases_active', 0)} lease(s) "
                  f"/{quota.get('lent_core_pct_total', 0)}% lent "
                  f"(epoch {quota.get('epoch', 0)})")
    print(f"vtpu-smi  cluster: {cluster.get('nodes', 0)} node(s)  "
          f"{cluster.get('chips', 0)} chip(s)  "
          f"reclaimable {cluster.get('reclaimable_core_pct', 0)}% core  "
          f"({cluster.get('nodes_with_signal', 0)} node(s) reporting)"
          f"{market}",
          file=out)
    # vtovc fleet policy view (overcommit documents only — a gate-off
    # document renders exactly the prior header): per-class ratio
    # spread across publishing nodes + the fleet spill-rate headline
    oc = doc.get("overcommit")
    if oc is not None:
        spread = "  ".join(
            f"{cls} {v['min_ratio']:.2f}-{v['max_ratio']:.2f}x "
            f"on {v['nodes']} node(s)"
            for cls, v in sorted((oc.get("classes") or {}).items()))
        spill = (f"spill {oc.get('fleet_spill_frac_mean', 0) * 100:.1f}%"
                 f" mean/{oc.get('fleet_spill_frac_max', 0) * 100:.1f}% "
                 f"max of steps/"
                 f"{_gib(oc.get('fleet_spilled_bytes', 0)).strip()}")
        print(f"  oversub fleet: {oc.get('nodes_publishing', 0)} "
              f"node(s) publishing"
              + (f"  {spread}" if spread else "") + f"  {spill}",
              file=out)
    # vtslo fleet SLO headline (slo documents only — a gate-off
    # document renders exactly the prior header): fleet goodput plus
    # the attributed-regression count
    slo = doc.get("slo")
    if slo is not None:
        gp = slo.get("goodput_mean")
        gpm = slo.get("goodput_min")
        parts = [f"SLO: {slo.get('tenants_with_signal', 0)}/"
                 f"{slo.get('tenants', 0)} tenant(s) reporting"]
        if gp is not None:
            parts.append(f"goodput {gp * 100:.1f}% mean"
                         + (f"/{gpm * 100:.1f}% min"
                            if gpm is not None else ""))
        parts.append(f"{slo.get('regressions', 0)} attributed "
                     f"regression(s)")
        print("  " + "  ".join(parts), file=out)
    # vtpilot headline (autopilot documents only — a gate-off rollup
    # carries no "autopilot" key, so the prior output is byte-identical)
    ap = doc.get("autopilot")
    if ap is not None:
        parts = [f"AUTOPILOT: {ap.get('actions_last_hour', 0)} "
                 f"action(s) last hour"]
        by = ap.get("by_action") or {}
        if by:
            parts.append("  ".join(f"{name} x{count}"
                                   for name, count in sorted(by.items())))
        last = ap.get("last_action") or {}
        last_act = (last.get("action") or {}).get("action")
        if last_act:
            parts.append(f"last: {last_act} -> "
                         f"{str(last.get('tenant', ''))[:28]}")
        print("  " + "  ".join(parts), file=out)
    # vtheal fleet headline (health documents only — a gate-off rollup
    # carries no "health" key, so the prior output is byte-identical):
    # how many chips the cordon currently holds out, broken down by
    # ladder state, plus how many nodes are publishing the annotation
    health = doc.get("health")
    if health is not None:
        by = health.get("by_state") or {}
        spread = "  ".join(f"{state} x{count}"
                           for state, count in sorted(by.items()))
        print(f"  HEALTH: {health.get('nodes_publishing', 0)} node(s) "
              f"publishing  {health.get('unhealthy_chips', 0)} "
              f"unhealthy chip(s)" + (f"  {spread}" if spread else ""),
              file=out)
    # vtfrag fleet placeability headline (fragmentation documents only
    # — a gate-off rollup carries no "fragmentation" key, so the prior
    # output is byte-identical): how many gangs of each class the fleet
    # could place RIGHT NOW, plus the mean frag score across reporting
    # nodes — free capacity that can't host a box is the whole story
    frag = doc.get("fragmentation")
    if frag is not None:
        gangs = frag.get("placeable_gangs") or {}
        hist = "  ".join(f"{cls}-chip x{count}"
                         for cls, count in sorted(
                             gangs.items(), key=lambda kv: int(kv[0])))
        score = frag.get("fleet_score")
        print(f"  FRAG: {frag.get('nodes_publishing', 0)} node(s) "
              f"publishing  "
              f"score {'-' if score is None else f'{score:.3f}'}  "
              f"{frag.get('free_chips', 0)} free chip(s)"
              + (f"  placeable: {hist}" if hist else ""),
              file=out)
    # vtqm evidence loop (market documents only): per-lease
    # borrowed-vs-used — did the borrower use what it borrowed?
    for bu in (quota or {}).get("borrowed_used") or []:
        used = bu.get("used_of_borrowed_pct")
        util = bu.get("utilization")
        verdict = "no live signal" if used is None else (
            f"used {used}% of {bu.get('pct', 0)}% borrowed "
            f"({util * 100:.0f}%)")
        print(f"  lease {str(bu.get('id', ''))[:12]:<12} "
              f"chip {bu.get('chip', '?')} "
              f"{str(bu.get('borrower', ''))[:28]:<28} {verdict}",
              file=out)
    for err in doc.get("errors") or []:
        print(f"  warning: {err}", file=out)

    for nrow in doc.get("nodes") or []:
        name = nrow.get("node", "?")
        bits = []
        if nrow.get("pressure_frac") is not None:
            bits.append(f"pressure {nrow['pressure_frac']:.2f}")
        # vtovc: oversubscription-ratio line (overcommit documents
        # only — a gate-off document renders exactly the prior table)
        if nrow.get("overcommit_ratio") is not None:
            ratios = nrow.get("overcommit_ratios") or {}
            per_class = ",".join(f"{k}:{r:.2f}x"
                                 for k, r in sorted(ratios.items()))
            bits.append(f"oversub {nrow['overcommit_ratio']:.2f}x"
                        + (f" ({per_class})" if per_class else ""))
        if nrow.get("spill_frac") is not None and (
                nrow["spill_frac"] > 0 or nrow.get("spilled_bytes")):
            bits.append(f"spilling {nrow['spill_frac'] * 100:.0f}% "
                        f"of steps/{_gib(nrow.get('spilled_bytes', 0))}"
                        .strip())
        # vtfrag: per-node FRAG bit (fragmentation documents only — a
        # gate-off document renders exactly the prior line): the frag
        # score plus the largest gang class this node can still host
        if nrow.get("frag_score") is not None:
            classes = nrow.get("frag_classes") or {}
            hosting = [int(c) for c, n in classes.items() if n > 0]
            best = f" best {max(hosting)}-chip" if hosting else ""
            bits.append(f"frag {nrow['frag_score']:.3f} "
                        f"({nrow.get('frag_free_chips', 0)} free{best})")
        if nrow.get("reclaim_core_pct") is not None:
            bits.append(f"reclaimable {nrow['reclaim_core_pct']}%")
        elif nrow.get("headroom_stale"):
            bits.append("headroom STALE (publisher gone)")
        else:
            bits.append("no headroom signal")
        if nrow.get("quota_lent_core_pct") is not None:
            bits.append(f"lent {nrow['quota_lent_core_pct']}% across "
                        f"{nrow.get('quota_leases', 0)} lease(s)")
        # vtcs: warm-keys column (cluster-cache documents only — a
        # gate-off document renders exactly the prior line). Shows how
        # many compiled programs this node can seed the fleet with,
        # naming the hottest few fingerprints.
        if nrow.get("warm_keys") is not None:
            fps = nrow.get("warm_fps") or []
            named = ",".join(fps[:3]) + ("…" if len(fps) > 3 else "")
            bits.append(f"warm {nrow['warm_keys']} key(s)"
                        + (f" [{named}]" if named else ""))
        if nrow.get("local"):
            cache = local.get("compile_cache")
            if cache:
                bits.append(f"cache {cache['entries']} entries/"
                            f"{cache['size_bytes'] / (1 << 20):.0f}M "
                            f"({cache['hits']}h/{cache['misses']}m)")
        print(f"NODE {name}  " + "  ".join(bits), file=out)
        if nrow.get("chips"):
            # VIRT/SPILL columns appear only when the document carries
            # overcommit state (HBMOvercommit on at the monitor) — a
            # gate-off document renders exactly the pre-vtovc table
            show_virt = any(ch.get("virt_hbm_bytes") is not None
                            or ch.get("spilled_bytes") is not None
                            for ch in nrow["chips"])
            oc_hdr = f" {'virt':>8} {'spill':>8}" if show_virt else ""
            # vtheal: HEALTH column appears only when the document
            # carries chip-health state (HealthPlane on at the monitor)
            # — a gate-off document renders exactly the prior table
            show_health = any(ch.get("health") is not None
                              for ch in nrow["chips"])
            health_hdr = f" {'health':>9}" if show_health else ""
            print(f"  {'chip':>4} {'uuid':<20} {'quota':>7} {'used':>7} "
                  f"{'reclaim':>8} {'hbm-reclaim':>11}{oc_hdr}"
                  f"{health_hdr}",
                  file=out)
            for ch in nrow["chips"]:
                extra = ""
                if show_virt:
                    # per-chip spilled bytes are node-local truth (the
                    # vmem ledger); remote chips render "-" like the
                    # other live columns
                    extra = (f" {_gib(ch.get('virt_hbm_bytes')):>8}"
                             f" {_gib(ch.get('spilled_bytes')):>8}")
                if show_health:
                    extra += f" {ch.get('health') or '-':>9}"
                print(f"  {ch.get('index', '?'):>4} "
                      f"{str(ch.get('uuid', ''))[:20]:<20} "
                      f"{_pct(ch.get('alloc_core_pct')):>7} "
                      f"{_pct(ch.get('used_core_pct')):>7} "
                      f"{_pct(ch.get('reclaim_core_pct')):>8} "
                      f"{_gib(ch.get('reclaim_hbm_bytes')):>11}"
                      f"{extra}", file=out)

    # the document's tenant cut already merges cluster quota rows with
    # the node-local ledger rows (rollup.collect), so the ?pod=/?node=
    # filters apply uniformly — no local fallback that would bypass them
    tenants = doc.get("tenants") or []
    if tenants:
        # lent/borrowed columns appear only when the document carries
        # market state (QuotaMarket gate on at the monitor) — a gate-off
        # document renders exactly the pre-market table
        show_market = quota is not None or any(
            t.get("lent_core_pct") is not None
            or t.get("borrowed_core_pct") is not None for t in tenants)
        market_hdr = f" {'lent':>6} {'borrow':>6}" if show_market else ""
        # vtcomm: COMM column (measured comm link-duty + intensity)
        # appears only when the document carries comm state
        # (CommTelemetry on at the monitor) — a gate-off document
        # renders exactly the pre-vtcomm table
        show_comm = any(t.get("comm_duty_frac") is not None
                        for t in tenants)
        comm_hdr = f" {'comm':>11}" if show_comm else ""
        # vtslo: GOODPUT column (useful-compute fraction of the latest
        # attributed window) appears only when the document carries slo
        # state — a gate-off document renders exactly the prior table
        show_slo = any(t.get("goodput_ratio") is not None
                       for t in tenants)
        slo_hdr = f" {'goodput':>8}" if show_slo else ""
        print(f"{'POD':<28} {'container':<12} {'node':<12} {'chip':>4} "
              f"{'quota':>7} {'used':>7} {'wait':>6} {'hbm-hw':>8} "
              f"{'conf':>9}{market_hdr}{comm_hdr}{slo_hdr}", file=out)
        for t in tenants:
            pod = t.get("pod_name") or t.get("pod_uid", "?")
            ns = t.get("pod_namespace", "")
            label = f"{ns}/{pod}" if ns else pod
            wait = t.get("throttle_wait_frac")
            market_cols = ""
            if show_market:
                lent = t.get("lent_core_pct")
                borrowed = t.get("borrowed_core_pct")
                market_cols = (
                    f" {'-' if lent is None else f'{lent}%':>6}"
                    f" {'-' if borrowed is None else f'{borrowed}%':>6}")
            comm_cols = ""
            if show_comm:
                cf = t.get("comm_duty_frac")
                ci = t.get("comm_intensity")
                if cf is None:
                    comm_cols = f" {'-':>11}"
                else:
                    cell = f"{cf * 100:4.1f}%" + (
                        f" x{ci:.2f}" if ci is not None else "")
                    comm_cols = f" {cell:>11}"
            slo_cols = ""
            if show_slo:
                gp = t.get("goodput_ratio")
                slo_cols = (f" {'-':>8}" if gp is None
                            else f" {gp * 100:7.1f}%")
            print(f"{label[:28]:<28} {t.get('container', '')[:12]:<12} "
                  f"{t.get('node', '')[:12]:<12} "
                  f"{t.get('chip_index', '?'):>4} "
                  f"{_pct(t.get('allocated_core_pct')):>7} "
                  f"{_pct(t.get('used_core_pct')):>7} "
                  f"{'-' if wait is None else f'{wait * 100:4.1f}%':>6} "
                  f"{_gib(t.get('hbm_highwater_bytes')):>8} "
                  f"{_conf(t):>9}{market_cols}{comm_cols}{slo_cols}",
                  file=out)
    else:
        print("(no tenant rows)", file=out)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="vtpu-smi", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--endpoint",
                        default="http://127.0.0.1:9394/utilization",
                        help="monitor /utilization URL "
                             "(default: %(default)s)")
    parser.add_argument("--token-file", default=None,
                        help="bearer token for an auth-gated monitor")
    parser.add_argument("--from-file", default=None,
                        help="render a saved /utilization JSON document "
                             "instead of fetching (tests/offline)")
    parser.add_argument("--node", default="",
                        help="restrict to one node's chips/tenants")
    parser.add_argument("--pod", default="",
                        help="restrict tenant rows to one pod "
                             "(name or uid)")
    parser.add_argument("--watch", type=float, default=0.0, metavar="SEC",
                        help="refresh every SEC seconds until interrupted")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="print the raw document")
    args = parser.parse_args(argv)

    if args.watch and args.from_file:
        print("vtpu-smi: --watch needs a live --endpoint, not "
              "--from-file", file=sys.stderr)
        return 2

    def get() -> dict | None:
        if args.from_file:
            try:
                with open(args.from_file) as f:
                    doc = json.load(f)
            except (OSError, ValueError) as e:
                print(f"vtpu-smi: cannot read {args.from_file}: {e}",
                      file=sys.stderr)
                return None
            # apply the cuts the live route would have applied
            from vtpu_manager_torch.utilization.rollup import filter_document
            return filter_document(doc, node=args.node, pod=args.pod)
        try:
            return fetch(args.endpoint, args.token_file, args.node,
                         args.pod)
        except (urllib.error.URLError, OSError, ValueError) as e:
            print(f"vtpu-smi: {args.endpoint}: {e} (is the monitor "
                  f"running with UtilizationLedger=true?)",
                  file=sys.stderr)
            return None

    while True:
        doc = get()
        if doc is None:
            return 1
        if args.as_json:
            print(json.dumps(doc, indent=2))
        else:
            render(doc)
        if not args.watch:
            return 0
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0
        if not args.as_json:
            print("\033[2J\033[H", end="")   # clear between refreshes


if __name__ == "__main__":
    sys.exit(main())
