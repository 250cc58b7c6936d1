"""A tenant under the interposer takes a quota-market lease and a migration
freeze from its config, and the node's tools run on the card: the checks
of chip_smoke.py's `quota_lease` phase.

On a private node (`bench_allocate.Node`: NVML discovery split 5, the
interposer installed with the registrar beside it, the NVML-fed
watcher), the port's device plugin allocates five pods on the card, and
their tenants start together when the phase starts, each held at a go
file once loaded (the lease tenant once warm), so only one check's
tenants run at a time:

- pod-lease, hard 25 % and 8 GiB: the 8192 bf16 quota step plus one
  `vtpu::attn_block` launch per step, each step ending in a readback;
- pod-busy, hard 50 % and 8 GiB: `tools/vtpu_busy.py --duty 100`;
- pod-offload, unmetered, capped at 512 MiB: `tools/host_offload_demo.py`
  over a 1 GiB model in pinned host memory;
- pod-train, throughput class, hard 60 % and 8 GiB: the quota step with a
  sleep after each step that holds it at about 12 % of the card, back to
  back once the check's surge file appears;
- pod-infer, latency-critical, hard 40 % and 8 GiB: the lease tenant's
  step back to back. The market pods are allocated with QuotaMarket
  (their classes stamped from the pods' annotation) and StepTelemetry
  (their step rings, which the market's ledger reads).

Checks, each a record with an `ok` verdict:

1. lease: while the lease tenant runs, its config is rewritten the way
   the quota market's `_reconcile` writes it (`vtpu_manager/quota/
   market.py:410-456`: tmp + rename, `lease_core` and a bumped
   `quota_epoch`): lease +75 (effective 100, the yardstick), +25
   (effective 50), then 0 (a revoke to the base 25). The steps that
   begin more than one quantum (2 ms) and one step after each rename
   make the stage. A stage's share is the card time the tenant's step
   needs, the charge per step of the effective-100 stage (where nothing
   paces it), over the stage's ms per step: both means over their
   stage's steps, so a stage paced at its quota reads its quota however
   much host time the step holds. Each paced stage's share lies within
   `SHARE_BAND` of its effective quota, the revoke's stage included;
   the effective-100 stage, whose share is the step's own demand, spends
   no more than `SHARE_BAND` percent of its time in the throttle wait;
   and the interposer adopted every rewrite of the run
   (`vtpu_quota_reloads_total`, the freeze's two included);
2. freeze: the same run's config is then rewritten with
   `migration_freeze` 1 for `FREEZE_S`, then 0, as the autopilot's
   `set_tenant_freeze` writes it (both epochs bumped). No step begins
   inside the freeze but the one whose launches parked; none ends in it;
   `vtpu_freeze_wait_ns_total` covers the freeze within one quantum, one
   re-read's slack and a step; the parked step's throttle wait is no
   more than the longest of a step at the base rate;
3. tools: `vtpu_busy --duty 100` in the hard-50 pod takes a share within
   `SHARE_BAND` of 50; the host-offload demo under a cap smaller than its
   model finishes, agrees with the same layers on the CPU within
   `OFFLOAD_TOL`, and the most its cap granted at once stays under the
   cap; `vtpu_inspect` run against the node's directories shows the
   lease tenant's current `quota_epoch`, `lease_core` and effective
   percent.

4. market: the earlier pods are gone (their config directories removed,
   as a deleted pod's are). The port's device plugin runs as its `main`
   under MARKET_GATES and Tracing (`DevicePlugin`: its headroom
   publisher, quota market and victim-cost publisher, their defaults),
   and the exporter under UtilizationLedger and QuotaMarket, both on a
   TLS stub API server; the market pods' Allocate was armed in this
   process by the same gates (`cmd/device_plugin.configure_vnum`). A pass
   is seen when its lease summary appears on the node. After
   LEASED_PASSES passes with a lease the check touches the surge file:
   pod-train's demand returns. After every pass it reads both configs,
   the ledger and the lease summary: the card's effective quotas sum to
   at most 100; every lease's lender is pod-train and borrower
   pod-infer; every config carries the ledger's epoch and its deltas; the
   summary decodes to the ledger's active leases. Then: every grant went
   to pod-infer while its bucket bound it (its ring's bucket wait over
   its steps' time, in the window the market's fold read, at least the
   market's threshold); the revoke comes within REVOKE_PASSES passes of
   the surge, as `lender-demand`; pod-infer's interposer adopted every
   rewrite of its config and ends at its base 40; each stage after a
   rewrite (`judge_market`, from pod-infer's first step under the new
   epoch) within `SHARE_BAND` of its effective quota; the victim-cost
   annotation marks pod-infer a borrower while leased and not at the
   publisher's pass after the revoke; /utilization's lease block and
   pod-infer's borrowed column equal the ledger's; both pods' timelines
   hold `quota.grant` and `quota.revoke`; the plugin started each agent,
   failed no pass and exited 0 on SIGTERM. The p99 step, pod-train's
   steps per second and each tenant's bucket wait are reported.

The judging is plain functions of the tenants' records (`judge_lease`,
`judge_freeze`, `judge_market`, `judge_market_run`), which the CPU tests
also feed.

Run `python -m vtpu_manager_torch.bench_quota_lease --tenant ...` only as
the tenant subprocess the phase starts.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from vtpu_manager_torch import build
from vtpu_manager_torch.util import consts

GIB = 2**30
MIB = 2**20
LEASE_POD, BUSY_POD, OFFLOAD_POD = "pod-lease", "pod-busy", "pod-offload"
# pod: (cores %, memory bytes, kubelet's slot)
PODS = {LEASE_POD: (25, 8 * GIB, 0), BUSY_POD: (50, 8 * GIB, 1),
        OFFLOAD_POD: (0, 512 * MIB, 2)}
TRAIN_POD, INFER_POD = "pod-train", "pod-infer"
# the market's pods: (cores %, memory bytes, kubelet's slot, class)
MARKET_PODS = {
    TRAIN_POD: (60, 8 * GIB, 3, consts.WORKLOAD_CLASS_THROUGHPUT),
    INFER_POD: (40, 8 * GIB, 4, consts.WORKLOAD_CLASS_LATENCY_CRITICAL)}
# the card's split: a slot for every pod of the phase
SPLIT = len(PODS) + len(MARKET_PODS)
# what pod-train takes of the card while its demand is low, the
# reference's scenario (scripts/bench_quotamarket.py:6-10)
TRAIN_DUTY = 12.0
# the market's passes with a lease before pod-train's demand returns
LEASED_PASSES = 3
# the node's gates while the market runs: the plugin's (which arm Allocate
# and start the ledgers' agents) and the exporter's
MARKET_GATES = "StepTelemetry=true,UtilizationLedger=true,QuotaMarket=true"
EXPORTER_GATES = "UtilizationLedger=true,QuotaMarket=true"
# the longest the market check waits for a grant, for the revoke after
# the surge and for the victim-cost publisher's pass after it
GRANT_WAIT_S = 20.0
REVOKE_PASSES = 2
PUBLISH_WAIT_S = 20.0
AFTER_REVOKE_S = 3.0
BASE = PODS[LEASE_POD][0]
# (lease_core, effective percent) in the order the market writes them
STAGES = ((75, 100), (25, 50), (0, 25))
BASE_S = 1.0          # the tenant at its base before the first rewrite
STAGE_S = 2.5         # each lease stage
FREEZE_S = 1.0
AFTER_S = 0.5         # after the unfreeze
SHARE_BAND = 15.0
QUANTUM_S = 0.002     # the interposer's re-read quantum
# what the reference's reclaim bound allows beyond one quantum for the
# re-read and the host's scheduling (scripts/bench_quotamarket.py:444)
REREAD_SLACK_S = 0.023
BUSY_S = 4.0
OFFLOAD_ARGS = ("--layers", "8", "--width", "8192", "--batch", "64",
                "--check")
OFFLOAD_TOL = 3e-2    # bf16: a few of its ulps at 1.0 after 8 layers
TENANT_TIMEOUT_S = 240.0
RING_STEPS = 256      # a step ring's records (telemetry/stepring.py)
WARMUP = 5


# --- the market's and the migrator's writes ---------------------------------

def rewrite(path: str, *, lease: int | None = None,
            freeze: bool | None = None) -> dict:
    """One generation of the tenant's config, written as the quota market
    (a lease: `lease_core` on every device) or the migrator (a freeze:
    `migration_freeze`, `freeze_epoch` bumped) writes it: `quota_epoch`
    bumped, tmp + rename. Returns the rename's CLOCK_MONOTONIC ns and the
    generation's fields."""
    from vtpu_manager_torch.config import vtpu_config as vc
    cfg = vc.read_config(path)
    if lease is not None:
        for dev in cfg.devices:
            dev.lease_core = lease
    if freeze is not None:
        cfg.migration_freeze = 1 if freeze else 0
        cfg.freeze_epoch += 1
    cfg.quota_epoch += 1
    vc.write_config(path, cfg)
    return {"t_ns": time.monotonic_ns(), "epoch": cfg.quota_epoch,
            "lease": cfg.devices[0].lease_core if cfg.devices else 0,
            "freeze": cfg.migration_freeze}


def drive(cfg_path: str, go_file: str, stop_file: str,
          stages=STAGES, freeze: bool = True, base_s: float = BASE_S,
          stage_s: float = STAGE_S, freeze_s: float = FREEZE_S,
          after_s: float = AFTER_S) -> dict:
    """Starts the held tenant, rewrites its config stage by stage while it
    runs, then stops it. Returns the renames (`stages`, `freeze`,
    `unfreeze`)."""
    Path(go_file).touch()
    time.sleep(base_s)
    out: dict = {"stages": []}
    for lease, effective in stages:
        out["stages"].append({**rewrite(cfg_path, lease=lease),
                              "effective": effective})
        time.sleep(stage_s)
    if freeze:
        out["freeze"] = rewrite(cfg_path, freeze=True)
        time.sleep(freeze_s)
        out["unfreeze"] = rewrite(cfg_path, freeze=False)
        time.sleep(after_s)
    out["end_ns"] = time.monotonic_ns()
    Path(stop_file).touch()
    return out


# --- judging ----------------------------------------------------------------

def stage_rate(steps: list, start_ns: int, end_ns: int,
               settle_ns: int) -> dict:
    """The steps that begin `settle_ns` after `start_ns` and end by
    `end_ns`: how many, their ms per step (first start to last end over
    the count), their median, 90th- and 99th-percentile step, and, from the
    interposer's totals each step carries, the charge per step and the
    share of the stage's time spent in the throttle wait."""
    idx = [i for i, s in enumerate(steps) if s[0] >= start_ns + settle_ns
           and s[1] <= end_ns]
    if not idx:
        return {"n": 0, "ms_per_step": None}
    inside = steps[idx[0]:idx[-1] + 1]
    wall = inside[-1][1] - inside[0][0]
    durs = sorted((s[1] - s[0]) / 1e6 for s in inside)
    out = {"n": len(inside), "ms_per_step": wall / len(inside) / 1e6,
           "median_ms": durs[len(durs) // 2],
           "p90_ms": durs[int(0.9 * (len(durs) - 1))],
           "p99_ms": durs[int(0.99 * (len(durs) - 1))]}
    if idx[0] > 0 and len(inside[-1]) > 4:
        before = steps[idx[0] - 1]
        out["charged_ms_per_step"] = (
            (inside[-1][4] - before[4]) / len(inside) / 1e6)
        out["wait_share"] = 100.0 * (inside[-1][2] - before[2]) / wall
    return out


# the interposer's counters a lease record carries
RUN_COUNTERS = ("vtpu_sampled_launches_total", "vtpu_probes_total",
                "vtpu_obs_overhead_ns", "vtpu_gap_bypass_total",
                "vtpu_throttle_wait_ns_total", "vtpu_clocked_total",
                "vtpu_windows_total", "vtpu_launches_total")


def judge_market(infer: dict, rewrites: list[dict], yard_ms: float | None,
                 end_ns: int, surge_ns: int | None = None,
                 band: float = SHARE_BAND) -> dict:
    """pod-infer's stages under the market: the static split before the
    first rewrite of its config, then one stage per rewrite (`rewrites`,
    each with the `effective` percent it wrote and `adopted_ns`, the
    CLOCK_MONOTONIC end of pod-infer's first step that ran under its
    epoch, as the interposer reports it after each step), each of the
    steps that begin after that step (every one of them began after the
    interposer had adopted the rewrite) and end by the next rewrite's
    pass (`pass_ns`, before its rename). pod-train's surge (`surge_ns`)
    ends the stage it falls in: from then to the revoke's adoption the
    lender takes its lent-down quota back on a card whose quotas sum to
    100, which the market answers with the revoke; that stretch
    (`surge`) is reported. A stage's share is the lease check's yardstick
    (the charge per step of the same step unpaced) over its ms per step.
    Every stage after a rewrite lies within `band` of its effective
    percent (a rewrite never adopted fails); the static one and the surge
    are reported, with each stage's p99 step."""
    steps = infer["steps"]
    # (start, when the stage before it ends, effective %, judged)
    marks = [(steps[0][0] if steps else 0, None, MARKET_PODS[INFER_POD][0],
              False)]
    unadopted = [r for r in rewrites if r.get("adopted_ns") is None]
    marks += [(r["adopted_ns"], r.get("pass_ns") or r["adopted_ns"],
               r["effective"], True) for r in rewrites
              if r.get("adopted_ns") is not None]
    if surge_ns is not None:
        eff = max((m for m in marks if m[0] <= surge_ns),
                  key=lambda m: m[0])[2]
        marks.append((surge_ns, surge_ns, eff, False))
        marks.sort(key=lambda m: m[0])
    # a stage ends where the next one's pass began (the rename after it)
    ends = [m[1] for m in marks[1:]] + [end_ns]
    stages = []
    for i, (at, _, eff, judged) in enumerate(marks):
        r = stage_rate(steps, at, ends[i], 0)
        ms = r["ms_per_step"]
        r["share"] = 100.0 * yard_ms / ms if yard_ms and ms else None
        r["effective"] = eff
        r["surge"] = not judged and i > 0
        r["ok"] = not judged or (r["share"] is not None
                                 and abs(r["share"] - eff) <= band)
        stages.append(r)
    return {"stages": stages, "unadopted": [r["epoch"] for r in unadopted],
            "ok": not unadopted and all(s["ok"] for s in stages)}


def in_flight_ns(steps: list, t_ns: int) -> int:
    """How long the step in flight at `t_ns` took (0 when none was): the
    step that began before a rename ends at the old rate."""
    return next((s[1] - s[0] for s in steps if s[0] <= t_ns < s[1]), 0)


def judge_lease(run: dict, marks: dict, band: float = SHARE_BAND) -> dict:
    """Each stage's share of the card, from the steps that begin one
    quantum and the step in flight after its rename: the step's card
    time, the effective-100 stage's charge per step, over the stage's ms
    per step. The bucket paces the charge, so a paced stage reads its
    effective quota whatever host time the step holds (its
    `card_share`, the stage's own charge over its time, is printed
    beside); the effective-100 stage reads the step's own demand, and
    is held to an unpaced bucket by its throttle wait."""
    steps = run["steps"]
    bounds = [m["t_ns"] for m in marks["stages"]]
    bounds.append(marks["freeze"]["t_ns"] if "freeze" in marks
                  else marks["end_ns"])
    stages = []
    for i, m in enumerate(marks["stages"]):
        settle = int(QUANTUM_S * 1e9) + in_flight_ns(steps, bounds[i])
        r = stage_rate(steps, bounds[i], bounds[i + 1], settle)
        stages.append({"lease": m["lease"], "effective": m["effective"],
                       "epoch": m["epoch"], "settle_ms": settle / 1e6, **r})
    yard = next((s.get("charged_ms_per_step") for s in stages
                 if s["effective"] == 100 and s["n"]), None)
    for s in stages:
        ms, own = s["ms_per_step"], s.get("charged_ms_per_step")
        s["share"] = 100.0 * yard / ms if yard and ms else None
        s["card_share"] = 100.0 * own / ms if own and ms else None
        if s["effective"] >= 100:
            s["ok"] = s["share"] is not None and s["wait_share"] <= band
        else:
            s["ok"] = s["share"] is not None and abs(
                s["share"] - s["effective"]) <= band
    rewrites = len(marks["stages"]) + ("freeze" in marks) + (
        "unfreeze" in marks)
    last = marks.get("unfreeze") or marks["stages"][-1]
    rec = {"stages": stages, "rewrites": rewrites,
           "reloads": run.get("vtpu_quota_reloads_total"),
           "epoch": run.get("vtpu_quota_epoch"), "last_epoch": last["epoch"],
           "attn_block_launches": run.get("attn_block_launches"),
           "steps": len(steps),
           "counters": {k: run.get(k) for k in RUN_COUNTERS}}
    # a replayed graph launches the kernel without its wrapper
    launched = run.get("graph") or (rec["attn_block_launches"] or 0) >= len(
        steps) > 0
    rec["ok"] = bool(yard and all(s["ok"] for s in stages)
                     and rec["reloads"] == rewrites
                     and rec["epoch"] == rec["last_epoch"] and launched)
    return rec


def judge_freeze(run: dict, marks: dict) -> dict:
    """What the steps and the counters show between the freeze's rename
    and the unfreeze's, against the steps of the stage before it (the
    base rate): no step began after the freeze was adopted (one quantum
    and a step after its rename) but the one that parked at its next
    launch, and none ended inside it; the freeze wait covers the freeze;
    the parked step's throttle wait is a step's, not the freeze's."""
    steps = run["steps"]
    f, u = marks["freeze"]["t_ns"], marks["unfreeze"]["t_ns"]
    last = marks["stages"][-1]["t_ns"] if marks["stages"] else 0
    base = [s for s in steps if s[0] >= last and s[1] <= f]
    durs = sorted(s[1] - s[0] for s in base)
    one_step = durs[len(durs) // 2] if durs else 0
    adopt = f + int(QUANTUM_S * 1e9) + one_step
    began = [s for s in steps if adopt < s[0] < u]
    ended = [s for s in steps if adopt < s[1] < u]
    parked = [i for i, s in enumerate(steps) if s[0] <= u <= s[1]]
    held_s = (u - f) / 1e9
    freeze_wait_s = run.get("vtpu_freeze_wait_ns_total", 0) / 1e9
    slack_s = QUANTUM_S + REREAD_SLACK_S + one_step / 1e9
    waits = [s[2] - b[2] for b, s in zip(base, base[1:])]
    rec = {"held_s": held_s, "freeze_wait_s": freeze_wait_s,
           "slack_s": slack_s, "began_inside": len(began),
           "ended_inside": len(ended), "step_ms": one_step / 1e6,
           "max_throttle_wait_ms": max(waits, default=0) / 1e6}
    if parked and parked[0] > 0:
        p, b = steps[parked[0]], steps[parked[0] - 1]
        rec.update(parked_step_ms=(p[1] - p[0]) / 1e6,
                   parked_throttle_wait_ms=(p[2] - b[2]) / 1e6,
                   parked_freeze_wait_ms=(p[3] - b[3]) / 1e6)
    rec["ok"] = bool(
        len(began) <= 1 and not ended and "parked_step_ms" in rec
        and abs(freeze_wait_s - held_s) <= slack_s
        and rec["parked_freeze_wait_ms"] >= 1000 * (held_s - slack_s)
        and rec["parked_throttle_wait_ms"]
        <= rec["max_throttle_wait_ms"] + 1.0)
    return rec


def inspect_shows(text: str, cfg) -> dict:
    """Whether `vtpu_inspect`'s dump lists the tenant whose config is `cfg`
    with its current generation and its device's lease."""
    from vtpu_manager_torch import quota
    dev = cfg.devices[0]
    want = [f"quota: epoch={cfg.quota_epoch} class={cfg.workload_class} "
            f"freeze={cfg.migration_freeze} "
            f"freeze_epoch={cfg.freeze_epoch}",
            f"dev[{dev.host_index}] lease={dev.lease_core:+d} effective="
            f"{quota.effective_core(dev.hard_core, dev.lease_core)}"]
    block, inside = [], False
    for line in text.splitlines():
        if line.startswith(f"  {cfg.pod_uid}_"):
            inside = True
        elif inside and not line.startswith("    "):
            break
        elif inside:
            block.append(line.strip())
    return {"block": block, "want": want,
            "ok": all(w in block for w in want)}


# --- the phase --------------------------------------------------------------

class Phase:
    def __init__(self, torch, shim: str, root: str):
        from vtpu_manager_torch import bench_allocate as ba
        from vtpu_manager_torch import bench_quota as bq
        self.torch = torch
        self.root = Path(root)
        self.node = ba.Node(root, shim, split=SPLIT)
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")
        self.resp = {pod: self._allocate(pod)
                     for pod in (*PODS, *MARKET_PODS)}
        self.tenants: dict = {}
        self.go = {pod: str(self.root / f"{pod}.go") for pod in PODS}
        self.stop_file = str(self.root / "lease.stop")
        self.market_go = str(self.root / "market.go")
        self.surge_file = str(self.root / "market.surge")
        self.market_stop = str(self.root / "market.stop")
        # every tenant starts now, each held at its go file
        self.tenants[LEASE_POD] = bq.Tenant(
            LEASE_POD, ["-m", "vtpu_manager_torch.bench_quota_lease",
                        "--tenant", "lease", "--go-file", self.go[LEASE_POD],
                        "--stop-file", self.stop_file],
            self._env(LEASE_POD), str(self.root))
        for pod, tool, args in (
                (BUSY_POD, "vtpu_busy",
                 ("--duty", "100", "--seconds", str(BUSY_S),
                  "--report-every", "1")),
                (OFFLOAD_POD, "host_offload_demo", OFFLOAD_ARGS)):
            self.tenants[pod] = bq.Tenant(
                pod, ["-m", "vtpu_manager_torch.bench_quota_lease",
                      "--tenant", "tool", "--go-file", self.go[pod], "--",
                      f"vtpu_manager_torch.tools.{tool}", *args],
                self._env(pod), str(self.root))
        # the market's pods, loaded now and held at one go file
        self.tenants[TRAIN_POD] = bq.Tenant(
            TRAIN_POD, ["-m", "vtpu_manager_torch.bench_quota_lease",
                        "--tenant", "train", "--go-file", self.market_go,
                        "--busy-file", self.surge_file,
                        "--stop-file", self.market_stop],
            self._env(TRAIN_POD), str(self.root))
        self.tenants[INFER_POD] = bq.Tenant(
            INFER_POD, ["-m", "vtpu_manager_torch.bench_quota_lease",
                        "--tenant", "lease", "--go-file", self.market_go,
                        "--stop-file", self.market_stop],
            self._env(INFER_POD), str(self.root))
        self.run: dict | None = None
        self.marks: dict | None = None
        self.lease_rec: dict | None = None

    def _allocate(self, pod: str):
        """The pod's Allocate; a market pod's under MARKET_GATES, as
        `cmd/device_plugin.main` arms it: its workload class stamped
        (QuotaMarket) and its step ring armed (StepTelemetry), which the
        market's ledger reads."""
        from vtpu_manager_torch import bench_allocate as ba
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import device_id
        market = pod in MARKET_PODS
        cores, memory, slot, *cls = (MARKET_PODS if market else PODS)[pod]
        self.node.client.add_pod(ba.committed_pod(
            pod, self.chip, cores, memory,
            annotations={consts.workload_class_annotation(): cls[0]}
            if market else None))
        plugin = self.node.plugin(market, MARKET_GATES if market else "")
        (resp,) = plugin.allocate(api.AllocateRequest(
            [api.ContainerAllocateRequest([device_id(self.chip.uuid, slot)])]
        )).container_responses
        return resp

    def _env(self, pod: str) -> dict:
        from vtpu_manager_torch import bench_allocate as ba
        env = ba.container_env(self.resp[pod])
        env["VTPU_LOGGER_LEVEL"] = "2"     # grants, revokes, the freeze
        return env

    def config_path(self, pod: str) -> str:
        from vtpu_manager_torch import bench_allocate as ba
        return ba.host_path(self.resp[pod], consts.CONTAINER_CONFIG)

    def close(self) -> None:
        for path in (*self.go.values(), self.stop_file, self.market_go,
                     self.market_stop):
            Path(path).touch()
        for t in self.tenants.values():
            try:
                t.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass          # stop() kills it
            t.stop()
        self.node.close()

    def _lease_run(self) -> None:
        if self.run is not None:
            return
        for t in self.tenants.values():
            t.line("READY", TENANT_TIMEOUT_S)
        tenant = self.tenants[LEASE_POD]
        self.marks = drive(self.config_path(LEASE_POD), self.go[LEASE_POD],
                           self.stop_file)
        self.run = tenant.line("STEPS ", TENANT_TIMEOUT_S)
        self.run["rc"] = tenant.proc.wait(timeout=60)
        text = open(tenant.err_path).read()
        self.run["log"] = [ln for ln in text.splitlines()
                           if "quota lease" in ln or "freeze" in ln
                           or "parked" in ln or "released" in ln]
        self.run["suspect_horizons"] = text.count("horizon suspect")

    def check_lease(self) -> dict:
        self._lease_run()
        rec = judge_lease(self.run, self.marks)
        self.lease_rec = rec
        rec["rc"] = self.run["rc"]
        rec["log"] = self.run["log"]
        rec["suspect_horizons"] = self.run["suspect_horizons"]
        rec["ok"] = rec["ok"] and rec["rc"] == 0
        return rec

    def check_freeze(self) -> dict:
        self._lease_run()
        return judge_freeze(self.run, self.marks)

    def check_tools(self) -> dict:
        from vtpu_manager_torch import bench_allocate as ba
        from vtpu_manager_torch.config import vtpu_config as vc
        self._lease_run()
        out: dict = {}
        busy = self.tenants[BUSY_POD]
        Path(self.go[BUSY_POD]).touch()
        b = busy.line("VTPU_BUSY ", TENANT_TIMEOUT_S)
        b["rc"] = busy.proc.wait(timeout=60)
        b["ok"] = (b["rc"] == 0 and b["device"] != "cpu"
                   and abs(b["effective_pct"] - PODS[BUSY_POD][0])
                   <= SHARE_BAND)
        out["busy"] = b
        demo = self.tenants[OFFLOAD_POD]
        Path(self.go[OFFLOAD_POD]).touch()
        d = demo.line("HOST_OFFLOAD ", TENANT_TIMEOUT_S)
        d["rc"] = demo.proc.wait(timeout=60)
        cap = PODS[OFFLOAD_POD][1]
        d["cap_bytes"] = cap
        d["ok"] = (d["rc"] == 0 and d["finite"] and d["pinned"]
                   and d["model_bytes"] > cap
                   and d["interposer_peak_bytes"] is not None
                   and 0 < d["interposer_peak_bytes"] <= cap
                   and d["max_abs_err"] <= OFFLOAD_TOL)
        out["offload"] = d
        # the market leaves the tenant a lease after its run: what the
        # operator's dump shows is the file's current generation
        path = self.config_path(LEASE_POD)
        rewrite(path, lease=STAGES[1][0])
        cfg = vc.read_config(path)
        res = subprocess.run(
            [sys.executable, "-m", "vtpu_manager_torch.tools.vtpu_inspect",
             "--base", self.node.base_dir,
             "--vmem", os.path.join(self.node.vmem_dir, os.path.basename(
                 consts.VMEM_NODE_CONFIG)),
             "--tc", os.path.join(self.node.watcher_dir, os.path.basename(
                 consts.TC_UTIL_CONFIG))],
            cwd=str(build.REPO), env={k: v for k, v in os.environ.items()
                                      if k != consts.ENV_LD_PRELOAD},
            capture_output=True, text=True, timeout=60)
        shows = inspect_shows(res.stdout, cfg)
        shows["rc"] = res.returncode
        shows["ok"] = shows["ok"] and res.returncode == 0
        out["inspect"] = shows
        out["ok"] = all(out[k]["ok"] for k in ("busy", "offload", "inspect"))
        return out


    # --- 4. the market ---------------------------------------------------

    def _market_node(self):
        """The node's API server (a TLS stub) with the service account a
        pod's agent reaches it with, the device plugin's `main` under
        MARKET_GATES (and Tracing, for the market's audit), and the
        exporter under UtilizationLedger and QuotaMarket, both on that
        server."""
        import shutil

        from vtpu_manager_torch.bench_cluster import CERTS
        from vtpu_manager_torch.bench_monitor import Exporter, TOKEN
        from vtpu_manager_torch.client.apistub import ApiStub
        from vtpu_manager_torch.bench_allocate import NODE
        stub = ApiStub(str(CERTS / "server.crt"), str(CERTS / "server.key"),
                       token=TOKEN)
        stub.store.add_node({"metadata": {"name": NODE, "annotations": {}}})
        stub.start()
        sa = self.root / "serviceaccount"
        sa.mkdir(exist_ok=True)
        (sa / "token").write_text(TOKEN)
        shutil.copy(CERTS / "ca.crt", sa / "ca.crt")
        node_config = self.root / "node-config.json"
        node_config.write_text(json.dumps({"default": {
            "deviceSplitCount": SPLIT}}))
        api = {"KUBERNETES_SERVICE_HOST": "127.0.0.1",
               "KUBERNETES_SERVICE_PORT": stub.url.rsplit(":", 1)[1]}
        plugin = exporter = None
        try:
            plugin = DevicePlugin(self.root, self.node, str(node_config),
                                  str(sa), MARKET_GATES + ",Tracing=true",
                                  api)
            exporter = Exporter(
                self.root, self.node, str(self.root / "no-checkpoint"),
                str(node_config), gates=EXPORTER_GATES,
                tag="market-exporter",
                extra=("--service-account-dir", str(sa)), env_extra=api)
        except BaseException:
            for p in (plugin, exporter):
                if p is not None:
                    p.close()
            stub.stop()
            raise
        return stub, plugin, exporter

    def _market_state(self, util, stub, raw: str, now: float) -> dict:
        """What one pass left, read when its lease summary appears: each
        market pod's config, the lease ledger, the card's sum of effective
        percents over the resident configs, the summary (whose stamp is
        the wall time of the pass's fold) and this check's own fold of the
        utilization ledger (its own cursors: the market's lives in the
        plugin)."""
        import math

        from vtpu_manager_torch import quota
        from vtpu_manager_torch.config import vtpu_config as vc
        from vtpu_manager_torch.util import stalecodec
        view = quota.QuotaLeaseLedger(self.node.base_dir).snapshot(now)
        cfgs = {}
        for pod in MARKET_PODS:
            cfg = vc.read_config(self.config_path(pod))
            cfgs[pod] = {"epoch": cfg.quota_epoch,
                         "lease": cfg.devices[0].lease_core,
                         "effective": quota.effective_core(
                             cfg.devices[0].hard_core,
                             cfg.devices[0].lease_core)}
        per_chip: dict = {}
        for lease in view.active:
            c = per_chip.setdefault(int(lease["chip"]),
                                    {"lent_core_pct": 0, "leases": 0})
            c["lent_core_pct"] += int(lease["pct"])
            c["leases"] += 1
        util.fold()
        folded = {}
        for t in util.tenants():
            folded[t.pod_uid] = {
                "used": t.used_ewma, "wait_frac": t.wait_frac,
                "envelope": t.used_ewma + 2.0 * math.sqrt(max(t.used_var,
                                                              0.0)),
                "reclaim": t.reclaim_core_pct(now), "source": t.used_source}
        stamp = stalecodec.split_stamp(raw)
        return {"now": now, "mono_ns": time.monotonic_ns(),
                "fold_wall": stamp[1] if stamp else None,
                "configs": cfgs, "epoch": view.epoch,
                # tenant -> its net lease (the phase's pods are on one
                # card)
                "deltas": {k[0]: v for k, v in view.deltas.items()},
                "leases": [dict(l) for l in view.leases],
                "active": len(view.active),
                "sum_effective": quota.sum_effective_by_chip(
                    self.node.base_dir),
                "annotation": raw,
                "annotation_ok": quota.parse_lease_summary(raw, now=now)
                == per_chip,
                "util": folded}

    def check_market(self) -> dict:
        """The node's quota market on the card: the device plugin's `main`
        under MARKET_GATES starts the headroom publisher, the market (its
        defaults: a pass every 5 s, steps of 10 %, at most 40 % borrowed,
        leases of 30 s) and the victim-cost publisher over pod-train
        (throughput, hard 60, about 12 % of the card) and pod-infer
        (latency-critical, hard 40, back to back); after LEASED_PASSES
        passes with a lease, pod-train's demand returns, and the market
        takes the lease back. A pass is seen when its lease summary
        appears on the node (every pass publishes one, stamped with the
        pass's time); pod-infer's step ring is tailed for the grants'
        verdict."""
        import inspect
        import shutil

        from vtpu_manager_torch import bench_allocate as ba
        from vtpu_manager_torch import quota
        from vtpu_manager_torch.quota import victimcost
        from vtpu_manager_torch.trace import assemble
        from vtpu_manager_torch.utilization import UtilizationLedger
        self._lease_run()
        # the earlier checks' pods are gone: their tenants have exited, and
        # their config directories go as a deleted pod's do
        for pod in PODS:
            shutil.rmtree(os.path.dirname(os.path.dirname(
                self.config_path(pod))), ignore_errors=True)
        interval_s = inspect.signature(quota.QuotaMarketManager).parameters[
            "interval_s"].default
        util = UtilizationLedger(
            self.node.name, [self.chip], base_dir=self.node.base_dir,
            tc_path=os.path.join(self.node.watcher_dir, os.path.basename(
                consts.TC_UTIL_CONFIG)))
        tail = ba.RingTail(self._env(INFER_POD)[consts.ENV_STEP_RING_PATH])
        stub, plugin, exporter = self._market_node()
        states, published, docs = [], [], []
        marks: dict = {"mono_minus_wall_ns": time.monotonic_ns()
                       - time.time_ns(), "interval_s": interval_s}
        try:
            Path(self.market_go).touch()
            t0 = time.monotonic()
            seen_lease = seen_ann = None
            while True:
                now_s = time.monotonic() - t0
                anns = stub.store.get_node(self.node.name)["metadata"][
                    "annotations"]
                raw = anns.get(consts.node_quota_lease_annotation())
                if raw and raw != seen_lease:
                    seen_lease = raw
                    st = self._market_state(util, stub, raw, time.time())
                    st["passes"] = len(states) + 1
                    states.append(st)
                    if st["active"] and "utilization" not in marks:
                        docs.append(exporter.get("/utilization"))
                        marks["utilization"] = st["epoch"]
                    leased = sum(1 for x in states if x["active"])
                    if leased == LEASED_PASSES and "surge_at" not in marks:
                        # the last lease stage runs half a pass with the
                        # lender idle before its demand returns
                        marks["surge_at"] = (time.monotonic()
                                             + interval_s / 2)
                    if any(l["state"] == quota.STATE_REVOKED
                           for l in st["leases"]) and "revoke" not in marks:
                        marks["revoke"] = {"pass": len(states),
                                           "mono_ns": st["mono_ns"]}
                if "surge_at" in marks and "surge" not in marks and \
                        time.monotonic() >= marks["surge_at"]:
                    Path(self.surge_file).touch()
                    marks["surge"] = {"pass": len(states),
                                      "mono_ns": time.monotonic_ns()}
                raw = anns.get(consts.node_victim_cost_annotation())
                if raw and raw != seen_ann:
                    seen_ann = raw
                    published.append({
                        "raw": raw, "after_revoke": "revoke" in marks,
                        "leased": bool(states and states[-1]["active"])})
                revoked = marks.get("revoke")
                if revoked and published[-1:] and \
                        published[-1]["after_revoke"] and \
                        time.monotonic_ns() - revoked["mono_ns"] > \
                        AFTER_REVOKE_S * 1e9:
                    break
                if (not any(x["active"] for x in states)
                        and now_s > GRANT_WAIT_S) or (
                        "surge" in marks and not revoked and len(states)
                        > marks["surge"]["pass"] + REVOKE_PASSES) or (
                        revoked and time.monotonic_ns() - revoked["mono_ns"]
                        > PUBLISH_WAIT_S * 1e9):
                    break
                time.sleep(0.05)
            end_ns = time.monotonic_ns()
        finally:
            Path(self.market_stop).touch()
            marks["plugin_rc"] = plugin.close()
            exporter.close()
            stub.stop()
            tail.stop()
        log = plugin.log_path.read_text()
        marks["plugin_started"] = all(line in log for line in (
            "utilization headroom publisher running",
            "quota market manager running",
            "victim-cost publisher running (leases=True spill=False)"))
        marks["failed_passes"] = log.count("quota market pass failed")
        runs = {}
        for pod in MARKET_PODS:
            t = self.tenants[pod]
            runs[pod] = t.line("STEPS ", TENANT_TIMEOUT_S)
            runs[pod]["rc"] = t.proc.wait(timeout=60)
        runs[INFER_POD]["ring"] = [
            (r.start_mono_ns, r.duration_ns, r.bucket_wait_ns)
            for r in tail.records]
        timelines = {
            uid: [{"stage": sp.stage, "attrs": sp.attrs} for sp in tl.spans]
            for uid, tl in assemble.assemble(assemble.read_spools(
                str(self.root / "trace"))[0]).items()}
        return judge_market_run(
            runs, states, published, docs, marks, end_ns,
            (self.lease_rec or {}).get("stages", []), timelines,
            {pod: f"uid-{pod}" for pod in MARKET_PODS},
            victimcost.parse_victim_costs)


class DevicePlugin:
    """The port's device plugin, its `main` (`cmd/device_plugin.py`), on
    the phase's node in a subprocess under `gates`, reaching the API
    server as a pod's agent does (`api`: KUBERNETES_SERVICE_HOST and
    _PORT; the token and CA in `sa`), its kubelet socket in a directory of
    its own (no kubelet answers its registration), its spans under
    `<root>/trace`, its log in `<root>/market-plugin.log`."""

    def __init__(self, root: Path, node, node_config: str, sa: str,
                 gates: str, api: dict, timeout_s: float = 60.0):
        self.log_path = root / "market-plugin.log"
        self._log = open(self.log_path, "w")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("VTPU_") and k != consts.ENV_LD_PRELOAD}
        env.update(api)
        # the card is busy with tenants: no calibration of the idle card
        env["VTPU_OBS_CALIBRATE"] = "0"
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(build.REPO), os.environ.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vtpu_manager_torch.cmd.device_plugin",
             "--node-name", node.name, "--node-config", node_config,
             "--feature-gates", gates,
             "--plugin-dir", str(root / "plugins"),
             "--base-dir", node.base_dir,
             "--vmem-path", os.path.join(node.vmem_dir, os.path.basename(
                 consts.VMEM_NODE_CONFIG)),
             "--lock-dir", node.lock_dir, "--watcher-dir", node.watcher_dir,
             "--driver-dir", node.driver_dir, "--service-account-dir", sa,
             "--trace-spool-dir", str(root / "trace"),
             "--trace-sampling-rate", "1"],
            cwd=str(build.REPO), env=env, stdout=self._log,
            stderr=subprocess.STDOUT)
        deadline = time.monotonic() + timeout_s
        while "device plugin running" not in self.log_path.read_text():
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.close()
                raise RuntimeError(
                    f"the device plugin did not start (rc "
                    f"{self.proc.returncode}):\n"
                    f"{self.log_path.read_text()[-2000:]}")
            time.sleep(0.05)

    def close(self) -> int | None:
        """SIGTERM, as the kubelet stops it; its exit code (None when it
        had to be killed)."""
        rc = self.proc.poll()
        if rc is None:
            self.proc.terminate()
            try:
                rc = self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return rc


def judge_market_run(runs: dict, states: list, published: list, docs: list,
                     marks: dict, end_ns: int, lease_stages: list,
                     timelines: dict, uids: dict,
                     parse_victim_costs) -> dict:
    """The market check's verdicts from what it recorded (a plain function
    of the records, as `judge_lease`)."""
    infer_uid, train_uid = uids[INFER_POD], uids[TRAIN_POD]
    infer_key, train_key = f"{infer_uid}/main", f"{train_uid}/main"
    base = MARKET_PODS[INFER_POD][0]
    rec: dict = {"passes": len(states), "marks": marks}
    leases = states[-1]["leases"] if states else []
    rec["leases"] = leases
    rec["conserved"] = bool(states) and all(
        v <= 100 for st in states for v in st["sum_effective"].values())
    rec["parties_ok"] = bool(leases) and all(
        (l["lender"], l["borrower"]) == (train_key, infer_key)
        for l in leases)
    infer = runs[INFER_POD]
    off = marks.get("mono_minus_wall_ns", 0)
    rewrites = market_rewrites(states, infer["steps"], off)
    # every rewrite carries the ledger's epoch and its deltas
    rec["rewrites"] = rewrites
    rec["rewrites_ok"] = all(
        all(st["configs"][pod]["epoch"] in (0, st["epoch"])
            and st["configs"][pod]["lease"] == st["deltas"].get(key, 0)
            for pod, key in ((INFER_POD, infer_key), (TRAIN_POD, train_key)))
        for st in states)
    # each grant went to a borrower its bucket bound: its bucket wait over
    # its steps' time in the window the market's fold read
    rec["grants"] = grant_bucket_waits(infer.get("ring", []), infer["steps"],
                                       states, rewrites, off, infer_uid)
    threshold = marks.get("wait_frac_threshold", 0.2)
    rec["grants_ok"] = all(g["bucket_wait"] is not None
                           and g["bucket_wait"] >= threshold
                           for g in rec["grants"])
    rec["reloads"] = [infer.get("vtpu_quota_reloads_total"), len(rewrites)]
    rec["core_limit"] = infer.get("vtpu_core_limit")
    revokes = [l for l in leases if l["state"] == "revoked"]
    # each pod's timeline (vtrace's assembly of the spools), by its uid
    events = {pod: sorted({s["stage"] for s in timelines.get(uid, [])
                           if s["stage"].startswith("quota.")})
              for pod, uid in uids.items()}
    whys = sorted({s["attrs"].get("why") for spans in timelines.values()
                   for s in spans if s["stage"] == "quota.revoke"})
    rec["events"], rec["revoke_why"] = events, whys
    rec["annotations_ok"] = bool(states) and all(st["annotation_ok"]
                                                 for st in states)
    during = [parse_victim_costs(p["raw"]) for p in published
              if p["leased"] and not p["after_revoke"]]
    after = [parse_victim_costs(p["raw"]) for p in published
             if p["after_revoke"]]
    rec["victims"] = {"during": [v.lookup(infer_uid) if v else None
                                 for v in during],
                      "after": [v.lookup(infer_uid) if v else None
                                for v in after]}
    # after the revoke pod-infer has no row, or one not marked (a row
    # comes only from a lease or, under HBMOvercommit, a spill)
    rec["victims_ok"] = bool(
        during and after and all(v and v[0] for v in
                                 rec["victims"]["during"])
        and not (rec["victims"]["after"][-1] or (False,))[0])
    rec["utilization_ok"] = False
    if docs and docs[0][0] == 200:
        doc = json.loads(docs[0][1])
        row = next((t for t in doc.get("tenants", [])
                    if t.get("pod_uid") == infer_uid), {})
        st = next(x for x in states if x["active"])
        q = doc.get("quota", {})
        rec["utilization"] = {"leases_active": q.get("leases_active"),
                              "borrowed": row.get("borrowed_core_pct"),
                              "ledger_borrowed": st["deltas"].get(
                                  infer_key)}
        rec["utilization_ok"] = (
            q.get("leases_active") is not None and q.get("leases_active")
            >= 1 and rec["utilization"]["borrowed"]
            == rec["utilization"]["ledger_borrowed"])
    # the shares, against the lease check's yardstick
    yard = next((s.get("charged_ms_per_step") for s in lease_stages
                 if s.get("effective") == 100 and s.get("n")), None)
    shares = judge_market(infer, rewrites, yard, end_ns,
                          (marks.get("surge") or {}).get("mono_ns"))
    rec["yard_ms"], rec["stages"] = yard, shares["stages"]
    surge, revoke = marks.get("surge"), marks.get("revoke")
    rec["revoke_passes"] = (revoke["pass"] - surge["pass"]
                            if surge and revoke else None)
    rec["surge_to_revoke_s"] = ((revoke["mono_ns"] - surge["mono_ns"]) / 1e9
                                if surge and revoke else None)
    rec["adoption_ms"] = [r["adoption_ms"] for r in rewrites]
    # each pass as this check's own fold of the ledger read it: the
    # borrower's wait fraction and used %, the lender's used %, envelope
    # and retained %
    rec["ledger"] = [
        {"pass": st["passes"], "sum": st["sum_effective"],
         "infer": {k: st["util"].get(infer_uid, {}).get(k)
                   for k in ("wait_frac", "used", "source")},
         "train": {k: st["util"].get(train_uid, {}).get(k)
                   for k in ("used", "envelope", "source")},
         "train_retained": st["configs"][TRAIN_POD]["effective"]}
        for st in states]
    rec["report"] = _market_report(runs, rewrites, shares["stages"], marks)
    rec["attn_block_launches"] = infer.get("attn_block_launches")
    rec["ok"] = bool(
        rec["conserved"] and rec["parties_ok"] and rec["rewrites_ok"]
        and rec["grants"] and rec["grants_ok"] and len(rewrites) >= 2
        and rec["reloads"][0] == len(rewrites)
        and rec["core_limit"] == base and revokes
        and whys == ["lender-demand"] and rec["annotations_ok"]
        and rec["victims_ok"] and rec["utilization_ok"]
        and all("quota.grant" in e and "quota.revoke" in e
                for e in events.values())
        and shares["ok"] and rewrites[-1]["effective"] == base
        and rec["revoke_passes"] is not None
        and rec["revoke_passes"] <= REVOKE_PASSES
        and all(runs[p]["rc"] == 0 for p in runs)
        and marks.get("plugin_rc") == 0 and marks.get("plugin_started")
        and marks.get("failed_passes") == 0)
    return rec


def market_rewrites(states: list, steps: list,
                    mono_minus_wall_ns: int) -> list[dict]:
    """pod-infer's config generations as the passes left them: for each
    pass whose read of the config holds a new epoch, the epoch, lease and
    effective percent, the pass (`pass`, and `pass_ns`: its fold's time on
    CLOCK_MONOTONIC, the stamp of its lease summary; the pass renames the
    config after it), and `adopted_ns`: the end of pod-infer's first step
    that ran under that epoch, as the interposer reports its epoch after
    each step (None when no step did); `adoption_ms` from the pass to
    it, the rename's own latency with the pass's fold and grant before
    it."""
    out, last = [], 0
    for st in states:
        cfg = st["configs"][INFER_POD]
        if cfg["epoch"] == last:
            continue
        last = cfg["epoch"]
        pass_ns = (int(st["fold_wall"] * 1e9) + mono_minus_wall_ns
                   if st.get("fold_wall") else None)
        first = next((s for s in steps if len(s) > 5 and s[5] == last
                      and (pass_ns is None or s[1] >= pass_ns)), None)
        adopted = first[1] if first else None
        out.append({"epoch": last, "lease": cfg["lease"],
                    "effective": cfg["effective"], "pass": st["passes"],
                    "pass_ns": pass_ns, "adopted_ns": adopted,
                    "adoption_ms": (adopted - pass_ns) / 1e6
                    if adopted is not None and pass_ns is not None
                    else None})
    return out


def grant_bucket_waits(ring: list, steps: list, states: list,
                       rewrites: list, mono_minus_wall_ns: int,
                       uid: str) -> list:
    """For each rewrite that raised pod-infer's effective quota (a grant),
    pod-infer's bucket wait over its steps' time in the window the
    granting pass's fold read: its step ring's records (`ring`: start,
    duration and bucket wait, ns, tailed as the node's reader tails it)
    that closed after the previous pass's fold and by this one's (before
    the first pass, the ring's last RING_STEPS). Beside it, the same from
    the interposer's throttle-wait total each step carries over the
    steps' own time (`steps_bucket_wait`, host time in the step
    included), and the wait fraction this check's own fold read for
    `uid`."""
    def mono(st):
        return (int(st["fold_wall"] * 1e9) + mono_minus_wall_ns
                if st.get("fold_wall") else None)
    out, prev = [], MARKET_PODS[INFER_POD][0]
    for r in rewrites:
        raised = r["effective"] > prev
        prev = r["effective"]
        if not raised:
            continue
        k = next((i for i, st in enumerate(states)
                  if st["passes"] == r["pass"]), None)
        rec = {"epoch": r["epoch"], "effective": r["effective"],
               "pass": r["pass"], "bucket_wait": None,
               "steps_bucket_wait": None, "fold_wait_frac": None}
        out.append(rec)
        hi = mono(states[k]) if k is not None else None
        if hi is None:
            continue
        lo = mono(states[k - 1]) if k > 0 else None
        inside = [x for x in ring if x[0] + x[1] <= hi
                  and (lo is None or x[0] + x[1] > lo)][-RING_STEPS:]
        if inside:
            rec["bucket_wait"] = (sum(x[2] for x in inside)
                                  / sum(x[1] for x in inside))
            rec["records"] = len(inside)
        idx = [i for i, x in enumerate(steps) if x[1] <= hi
               and (lo is None or x[1] > lo)][-RING_STEPS:]
        if idx and idx[0] > 0:
            before, run = steps[idx[0] - 1], [steps[i] for i in idx]
            rec["steps_bucket_wait"] = ((run[-1][2] - before[2])
                                        / sum(x[1] - x[0] for x in run))
        rec["fold_wait_frac"] = states[k]["util"].get(uid, {}).get(
            "wait_frac")
    return out


def _market_report(runs: dict, rewrites: list, stages: list,
                   marks: dict) -> dict:
    """What the check prints beside the reference's bounds and does not
    judge: pod-infer's p99 step at the static split against its largest
    lease stage (the reference asks 2x), pod-train's steps per second
    while idle with the market on against the static split (0.95), and
    each tenant's bucket wait over its step time per stage."""
    static = stages[0] if stages else {}
    leased = [s for s in stages[1:] if s["effective"] > stages[0][
        "effective"]] if stages else []
    top = max(leased, key=lambda s: s["effective"], default={})
    train = runs[TRAIN_POD]["steps"]
    first = rewrites[0]["pass_ns"] if rewrites else None
    surge = (marks.get("surge") or {}).get("mono_ns")

    def rate(lo, hi):
        n = [s for s in train if lo <= s[0] and s[1] <= hi and not s[3]]
        return (len(n) / ((n[-1][1] - n[0][0]) / 1e9)
                if len(n) > 1 else None)
    static_rate = rate(train[0][0], first) if train and first else None
    market_rate = rate(first, surge) if first and surge else None

    def bucket_wait(steps, lo, hi):
        inside = [s for s in steps if lo <= s[0] and s[1] <= hi]
        if len(inside) < 2:
            return None
        return ((inside[-1][2] - inside[0][2])
                / sum(s[1] - s[0] for s in inside[1:]))
    infer = runs[INFER_POD]["steps"]
    bounds = ([infer[0][0]] if infer else []) + [
        r["pass_ns"] for r in rewrites if r["pass_ns"] is not None]
    return {
        "p99_ms": [static.get("p99_ms"), top.get("p99_ms")],
        "p99_improvement_x": (static["p99_ms"] / top["p99_ms"]
                              if static.get("p99_ms") and top.get("p99_ms")
                              else None),
        "train_steps_per_s": [static_rate, market_rate],
        "train_retention": (market_rate / static_rate
                            if static_rate and market_rate else None),
        "infer_bucket_wait": [bucket_wait(infer, lo, hi) for lo, hi in
                              zip(bounds, bounds[1:] + [infer[-1][1]])]
        if infer else [],
        "train_bucket_wait": [bucket_wait(train, train[0][0], first or 0),
                              bucket_wait(train, first or 0, surge or 0),
                              bucket_wait(train, surge or 0, train[-1][1])]
        if train else []}


CHECKS = ("lease", "freeze", "tools", "market")


# --- the tenants ------------------------------------------------------------

def _counter_fns() -> dict:
    """The preloaded interposer's throttle-wait, freeze-wait and charged
    totals and the quota epoch in force, read each step."""
    path = os.environ.get(consts.ENV_LD_PRELOAD, "").split(":")[0]
    lib = ctypes.CDLL(path) if path else None
    out = {}
    for name, restype in (("vtpu_throttle_wait_ns_total", ctypes.c_uint64),
                          ("vtpu_freeze_wait_ns_total", ctypes.c_uint64),
                          ("vtpu_charged_ns_total", ctypes.c_int64),
                          ("vtpu_quota_epoch", ctypes.c_uint64)):
        fn = getattr(lib, name, None) if lib is not None else None
        if fn is not None:
            fn.restype = restype
        out[name] = fn if fn is not None else (lambda: 0)
    return out


def lease_steps(go_file: str, stop_file: str, graph: bool = False,
                dim: int = 8192) -> dict:
    """The quota step and one attn_block launch per step (a CUDA-graph
    replay of both with `graph`), each ending in a readback, from the go
    file until the stop file: per step its CLOCK_MONOTONIC start and end
    and the interposer's throttle-wait, freeze-wait and charged totals and
    its quota epoch after it."""
    from vtpu_manager_torch.bench_quota import _wait_file
    from vtpu_manager_torch.bench_steps import attn_step
    from vtpu_manager_torch.workloads import block_attention as ba
    run = attn_step(dim, graph)
    for _ in range(WARMUP):
        _ = float(run())
    counters = _counter_fns()
    wait = counters["vtpu_throttle_wait_ns_total"]
    frozen = counters["vtpu_freeze_wait_ns_total"]
    charged = counters["vtpu_charged_ns_total"]
    epoch = counters["vtpu_quota_epoch"]
    print("READY", flush=True)
    _wait_file(go_file)
    launches0 = ba.LAUNCHES["attn_block"]
    steps = []
    while not os.path.exists(stop_file):
        t0 = time.monotonic_ns()
        _ = float(run())
        steps.append((t0, time.monotonic_ns(), wait(), frozen(),
                      charged(), epoch()))
    return {"steps": steps,
            "attn_block_launches": ba.LAUNCHES["attn_block"] - launches0,
            "graph": graph}


def train_steps(go_file: str, busy_file: str, stop_file: str,
                duty: float = TRAIN_DUTY, dim: int = 8192) -> dict:
    """The quota step alone, each step followed by a sleep that holds it
    at `duty` % of the card (from the least of ten steps timed alone by
    the card's events, before the go file), back to back once the busy
    file exists, until the stop file: per step its CLOCK_MONOTONIC start
    and end, the interposer's throttle-wait total after it and whether
    it ran busy."""
    import torch

    from vtpu_manager_torch.bench_quota import _wait_file
    from vtpu_manager_torch.bench_steps import _quota_input, _quota_step
    x = _quota_input(dim, torch.device("cuda"))

    def run():
        y, loss = _quota_step(x)
        x.copy_(y)
        return loss
    for _ in range(WARMUP):
        _ = float(run())
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    alone = []
    for _ in range(10):
        start.record()
        run()
        end.record()
        end.synchronize()
        alone.append(start.elapsed_time(end) / 1e3)
    step_s = min(alone)
    wait = _counter_fns()["vtpu_throttle_wait_ns_total"]
    print("READY", flush=True)
    _wait_file(go_file)
    steps = []
    while not os.path.exists(stop_file):
        busy = os.path.exists(busy_file)
        t0 = time.monotonic_ns()
        _ = float(run())
        steps.append((t0, time.monotonic_ns(), wait(), busy))
        if not busy:
            time.sleep(step_s * (100.0 / duty - 1.0))
    return {"steps": steps, "step_ms": step_s * 1e3}


def _tenant(args, rest: list[str]) -> None:
    import importlib

    import torch

    from vtpu_manager_torch.bench_quota import _wait_file, shim_counters
    if args.tenant in ("lease", "train"):
        out = (lease_steps(args.go_file, args.stop_file, graph=args.graph)
               if args.tenant == "lease" else
               train_steps(args.go_file, args.busy_file, args.stop_file))
        out.update(shim_counters())
        print("STEPS " + json.dumps(out), flush=True)
        return
    # a node tool, run as its user runs it once the go file appears (the
    # imports done before)
    tool = importlib.import_module(rest[0])
    print("READY", flush=True)
    _wait_file(args.go_file)
    rc = tool.main(rest[1:])
    if rc:
        raise SystemExit(rc)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    rest: list[str] = []
    if "--" in argv:
        i = argv.index("--")
        argv, rest = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenant", choices=("lease", "train", "tool"))
    ap.add_argument("--go-file")
    ap.add_argument("--busy-file")
    ap.add_argument("--stop-file")
    ap.add_argument("--graph", action="store_true")
    args = ap.parse_args(argv)
    if args.tenant:
        _tenant(args, rest)
    else:
        ap.error("bench_quota_lease runs as a tenant; the phase is driven "
                 "by chip_smoke.py")


if __name__ == "__main__":
    sys.exit(main())
