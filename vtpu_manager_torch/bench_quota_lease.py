"""A tenant under the interposer takes a quota-market lease and a migration
freeze from its config, and the node's tools run on the card: the checks
of chip_smoke.py's `quota_lease` phase.

On a private node (`bench_allocate.Node`: NVML discovery split 4, the
interposer installed with the registrar beside it, the NVML-fed
watcher), the port's device plugin allocates three pods on the card, and
their tenants start together when the phase starts, each held at a go
file once loaded (the lease tenant once warm), so only one runs at a
time:

- pod-lease, hard 25 % and 8 GiB: the 8192 bf16 quota step plus one
  `vtpu::attn_block` launch per step, each step ending in a readback;
- pod-busy, hard 50 % and 8 GiB: `tools/vtpu_busy.py --duty 100`;
- pod-offload, unmetered, capped at 512 MiB: `tools/host_offload_demo.py`
  over a 1 GiB model in pinned host memory.

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

The judging is plain functions of the tenants' records (`judge_lease`,
`judge_freeze`), which the CPU tests also feed.

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
    the count), their median and 90th-percentile step, and, from the
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
           "p90_ms": durs[int(0.9 * (len(durs) - 1))]}
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
        self.node = ba.Node(root, shim)
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")
        self.resp = {pod: self._allocate(pod) for pod in PODS}
        self.tenants: dict = {}
        self.go = {pod: str(self.root / f"{pod}.go") for pod in PODS}
        self.stop_file = str(self.root / "lease.stop")
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
        self.run: dict | None = None
        self.marks: dict | None = None

    def _allocate(self, pod: str):
        from vtpu_manager_torch import bench_allocate as ba
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import device_id
        cores, memory, slot = PODS[pod]
        self.node.client.add_pod(ba.committed_pod(pod, self.chip, cores,
                                                  memory))
        (resp,) = self.node.plugin(False).allocate(api.AllocateRequest(
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
        for pod in PODS:
            Path(self.go[pod]).touch()
        Path(self.stop_file).touch()
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


CHECKS = ("lease", "freeze", "tools")


# --- the tenants ------------------------------------------------------------

def _counter_fns() -> dict:
    """The preloaded interposer's throttle-wait, freeze-wait and charged
    totals, read each step."""
    path = os.environ.get(consts.ENV_LD_PRELOAD, "").split(":")[0]
    lib = ctypes.CDLL(path) if path else None
    out = {}
    for name, restype in (("vtpu_throttle_wait_ns_total", ctypes.c_uint64),
                          ("vtpu_freeze_wait_ns_total", ctypes.c_uint64),
                          ("vtpu_charged_ns_total", ctypes.c_int64)):
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
    and the interposer's throttle-wait, freeze-wait and charged totals
    after it."""
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
    print("READY", flush=True)
    _wait_file(go_file)
    launches0 = ba.LAUNCHES["attn_block"]
    steps = []
    while not os.path.exists(stop_file):
        t0 = time.monotonic_ns()
        _ = float(run())
        steps.append((t0, time.monotonic_ns(), wait(), frozen(),
                      charged()))
    return {"steps": steps,
            "attn_block_launches": ba.LAUNCHES["attn_block"] - launches0,
            "graph": graph}


def _tenant(args, rest: list[str]) -> None:
    import importlib

    import torch

    from vtpu_manager_torch.bench_quota import _wait_file, shim_counters
    if args.tenant == "lease":
        out = lease_steps(args.go_file, args.stop_file, graph=args.graph)
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
    ap.add_argument("--tenant", choices=("lease", "tool"))
    ap.add_argument("--go-file")
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
