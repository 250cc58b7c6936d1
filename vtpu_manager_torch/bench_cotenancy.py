"""Several tenants on one card: the checks of chip_smoke.py's `co_tenancy`
phase.

Every tenant is a subprocess with the interposer preloaded that reads its
limits from its own `vtpu.config` (no VTPU_*_LIMIT variable in its
environment) and shares one memory ledger, one utilization feed and one
lock directory with the others (`bench_quota.World`). The node watcher
(`TcWatcherDaemon` with `NvmlSampler`, 80 ms) runs in the calling process
for the whole phase. Each check returns a record with an `ok` verdict:

1. discovery: NVML finds the card torch sees, matched by UUID;
2. config_file: the 64 MiB cap from the file;
3. memory: siblings share a cap, a co-tenant does not consume it, the
   physical check refuses an oversold card, a killed tenant is reaped;
4. compute: 50 + 25, 50 + 50 and 60 / 25 / 10 together, against the step
   time measured alone with the same step count; no tenant of checks 4-7
   may be judged blind (the card's events are honest);
5. feed: what the watcher published during 50 + 25;
6. balance: a 25..75 tenant climbs alone and is pinned beside a co-tenant;
7. long_runs: 5 s at q50 and q25, charged device time against the
   tenant's own device time per step, beside a control tenant that charges
   as the interposer did before the isolated-sample discount
   (VTPU_OBS_OVERHEAD_US=0).

Every tenant logs the horizons its interposer found suspect (the blindness
test's inputs); each record carries them as `horizon_log`.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from pathlib import Path

from vtpu_manager_torch import bench_quota as bq
from vtpu_manager_torch.config.vmem import VmemLedger, fnv64
from vtpu_manager_torch.manager.watcher import NvmlSampler, TcWatcherDaemon
from vtpu_manager_torch.tpu import discovery

GIB = 2**30
SHARE_BAND = 15.0
LONG_BAND = 5.0
CHARGE_REL = 0.05
STEPS = 300
CAP_BYTES = 64 * 2**20
# steps profiled at the quota after a long run's charged stretch
PROFILE_AFTER = 100
# worker processes loaded ahead: the most tenants a check starts at once
POOL_SIZE = 3
H100_SMS = 132


def _token(pod_uid: str) -> int:
    return fnv64(f"{pod_uid}/main")


def _seeing(summaries) -> bool:
    """No tenant was judged blind: the card's events are honest."""
    return all(s["blind_ticks"] == 0 for s in summaries)


def check_discovery(torch) -> tuple[dict, object]:
    """NVML finds the card torch sees; the UUID joins the two views (NVML
    counts in PCI order, CUDA need not). Returns the record and the
    card's ChipSpec."""
    nvml = discovery.Nvml.load()
    if nvml is None:
        raise RuntimeError("no NVML library on a machine with a card")
    found = discovery.NvmlBackend(nvml).discover()
    first = discovery.discover()
    props = torch.cuda.get_device_properties(0)
    uuid = f"GPU-{props.uuid}"
    chip = next((c for c in found.chips if c.uuid == uuid), None)
    if chip is None:
        return {"ok": False, "uuid": uuid,
                "nvml": [c.uuid for c in found.chips]}, None
    handle = nvml.handle(chip.index)
    name = nvml.name(handle)
    rec = {"uuid": uuid, "index": chip.index, "name": name,
           "torch_name": torch.cuda.get_device_name(0),
           "memory": chip.memory, "torch_memory": int(props.total_memory),
           "nvml_total": nvml.memory_total(handle),
           "nvml_reserved": nvml.memory_reserved(handle),
           "core_count": chip.core_count,
           "discover_first": first.chips[0].uuid if first else None}
    rec["ok"] = (name == rec["torch_name"]
                 and abs(chip.memory - props.total_memory) <= 2**20
                 and chip.core_count == H100_SMS
                 and first is not None and first.chips == found.chips)
    return rec, chip


class Phase:
    """The phase's world, watcher and card: one per chip_smoke run."""

    def __init__(self, shim: str, root: str, chip):
        self.shim = shim
        self.chip = chip
        self.world = bq.World(root)
        self.daemon = TcWatcherDaemon(
            [chip.index], NvmlSampler(), tc_path=self.world.tc_path,
            vmem_path=self.world.vmem_path)
        self.daemon.start()
        self.solo: dict[int, dict] = {}
        # the compute checks' tenants come from processes started ahead
        self.pool = bq.TenantPool(
            str(self.world.root), bq.install(shim_path=shim)["LD_PRELOAD"],
            size=POOL_SIZE)

    def close(self) -> None:
        self.pool.close()
        self.daemon.stop()

    def env(self, pod_uid: str, extra: dict | None = None, **config) -> dict:
        env = self.world.env(self.shim, pod_uid, real_memory=self.chip.memory,
                             host_index=self.chip.index,
                             uuid=self.chip.uuid, **config)
        env["VTPU_LOGGER_LEVEL"] = "2"
        env.update(extra or {})
        return env

    def reap(self) -> int:
        """The node's sweep: dead entries of killed tenants, once stale."""
        time.sleep(1.1)
        old = os.environ.get("VTPU_VMEM_STALE_S")
        os.environ["VTPU_VMEM_STALE_S"] = "1"
        try:
            ledger = VmemLedger(self.world.vmem_path)
            reaped = ledger.reap_dead()
            left = ledger.entries()
            ledger.close()
        finally:
            if old is None:
                del os.environ["VTPU_VMEM_STALE_S"]
            else:
                os.environ["VTPU_VMEM_STALE_S"] = old
        return reaped if not left else -len(left)

    # --- 2. the config file ---------------------------------------------

    def check_config_file(self) -> dict:
        out = bq._run_tenant(["-m", "vtpu_manager_torch.bench_quota",
                              "--hbm-worker"],
                             self.env("pod-cap", cap=CAP_BYTES), "HBM", 300)
        if out is None:
            return {"ok": False}
        out["ok"] = (out["verdict"] == "oom" and out["total"] == CAP_BYTES
                     and out.get("source") == "config-file")
        return out

    # --- 3. memory across processes -------------------------------------

    def check_memory(self) -> dict:
        w = self.world
        specs = {  # tag: (pod, cap GiB, alloc GiB, retry s, extra env)
            "sib1": ("pod-sib", 16, "12", 0, None),
            "sib2": ("pod-sib", 16, "8,2", 0, None),
            "co1": ("pod-co", 16, "12", 0, None),
            "me": ("pod-me", 16, "12", 0, None),
            "pa": ("pod-pa", 40, "36", 0, None),
            "pb": ("pod-pb", 40, "36", 0, None),
            "pc": ("pod-pc", 40, "12", 0, None),
            "x1": ("pod-reap", 16, "12", 0, None),
            "x2": ("pod-reap", 16, "12", 5, {"VTPU_VMEM_STALE_S": "1"}),
        }
        hold = {tag: str(w.root / f"{tag}.release") for tag in specs}
        tenants = {}
        try:
            for tag, (pod, cap, alloc, retry, extra) in specs.items():
                tenants[tag] = bq.Tenant(
                    tag, bq.hold_args(alloc, w.go_file(tag), hold[tag],
                                      retry),
                    self.env(pod, extra, cap=cap * GIB), str(w.root))
            for t in tenants.values():
                t.line("READY")

            def run(tag):
                Path(w.go_file(tag)).touch()
                return tenants[tag].line("HOLD ")

            def release(*tags):
                for tag in tags:
                    Path(hold[tag]).touch()
                    tenants[tag].proc.wait(timeout=60)

            rec = {}
            rec["sib1"] = run("sib1")
            rec["co1"] = run("co1")
            rec["sib2"] = run("sib2")
            rec["me"] = run("me")
            release("sib1", "co1", "sib2", "me")
            rec["pa"] = run("pa")
            rec["pb"] = run("pb")
            rec["pc"] = run("pc")
            release("pa", "pb", "pc")
            rec["x1"] = run("x1")
            tenants["x1"].proc.send_signal(signal.SIGKILL)
            t_kill = time.monotonic()
            tenants["x1"].proc.wait(timeout=30)
            rec["x2"] = run("x2")
            release("x2")
        finally:
            for t in tenants.values():
                t.stop()
        granted_at = rec["x2"]["granted_at"][0]
        out = {
            "sibling": rec["sib1"]["verdicts"] == ["granted"]
            and rec["sib2"]["verdicts"] == ["refused", "granted"],
            "co_tenant": rec["co1"]["verdicts"] == ["granted"]
            and rec["me"]["verdicts"] == ["granted"],
            "physical": rec["pa"]["verdicts"] == rec["pb"]["verdicts"]
            == ["granted"] and rec["pc"]["verdicts"] == ["refused"]
            and rec["pc"].get("vtpu_oom_rejected_total", 0) >= 1,
            "reap_s": None if granted_at is None else granted_at - t_kill,
            "sources": sorted({r["source"] for r in rec.values()}),
            "records": rec}
        out["reap"] = out["reap_s"] is not None and out["reap_s"] <= 3.0
        out["reaped_after"] = self.reap()
        out["ok"] = (out["sibling"] and out["co_tenant"] and out["physical"]
                     and out["reap"] and out["sources"] == ["config-file"]
                     and out["reaped_after"] >= 0)
        return out

    # --- 4.-7. compute ----------------------------------------------------

    def tenants(self, specs, timeout: float = 600.0) -> dict[str, dict]:
        """specs: (tag, pod, quota, steps, options); quota 100 is
        unthrottled, options add soft_core, warmup_s, device_times."""
        built = []
        for tag, pod, quota, steps, opts in specs:
            opts = dict(opts or {})
            config = {"hard_core": quota}
            if "soft_core" in opts:
                config["soft_core"] = opts.pop("soft_core")
            extra = opts.pop("env", None)
            built.append((tag, bq.worker_args(steps, **opts),
                          self.env(pod, extra, **config)))
        return bq.run_tenants(self.world, built, timeout, pool=self.pool)

    def solo_ms(self, steps: int) -> dict:
        """The unthrottled tenant alone at this step count; the STEPS run
        also measures the step's device time alone."""
        if steps not in self.solo:
            opts = {"device_times": 40} if steps == STEPS else None
            self.solo[steps] = self.tenants(
                [("solo", "pod-solo", 100, steps, opts)])["solo"]
        return self.solo[steps]

    def share(self, rec: dict, steps: int) -> float:
        return 100.0 * self.solo_ms(steps)["ms_per_step"] / rec["ms_per_step"]

    def _summary(self, rec: dict, steps: int, quota: int) -> dict:
        alone = self.solo_ms(STEPS)["device_ms_per_step"]
        return {"quota": quota, "share": self.share(rec, steps),
                "ms_per_step": rec["ms_per_step"],
                "charged_ms_per_step": rec.get("charged_ns_per_step", 0) / 1e6,
                "alone_device_ms_per_step": alone,
                "source": rec.get("source"),
                "external": rec.get("vtpu_watcher_external_total"),
                "blind_ticks": rec.get("vtpu_blind_ticks_total"),
                "up_limit": rec.get("vtpu_up_limit"),
                "obs_overhead_ns": rec.get("vtpu_obs_overhead_ns"),
                # R9's sampling windows: taken, and waited out for others'
                "windows": rec.get("vtpu_windows_total"),
                "stand_aside_ms": rec.get("vtpu_stand_aside_ns_total",
                                          0) / 1e6,
                "horizon_log": rec.get("horizon_log")}

    def check_50_25_with_feed(self) -> tuple[dict, dict]:
        seen = {"fresh": 0, "reads": 0, "max_util": 0, "tokens": set()}
        stop = threading.Event()

        def poll():
            from vtpu_manager_torch.config.tc_watcher import TcUtilFile
            feed = TcUtilFile(self.world.tc_path)
            while not stop.wait(0.1):
                rec = feed.read_device(self.chip.index)
                if rec is None:
                    continue
                seen["reads"] += 1
                seen["fresh"] += rec.is_fresh()
                seen["max_util"] = max(seen["max_util"], rec.device_util)
                seen["tokens"] |= {p.owner_token for p in rec.procs}
            feed.close()

        self.solo_ms(STEPS)
        thread = threading.Thread(target=poll, daemon=True)
        thread.start()
        try:
            out = self.tenants([("q50", "pod-q50", 50, STEPS, None),
                                ("q25", "pod-q25", 25, STEPS, None)])
        finally:
            stop.set()
            thread.join(timeout=5)
        s50, s25 = (self._summary(out["q50"], STEPS, 50),
                    self._summary(out["q25"], STEPS, 25))
        compute = {"q50": s50, "q25": s25,
                   "ok": abs(s50["share"] - 50) <= SHARE_BAND
                   and abs(s25["share"] - 25) <= SHARE_BAND
                   and s50["share"] > s25["share"]}
        tokens = {_token("pod-q50"), _token("pod-q25")}
        feed = {"reads": seen["reads"], "fresh": seen["fresh"],
                "max_util": seen["max_util"],
                "tokens_seen": tokens <= seen["tokens"],
                "external": [s50["external"], s25["external"]],
                "blind_ticks": [s50["blind_ticks"], s25["blind_ticks"]]}
        feed["ok"] = (feed["fresh"] > 0 and feed["fresh"] == feed["reads"]
                      and feed["max_util"] > 0 and feed["tokens_seen"]
                      and all(e and e > 0 for e in feed["external"])
                      and feed["blind_ticks"] == [0, 0])
        return compute, feed

    def check_50_50(self) -> dict:
        out = self.tenants([("a", "pod-a", 50, STEPS, None),
                            ("b", "pod-b", 50, STEPS, None)])
        walls = [out["a"]["ms_per_step"], out["b"]["ms_per_step"]]
        s = {tag: self._summary(rec, STEPS, 50) for tag, rec in out.items()}
        return {**s, "wall_ratio": max(walls) / min(walls),
                "ok": max(walls) / min(walls) < 2.0 and _seeing(s.values())}

    def check_60_25_10(self) -> dict:
        out = self.tenants([("q60", "pod-q60", 60, STEPS, None),
                            ("q25", "pod-q25", 25, STEPS, None),
                            ("q10", "pod-q10", 10, STEPS, None)])
        s = {tag: self._summary(rec, STEPS, int(tag[1:]))
             for tag, rec in out.items()}
        ms = [out[t]["ms_per_step"] for t in ("q60", "q25", "q10")]
        return {**s, "ok": ms[0] < ms[1] < ms[2] and s["q10"]["share"] > 2
                and _seeing(s.values())}

    def check_balance(self) -> dict:
        ledger = VmemLedger(self.world.vmem_path)
        residents = len(ledger.entries())   # 0, or "alone" is not alone
        ledger.close()
        alone = self.tenants([("bal", "pod-bal", 25, STEPS,
                               {"soft_core": 75, "warmup_s": 1.0})])["bal"]
        pinned = self.tenants([
            ("bal", "pod-bal", 25, STEPS,
             {"soft_core": 75, "warmup_s": 1.0}),
            ("co", "pod-co50", 50, 3 * STEPS, None)])
        a = self._summary(alone, STEPS, 25)
        p = self._summary(pinned["bal"], STEPS, 25)
        co = self._summary(pinned["co"], STEPS, 50)
        return {"alone": a, "pinned": p, "residents_before": residents,
                "co": co,
                "ok": a["share"] >= 50 and a["up_limit"] > 25
                and abs(p["share"] - 25) <= SHARE_BAND
                and p["up_limit"] == 25 and _seeing((a, p, co))}

    def check_long_runs(self, seconds: float = 5.0,
                        step_ms: float = 1.8) -> dict:
        """Steps for 10 % more than `seconds` at the quota, at the step
        time measured in the enforcement phase; then the same run without
        the discount, as a control (reported, not judged). The charged
        stretch runs unprofiled, and the charge is judged against the
        tenant's own kernel time at its duty: torch.profiler's reading
        over `PROFILE_AFTER` steps run on at the quota right after the
        stretch (`duty_kernel_ms_sum`). A profiler inside the stretch
        lengthens an isolated launch's way to the card and raised the
        discounted charge it was to judge (PERF.md, PR 16, call 2); the
        steps timed back to back after the stretch read up to 3 % under
        it as the card's clocks moved (ROADMAP F6), printed beside
        (`charge_rel_b2b`)."""
        out = {}
        ok = True
        for quota in (50, 25):
            steps = int(1.1 * seconds * 1000 * quota / 100 / step_ms) + 1
            for tag, extra in ((f"q{quota}", None),
                               (f"q{quota}_control",
                                {"VTPU_OBS_OVERHEAD_US": "0"})):
                rec = self.tenants([(tag, f"pod-long{quota}", quota, steps,
                                     {"device_times": 40, "env": extra,
                                      "profile_after": PROFILE_AFTER})])[tag]
                s = self._summary(rec, steps, quota)
                s["steps"] = steps
                s["seconds"] = rec["t_end"] - rec["t_start"]
                for key in ("device_ms_per_step", "isolated_ms",
                            "isolated_span_ms", "isolated_kernel_ms",
                            "loop_kernel_ms", "loop_kernel_ms_sum",
                            "loop_kernels", "device_times_wait_ns",
                            "vtpu_sampled_launches_total",
                            "vtpu_launches_total", "vtpu_clocked_total",
                            "duty_kernel_ms", "duty_kernel_ms_sum",
                            "duty_kernels"):
                    s[key] = rec[key]
                s["charge_rel_err"] = (s["charged_ms_per_step"]
                                       / rec["duty_kernel_ms_sum"] - 1)
                s["charge_rel_b2b"] = (s["charged_ms_per_step"]
                                       / rec["device_ms_per_step"] - 1)
                out[tag] = s
            s = out[f"q{quota}"]
            s["ok"] = (s["seconds"] >= seconds
                       and abs(s["share"] - quota) <= LONG_BAND
                       and abs(s["charge_rel_err"]) <= CHARGE_REL
                       and _seeing([s]))
            ok &= s["ok"]
        out["ok"] = ok
        return out


def compare_shares(torch, shims: dict[str, str], rounds: int) -> None:
    """50 + 50 and 60 / 25 / 10 under each interposer in turn, the order
    reversed every other round (a, b, b, a, ...), each on a node of its
    own; one `SHARES {json}` line per check: shares, their sum (the card's
    throughput that reached the tenants), windows and stand-aside time."""
    import json
    import tempfile

    _, chip = check_discovery(torch)
    names = list(shims)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            with tempfile.TemporaryDirectory(prefix="vtpu-node-") as root:
                phase = Phase(shims[name], root, chip)
                try:
                    for check in (phase.check_50_50, phase.check_60_25_10):
                        rec = check()
                        tenants = {k: v for k, v in rec.items()
                                   if isinstance(v, dict)}
                        print("SHARES " + json.dumps({
                            "shim": name, "round": r,
                            "check": check.__name__, "ok": rec["ok"],
                            "shares": {k: v["share"]
                                       for k, v in tenants.items()},
                            "sum": sum(v["share"] for v in tenants.values()),
                            "windows": {k: v["windows"]
                                        for k, v in tenants.items()},
                            "stand_aside_ms": {k: v["stand_aside_ms"]
                                               for k, v in tenants.items()},
                            "charged_ms_per_step": {
                                k: v["charged_ms_per_step"]
                                for k, v in tenants.items()},
                            "solo_ms": phase.solo_ms(STEPS)["ms_per_step"]}),
                            flush=True)
                finally:
                    phase.close()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="co-tenant shares under several interposers")
    ap.add_argument("--shares", nargs="+", required=True,
                    metavar="NAME=SHIM",
                    help="interposers to compare (e.g. a parent's build)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    compare_shares(torch, dict(a.split("=", 1) for a in args.shares),
                   args.rounds)


if __name__ == "__main__":
    main()
