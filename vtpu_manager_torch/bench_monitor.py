"""The node exporter reports each tenant's slice of the card: the checks of
chip_smoke.py's `monitor` phase.

On a private node (`bench_allocate.Node`: NVML discovery split 4 ways, the
interposer installed, locks, ledger and the NVML-fed watcher in
directories of their own), the port's device plugin allocates two pods
with the step ring, and the port's exporter
(`python -m vtpu_manager_torch.cmd.device_monitor`) runs as a subprocess
on 127.0.0.1 over that node's base dir, feed, ledger and a kubelet
checkpoint the phase writes. Its pod-resources socket names a path that
does not exist: the card machine has no kubelet and no grpc.

Checks, each a record with an `ok` verdict:

1. setup: the device plugin answers both pods (q50: 50 % and 16 GiB, and
   one attention-kernel launch per step; q25: 25 % and 8 GiB), the
   checkpoint names both (pod_uid, container) pairs under the vtpu-number
   resource, and an orphan config dir `bogus-uid_main` (0 %, 1 GiB) is
   named by no entry; the exporter answers /healthz. It runs with
   `VTPU_MAP_STARTUP_GRACE_S=0`, so the orphan is judged at once;
2. running: both tenants, started from their Allocate responses alone,
   warm up, hold `HOLD_MIB` and step. `SCRAPES` scrapes while they step:
   a scrape without the token is 401; the card's memory total is the
   registry's, 4 slots, one card, core limits 50 and 25, memory limits 16
   and 8 GiB, 75 % of the card's cores assigned, both pods corroborated by
   the checkpoint and the orphan flagged, the source "checkpoint", no
   feed in error; each tenant's attributed share, averaged over the
   scrapes, above 0, q50's above q25's, and within SHARE_BAND points of
   the share of the card the tenant took over the same scrapes: the steps
   its ring gained times the card time of one of its steps alone (timed
   by the phase before the tenants start, no interposer), over the
   scrapes' wall time. The same steps times the card time of one step
   alone run at the pod's quota's duty (each step timed between its own
   events, then the host idles for the rest of the pod's share, as the
   tenant's steps run) lie within QUOTA_BAND points of the tenant's
   quota, and what the interposer charged per step of the running
   stretch (its `vtpu_charged_ns_total` from the go file to the pause,
   over the steps between) within CHARGE_REL of that step: a kernel
   time-sliced with a co-tenant is charged its own device time, not its
   span. Then the tenants pause (they hold their memory and write no step
   record) and one more scrape: each tenant's memory gauge equals the sum
   of its ledger entries, read just before and just after it, and is at
   least the held buffer;
3. after: the tenants step `TAIL_STEPS` more and exit; a scrape then
   counts, per pod, as many steps as its ring holds (at most
   RING_CAPACITY), a throttle-wait fraction above 0 with q25's above
   q50's, and the node pressure (fraction and memory headroom) that a
   `TenantStepTelemetry` over the same rings gives, scanned at the pause
   and after the exit as the exporter was;
4. outside: F4's pair (ROADMAP R11). On a second private node of its own
   (so the first node's exporter counts no third pod), a 50 % / 16 GiB
   pod's tenant under the interposer runs the same 16384 bf16 step beside
   a process outside the interposer running it too (no config, no ledger
   entry, no throttle). Both start with the other tenants, create their
   inputs and wait at their own go file; they warm up only after it, so
   they take no slice while the other tenants run. After `OUTSIDE_SETTLE_S`
   (the watcher's NVML per-process samples lag about a second) the charge
   window opens for `OUTSIDE_RUN_S`: what the interposer charged per step
   there lies within CHARGE_REL of the step's card time alone at the
   pod's duty, as in `running` (`charge_rel_err`), its slice clock
   measured the tenant's long kernels, and the outside process stepped
   throughout. The outside process times its own card time per step in
   the window with a slice clock of the bench's own (`StepClock`, every
   `OUTSIDE_CLOCK_EVERY`-th step): reported beside, as the charge over
   that (`charge_rel_outside`) and as the two processes' card time over
   the window (`busy`). The node's feed, read in the window, is
   recorded. Not a check of chip_smoke.py's: on the H100 the charge
   lies a varying 2-13 % above the step at duty, often over the 5 % band
   (PERF.md); `python -m vtpu_manager_torch.bench_monitor --f4` runs the
   phase with it and exits 1 when a check fails;
5. publish: `PressurePublisher.publish_once` over the in-cluster client
   patches the node annotation on `client.apistub.ApiStub` (TLS), and the
   annotation decodes with `parse_pressure` to what was published; the
   vtpu-cores reporter lists 100 devices and the vtpu-memory reporter one
   per 256 MiB of the card's usable memory; /healthz answers `ok`,
   /traces an empty document and /utilization 404; the scrape's own
   duration is recorded.

Run `python -m vtpu_manager_torch.bench_monitor --tenant ...` only as the
tenant subprocess the phase starts.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

from vtpu_manager_torch import bench_allocate as ba
from vtpu_manager_torch import bench_quota as bq
from vtpu_manager_torch.build import REPO
from vtpu_manager_torch.util import consts

GIB = 2**30
MIB = 2**20
# pod: (cores %, memory GiB, one attention launch per step, kubelet's slot)
PODS = {"pod-q50": (50, 16, True, 0), "pod-q25": (25, 8, False, 1)}
ORPHAN = ("bogus-uid", "main")
TOKEN = "monitor-phase-token"
HOLD_MIB = 256
DIM = 16384          # ~15 ms a step alone: 256 records last seconds at q50
WARMUP = 5
TAIL_STEPS = 20
MAX_STEPS = 240      # warm-up, running and tail stay inside one ring
SETTLE_S = 2.0       # NVML's utilization averages over about a second
SCRAPES = 10
SCRAPE_GAP_S = 0.25
SOLO_STEPS = 10
# attributed against taken, in points of the card: a mean of SCRAPES
# scrapes of one 80 ms tick's split (single scrapes of q25 read 5-20 for a
# mean of 12) and NVML's averaging window leave a few points of noise; a
# split that ignored who launched (equal shares, 37.5 each here) or halved
# a tenant's share would miss by more
SHARE_BAND = 8.0
# F4's pair: (cores %, memory GiB, attention launch, kubelet's slot) of the
# metered pod, beside the same step outside the interposer
OUTSIDE_POD = "pod-f4"
OUTSIDE_SPEC = (50, 16, False, 0)
OUTSIDE_NODE = "node-f4"
OUTSIDE_SETTLE_S = 2.0
OUTSIDE_RUN_S = 3.0
OUTSIDE_MAX_STEPS = 1000
OUTSIDE_CLOCK_EVERY = 4
# taken against the quota, in points of the card, and the charge against
# the card time of a step at the tenant's duty: a tenant charged its own
# device time takes its quota (co_tenancy's long runs hold the charge to
# 5 % of kernel time at 8192)
QUOTA_BAND = 5.0
CHARGE_REL = 0.05

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'(\w+)="([^"]*)"')


def parse_metrics(text: str) -> list[tuple[str, dict, float]]:
    """(name, labels, value) per sample line of a Prometheus text."""
    out = []
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m and not line.startswith("#"):
            out.append((m.group(1), dict(_LABEL.findall(m.group(2) or "")),
                        float(m.group(3))))
    return out


def value(samples, name: str, **labels) -> float | None:
    for n, lab, v in samples:
        if n == name and all(lab.get(k) == w for k, w in labels.items()):
            return v
    return None


def pod_uid(pod: str) -> str:
    return f"uid-{pod}"


def write_checkpoint(path: str, entries: list[tuple[str, str, list[str]]]
                     ) -> None:
    """Kubelet's device-manager checkpoint naming each (pod_uid, container)
    under the vtpu-number resource."""
    with open(path, "w") as f:
        json.dump({"Data": {"PodDeviceEntries": [
            {"PodUID": uid, "ContainerName": name,
             "ResourceName": consts.vtpu_number_resource(),
             "DeviceIDs": {"-1": ids}} for uid, name, ids in entries]}}, f)


class Exporter:
    """The port's exporter of `node` as a subprocess on 127.0.0.1 and a
    free port, its token file and log named by `tag`; `gates` is its
    --feature-gates."""

    def __init__(self, root: Path, node: ba.Node, checkpoint: str,
                 node_config: str, gates: str = "", tag: str = "monitor"):
        self.token_file = root / f"{tag}-token"
        self.token_file.write_text(TOKEN + "\n")
        self.log_path = root / f"{tag}.log"
        self._log = open(self.log_path, "w")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("VTPU_") and k != consts.ENV_LD_PRELOAD}
        env["VTPU_MAP_STARTUP_GRACE_S"] = "0"
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
        self.env = env
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vtpu_manager_torch.cmd.device_monitor",
             "--host", "127.0.0.1", "--port", "0", "--node-name", node.name,
             "--node-config", node_config,
             "--base-dir", node.base_dir,
             "--tc-path", os.path.join(node.watcher_dir, os.path.basename(
                 consts.TC_UTIL_CONFIG)),
             "--vmem-path", os.path.join(node.vmem_dir, os.path.basename(
                 consts.VMEM_NODE_CONFIG)),
             "--trace-spool-dir", str(root / "trace"),
             "--kubelet-checkpoint", checkpoint,
             "--pod-resources-socket", str(root / "no-kubelet.sock"),
             "--metrics-token-file", str(self.token_file),
             "--feature-gates", gates],
            cwd=str(REPO), env=env, stdout=self._log,
            stderr=subprocess.STDOUT)
        self.url = self._wait_for_port()

    def _wait_for_port(self, timeout: float = 60.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"exporter exited rc={self.proc.returncode}"
                                   f":\n{self.log_path.read_text()[-2000:]}")
            m = re.search(r"vtpu-monitor on 127\.0\.0\.1:(\d+)",
                          self.log_path.read_text())
            if m:
                return f"http://127.0.0.1:{m.group(1)}"
            time.sleep(0.05)
        raise TimeoutError("the exporter never said its port")

    def get(self, path: str, token: bool = True) -> tuple[int, str]:
        req = urllib.request.Request(self.url + path)
        if token:
            req.add_header("Authorization", f"Bearer {TOKEN}")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def metrics(self) -> tuple[str, list]:
        status, text = self.get("/metrics")
        if status != 200:
            raise RuntimeError(f"/metrics answered {status}: {text[:200]}")
        return text, parse_metrics(text)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()


class Phase:
    """The phase's checks on a private node; with `f4` False F4's pair
    is not started and `check_outside` does not run."""

    def __init__(self, torch, shim: str, root: str, f4: bool = True):
        self.f4 = f4
        from vtpu_manager_torch.telemetry import TenantStepTelemetry
        self.torch = torch
        self.root = Path(root)
        self.node = ba.Node(root, shim)
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")
        self.vmem_path = os.path.join(
            self.node.vmem_dir, os.path.basename(consts.VMEM_NODE_CONFIG))
        self.responses: dict = {}
        self.tenants: dict[str, bq.Tenant] = {}
        self.exporter: Exporter | None = None
        # F4's pair: its node, and its two processes ("metered", "outside")
        self.outside_node = ba.Node(str(self.root / "f4"), shim,
                                    name=OUTSIDE_NODE)
        self.outside: dict[str, bq.Tenant] = {}
        self.paused_counts: dict[str, int] = {}
        # the phase's own fold of the rings, scanned where the exporter's
        # last two scrapes were (the pause, and after the exit)
        self.rings = TenantStepTelemetry(self.node.base_dir)
        self.scrape_s: list[float] = []
        self.solo_s: dict[str, float] = {}
        self.duty_s: dict[str, float] = {}
        self.again_s: dict[str, float] = {}

    def close(self) -> None:
        for t in [*self.tenants.values(), *self.outside.values()]:
            t.stop()
        if self.exporter is not None:
            self.exporter.close()
        self.node.close()
        self.outside_node.close()

    def _scrape(self):
        text, samples = self.exporter.metrics()
        self.scrape_s.append(value(samples,
                                   "vtpu_node_scrape_duration_seconds"))
        return text, samples

    # --- 1. setup ---------------------------------------------------------

    def check_setup(self) -> dict:
        from vtpu_manager_torch.config import vtpu_config as vc
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import device_id
        chip, node = self.chip, self.node
        plugin = node.plugin(True)
        ids = {}
        for pod, (cores, gib, _, slot) in PODS.items():
            node.client.add_pod(ba.committed_pod(pod, chip, cores, gib * GIB))
            ids[pod] = [device_id(chip.uuid, slot)]
            (self.responses[pod],) = plugin.allocate(api.AllocateRequest(
                [api.ContainerAllocateRequest(ids[pod])])).container_responses
        # F4's pod, on its own node
        cores, gib, _, slot = OUTSIDE_SPEC
        other = self.outside_node
        other.client.add_pod(ba.committed_pod(
            OUTSIDE_POD, chip, cores, gib * GIB, node=OUTSIDE_NODE))
        (self.responses[OUTSIDE_POD],) = other.plugin(True).allocate(
            api.AllocateRequest([api.ContainerAllocateRequest(
                [device_id(chip.uuid, slot)])])).container_responses
        checkpoint = str(self.root / "kubelet_internal_checkpoint")
        write_checkpoint(checkpoint, [(pod_uid(p), "main", ids[p])
                                      for p in PODS])
        vc.write_config(
            os.path.join(node.base_dir, "_".join(ORPHAN), "config",
                         "vtpu.config"),
            vc.VtpuConfig(pod_uid=ORPHAN[0], container_name=ORPHAN[1],
                          devices=[vc.DeviceConfig(
                              uuid=chip.uuid, total_memory=GIB,
                              real_memory=chip.memory, hard_core=0,
                              host_index=chip.index)]))
        node_config = self.root / "node-config.json"
        node_config.write_text(json.dumps({"default": {
            "deviceSplitCount": ba.SPLIT}}))
        t0 = time.perf_counter()
        self.exporter = Exporter(self.root, node, checkpoint,
                                 str(node_config))
        start_s = time.perf_counter() - t0
        health = self.exporter.get("/healthz", token=False)
        rec = {"exporter": self.exporter.url, "exporter_start_s": start_s,
               "healthz": health,
               "envs": {p: {k: v for k, v in r.envs.items()
                            if k.startswith(("VTPU_", "NVIDIA"))}
                        for p, r in self.responses.items()}}
        specs = {**PODS, OUTSIDE_POD: OUTSIDE_SPEC}
        rec["ok"] = bool(
            health == (200, "ok")
            and all(r.envs.get(consts.ENV_STEP_TELEMETRY) == "true"
                    and r.envs.get(f"{consts.ENV_MEM_LIMIT}_0")
                    == str(specs[p][1] * GIB)
                    for p, r in self.responses.items()))
        return rec

    # --- 2. scrapes while the tenants run -----------------------------------

    def _ledger_bytes(self) -> dict[str, int]:
        from vtpu_manager_torch.config.vmem import VmemLedger, fnv64
        led = VmemLedger(self.vmem_path)
        try:
            entries = led.entries()
        finally:
            led.close()
        return {p: sum(e.bytes for e in entries
                       if e.owner_token == fnv64(f"{pod_uid(p)}/main"))
                for p in PODS}

    def _solo_step_s(self) -> tuple[dict[str, float], dict[str, float],
                                    dict[str, float]]:
        """Card time of one tenant step alone, per pod, in this process
        before any tenant runs: the quota step (and the q50 pod's attention
        launch) (1) back to back between two CUDA events, and (2) one at a
        time, each between its own events and followed by idle host time,
        so that the card runs it at the pod's quota's duty, as the tenant
        will (the median step); (3) back to back again once every pod has
        run (1) and (2), which tells a first run's warm-up from the step's
        own time (reported, not judged)."""
        torch = self.torch
        from vtpu_manager_torch.bench_steps import (ATTN_SHAPE, _quota_input,
                                                    _quota_step)
        from vtpu_manager_torch.workloads import block_attention as attn
        dev = torch.device("cuda")
        x = _quota_input(DIM, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn(ATTN_SHAPE, generator=gen, device=dev)
                   for _ in range(3))
        bias = torch.zeros((ATTN_SHAPE[2], ATTN_SHAPE[2]), device=dev)
        back_to_back, at_duty, again = {}, {}, {}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def step(with_attn):
            nonlocal x
            x, _ = _quota_step(x)
            if with_attn:
                attn.attention_block(q, k, v, bias)

        def run_back_to_back(with_attn) -> float:
            torch.cuda.synchronize()
            start.record()
            for _ in range(SOLO_STEPS):
                step(with_attn)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / SOLO_STEPS

        solo = {**PODS, OUTSIDE_POD: OUTSIDE_SPEC}
        for pod, (cores, _, with_attn, _) in solo.items():
            for _ in range(2):
                step(with_attn)
            back_to_back[pod] = run_back_to_back(with_attn)
            times = []
            for _ in range(SOLO_STEPS):
                start.record()
                step(with_attn)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
                time.sleep(times[-1] * (100.0 / cores - 1.0))
            at_duty[pod] = sorted(times)[len(times) // 2]
        for pod, (_, _, with_attn, _) in solo.items():
            again[pod] = run_back_to_back(with_attn)
        del x, q, k, v, bias
        torch.cuda.empty_cache()
        return back_to_back, at_duty, again

    def _ring_path(self, pod: str) -> str:
        return os.path.join(self.node.base_dir, f"{pod_uid(pod)}_main",
                            consts.TELEMETRY_SUBDIR, consts.STEP_RING_NAME)

    def _ring_heads(self) -> dict[str, int]:
        from vtpu_manager_torch.telemetry.stepring import StepRingReader
        heads = {}
        for p in PODS:
            reader = StepRingReader(self._ring_path(p))
            try:
                heads[p] = reader.poll(0)[1]
            finally:
                reader.close()
        return heads

    def _start_tenants(self) -> None:
        go = str(self.root / "go")
        for pod, (_, _, attn, _) in PODS.items():
            args = ["-m", "vtpu_manager_torch.bench_monitor", "--tenant",
                    "--dim", str(DIM), "--hold-mib", str(HOLD_MIB),
                    "--go-file", go, "--pause-file", str(self.root / "pause"),
                    "--resume-file", str(self.root / "resume")]
            if attn:
                args.append("--attn")
            self.tenants[pod] = bq.Tenant(
                pod, args, ba.container_env(self.responses[pod]),
                str(self.root))
        # F4's pair starts with them and waits, cold, at its own go file
        f4 = ["-m", "vtpu_manager_torch.bench_monitor", "--tenant",
              "--dim", str(DIM), "--hold-mib", str(HOLD_MIB),
              "--late-warmup", "--max-steps", str(OUTSIDE_MAX_STEPS)] + [
            a for name in ("go", "mark", "pause", "resume")
            for a in (f"--{name}-file", str(self.root / f"{name}-f4"))]
        outside_env = {k: v for k, v in os.environ.items()
                       if not k.startswith("VTPU_")
                       and k != consts.ENV_LD_PRELOAD}
        outside_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
        if self.f4:
            self.outside = {
                "metered": bq.Tenant("f4-metered", f4, ba.container_env(
                    self.responses[OUTSIDE_POD]), str(self.root)),
                "outside": bq.Tenant("f4-outside",
                                     f4 + ["--unmetered", "--clock"],
                                     outside_env, str(self.root))}
        for t in [*self.tenants.values(), *self.outside.values()]:
            t.line("READY")
        Path(go).touch()

    def check_running(self) -> dict:
        chip = self.chip
        self.solo_s, self.duty_s, self.again_s = self._solo_step_s()
        self._start_tenants()
        time.sleep(SETTLE_S)
        unauthorized = self.exporter.get("/metrics", token=False)[0]
        shares = {p: [] for p in PODS}
        heads0, t0 = self._ring_heads(), time.monotonic()
        for i in range(SCRAPES):
            if i:
                time.sleep(SCRAPE_GAP_S)
            _, samples = self._scrape()
            for p in PODS:
                shares[p].append(value(
                    samples, "vtpu_container_utilization_percent",
                    pod_uid=pod_uid(p), container="main"))
        heads1, window_s = self._ring_heads(), time.monotonic() - t0
        Path(self.root / "pause").touch()
        paused = {}
        for p, t in self.tenants.items():
            paused[p] = t.line("PAUSED")
            self.paused_counts[p] = paused[p]["records"]
        before = self._ledger_bytes()
        text, samples = self._scrape()
        after = self._ledger_bytes()
        self.rings.scan()
        (self.root / "scrape-paused.txt").write_text(text)
        dev = {"uuid": chip.uuid, "index": str(chip.index)}
        per_pod = {}
        for p, (cores, gib, _, _) in PODS.items():
            lab = {"pod_uid": pod_uid(p), "container": "main"}
            per_pod[p] = {
                "core_limit": value(samples,
                                    "vtpu_container_core_limit_percent",
                                    **lab),
                "memory_limit": value(samples,
                                      "vtpu_container_memory_limit_bytes",
                                      **lab),
                "memory_used": value(samples,
                                     "vtpu_container_memory_used_bytes",
                                     **lab),
                "ledger_before": before[p], "ledger_after": after[p],
                "mismatch": value(samples,
                                  "vtpu_container_pod_mapping_mismatch",
                                  **lab),
                "shares": shares[p],
                "mean_share": (sum(s or 0.0 for s in shares[p])
                               / len(shares[p])),
                "solo_step_ms": self.solo_s[p] * 1e3,
                "duty_step_ms": self.duty_s[p] * 1e3,
                "solo_again_ms": self.again_s[p] * 1e3,
                "window_steps": heads1[p] - heads0[p],
                "taken_share": (100.0 * (heads1[p] - heads0[p])
                                * self.solo_s[p] / window_s),
                # what the interposer charged per step of the running
                # stretch, over the card time of that step alone
                "charged_ms_per_step": (paused[p]["charged_ns"] / 1e6
                                        / max(paused[p]["run_steps"], 1))}
            r = per_pod[p]
            r["charge_rel_err"] = (r["charged_ms_per_step"]
                                   / r["duty_step_ms"] - 1.0)
            # the same charge against the back-to-back yardsticks (reported)
            r["charge_rel_b2b"] = (r["charged_ms_per_step"]
                                   / r["solo_step_ms"] - 1.0)
            r["charge_rel_again"] = (r["charged_ms_per_step"]
                                     / r["solo_again_ms"] - 1.0)
            r["taken_at_duty"] = (100.0 * r["window_steps"] * self.duty_s[p]
                                  / window_s)
            r["ok"] = bool(
                r["core_limit"] == cores and r["memory_limit"] == gib * GIB
                and r["ledger_before"] == r["ledger_after"]
                == r["memory_used"] and r["memory_used"] >= HOLD_MIB * MIB
                and r["mismatch"] == 0.0 and r["mean_share"] > 0
                and all(s is not None for s in r["shares"])
                and abs(r["mean_share"] - r["taken_share"]) <= SHARE_BAND
                and abs(r["taken_at_duty"] - cores) <= QUOTA_BAND
                and abs(r["charge_rel_err"]) <= CHARGE_REL
                and self.paused_counts[p] < MAX_STEPS - TAIL_STEPS)
        errors = {lab["feed"]: v for n, lab, v in samples
                  if n == "vtpu_node_scrape_last_error"}
        rec = {
            "unauthorized": unauthorized, "pods": per_pod,
            "memory_total": value(samples, "vtpu_device_memory_total_bytes",
                                  **dev),
            "registry_memory": chip.memory,
            "slots_total": value(samples, "vtpu_device_slots_total", **dev),
            "chips": [lab.get("chips") for n, lab, _ in samples
                      if n == "vtpu_node_info"],
            "cores_assigned": value(samples,
                                    "vtpu_device_cores_assigned_percent",
                                    **dev),
            "orphan_mismatch": value(samples,
                                     "vtpu_container_pod_mapping_mismatch",
                                     pod_uid=ORPHAN[0], container=ORPHAN[1]),
            "mapping_source": value(samples, "vtpu_node_pod_mapping_source"),
            "feed_errors": errors, "paused_records": self.paused_counts,
            "window_s": window_s}
        rec["ok"] = bool(
            unauthorized == 401
            and rec["memory_total"] == chip.memory
            and rec["slots_total"] == ba.SPLIT and rec["chips"] == ["1"]
            and rec["cores_assigned"] == 75
            and rec["orphan_mismatch"] == 1.0
            and rec["mapping_source"] == 1.0
            and errors and not any(errors.values())
            and all(r["ok"] for r in per_pod.values())
            and per_pod["pod-q50"]["mean_share"]
            > per_pod["pod-q25"]["mean_share"])
        return rec

    # --- 3. after the tenants exit ---------------------------------------

    def check_after(self) -> dict:
        from vtpu_manager_torch.telemetry.stepring import (RING_CAPACITY,
                                                           StepRingReader)
        Path(self.root / "resume").touch()
        workers = {}
        for p, t in self.tenants.items():
            workers[p] = t.line("WORKER ")
            t.proc.wait(timeout=60)
        text, samples = self._scrape()
        self.rings.scan()
        (self.root / "scrape-after.txt").write_text(text)
        frac, headroom = self.rings.pressure(self.chip.memory)
        per_pod = {}
        for p in PODS:
            reader = StepRingReader(self._ring_path(p))
            try:
                records, head, _ = reader.poll(0)
            finally:
                reader.close()
            lab = {"pod_uid": pod_uid(p), "container": "main"}
            r = per_pod[p] = {
                "count": value(samples,
                               "vtpu_tenant_step_duration_seconds_count",
                               **lab),
                "ring_records": len(records), "ring_head": head,
                "steps": workers[p]["records"],
                "wait_fraction": value(
                    samples, "vtpu_tenant_throttle_wait_fraction", **lab),
                "attn_launches": workers[p]["attn_launches"],
                "shim_launches": workers[p].get("vtpu_launches_total"),
                "blind_ticks": workers[p].get("vtpu_blind_ticks_total")}
            r["ok"] = bool(
                r["count"] == r["ring_records"] == r["ring_head"]
                == r["steps"] <= RING_CAPACITY
                and r["wait_fraction"] is not None
                and r["wait_fraction"] > 0
                and (r["attn_launches"] > 0) == PODS[p][2])
        rec = {"pods": per_pod,
               "pressure_frac": value(samples,
                                      "vtpu_node_pressure_throttle_frac"),
               "pressure_headroom": value(
                   samples, "vtpu_node_pressure_hbm_headroom_bytes"),
               "expected_frac": round(frac, 6),
               "expected_headroom": headroom}
        rec["ok"] = bool(
            all(r["ok"] for r in per_pod.values())
            and per_pod["pod-q25"]["wait_fraction"]
            > per_pod["pod-q50"]["wait_fraction"]
            and rec["pressure_frac"] == rec["expected_frac"]
            and rec["pressure_headroom"] == headroom)
        return rec

    # --- 4. F4's pair: a tenant beside a process outside the interposer ----

    def check_outside(self) -> dict:
        from vtpu_manager_torch.config.tc_watcher import TcUtilFile
        if not self.f4:
            raise RuntimeError("F4's pair was not started (f4=False)")
        (self.root / "go-f4").touch()
        time.sleep(OUTSIDE_SETTLE_S)
        (self.root / "mark-f4").touch()
        t0 = time.monotonic()
        time.sleep(OUTSIDE_RUN_S / 2)
        feed = TcUtilFile(os.path.join(self.outside_node.watcher_dir,
                                       os.path.basename(
                                           consts.TC_UTIL_CONFIG)))
        try:
            rec = feed.read_device(self.chip.index)
        finally:
            feed.close()
        time.sleep(OUTSIDE_RUN_S / 2)
        (self.root / "pause-f4").touch()
        paused = {k: t.line("PAUSED") for k, t in self.outside.items()}
        window_s = time.monotonic() - t0
        (self.root / "resume-f4").touch()
        workers = {}
        for k, t in self.outside.items():
            workers[k] = t.line("WORKER ")
            t.proc.wait(timeout=60)
        m, o = paused["metered"], paused["outside"]
        charged_ms = m["charged_ns"] / 1e6 / max(m["run_steps"], 1)
        duty_ms = self.duty_s[OUTSIDE_POD] * 1e3
        own_ms = o.get("clock_own_ms") or float("nan")
        out = {
            "charged_ms_per_step": charged_ms, "duty_step_ms": duty_ms,
            "outside_own_ms_per_step": own_ms,
            "outside_clocked": o.get("clocked", 0),
            "solo_step_ms": self.solo_s[OUTSIDE_POD] * 1e3,
            "solo_again_ms": self.again_s[OUTSIDE_POD] * 1e3,
            "charge_rel_err": charged_ms / duty_ms - 1.0,
            "charge_rel_outside": charged_ms / own_ms - 1.0,
            # the card time the two processes took over the window
            "busy": (m["charged_ns"] / 1e9 + o["run_steps"] * own_ms / 1e3)
            / window_s,
            "run_steps": {k: p["run_steps"] for k, p in paused.items()},
            "window_s": window_s,
            "taken_at_duty": (100.0 * m["run_steps"] * self.duty_s[
                OUTSIDE_POD] / window_s),
            "windows": workers["metered"].get("vtpu_windows_total"),
            "clocked": workers["metered"].get("vtpu_clocked_total"),
            "blind_ticks": workers["metered"].get("vtpu_blind_ticks_total"),
            "pids": {k: w["pid"] for k, w in workers.items()},
            "feed": {"device_util": rec.device_util,
                     "procs": [[p.pid, p.util, p.owner_token != 0]
                               for p in rec.procs]},
            # what the watcher reads of the card per process
            "per_process": [self.outside_node.daemon.sampler.per_process,
                            self.outside_node.daemon.sampler.per_process_util]}
        out["ok"] = bool(o["run_steps"] > 0 and m["run_steps"] > 0
                         and (out["clocked"] or 0) > 0
                         and abs(out["charge_rel_err"]) <= CHARGE_REL)
        return out

    # --- 5. the annotation, the reporters and the other routes ------------

    def check_publish(self) -> dict:
        from vtpu_manager_torch.bench_cluster import CERTS
        from vtpu_manager_torch.client.apistub import ApiStub
        from vtpu_manager_torch.client.kube import InClusterClient
        from vtpu_manager_torch.deviceplugin.reporters import (VcorePlugin,
                                                               VmemPlugin)
        from vtpu_manager_torch.telemetry import TenantStepTelemetry
        from vtpu_manager_torch.telemetry.pressure import (PressurePublisher,
                                                           parse_pressure)
        stub = ApiStub(str(CERTS / "server.crt"), str(CERTS / "server.key"),
                       token=TOKEN)
        stub.store.add_node({"metadata": {"name": ba.NODE,
                                          "annotations": {}}})
        stub.start()
        try:
            token = self.root / "api-token"
            token.write_text(TOKEN)
            client = InClusterClient(stub.url, str(token),
                                     str(CERTS / "ca.crt"))
            published = PressurePublisher(
                client, ba.NODE, TenantStepTelemetry(self.node.base_dir),
                node_hbm_total=self.chip.memory).publish_once()
            raw = stub.store.get_node(ba.NODE)["metadata"]["annotations"].get(
                consts.node_pressure_annotation())
            patches = [r["method"] for r in stub.requests
                       if r["path"].endswith(f"/nodes/{ba.NODE}")]
        finally:
            stub.stop()
        got = parse_pressure(raw)
        cores = VcorePlugin(self.node.manager).list_devices()
        mem = VmemPlugin(self.node.manager).list_devices()
        traces = self.exporter.get("/traces")
        rec = {"annotation": raw, "patches": patches,
               "published": [published.throttle_frac,
                             published.hbm_headroom_bytes],
               "decoded": [got.throttle_frac, got.hbm_headroom_bytes]
               if got else None,
               "vcore_devices": len(cores), "vmem_devices": len(mem),
               "usable_mib": self.chip.memory // MIB,
               "healthz": self.exporter.get("/healthz", token=False),
               "traces": traces,
               "utilization": self.exporter.get("/utilization")[0],
               "scrape_s": self.scrape_s}
        rec["ok"] = bool(
            got is not None and "PATCH" in patches
            and got.throttle_frac == round(published.throttle_frac, 4)
            and got.hbm_headroom_bytes == published.hbm_headroom_bytes
            and rec["vcore_devices"] == 100
            and rec["vmem_devices"] == self.chip.memory // (256 * MIB)
            and rec["healthz"] == (200, "ok")
            and traces[0] == 200 and json.loads(traces[1]) == {
                "pods": [], "timelines": [], "outliers": [],
                "spool_drops": 0}
            and rec["utilization"] == 404)
        return rec


# The outside process's own slice clock: the interposer's two kernels
# (csrc/shim/enforce_rate.cc, kSliceClockPtx), launched here over ctypes
# by a process the interposer does not touch.
_CLOCK_PTX = r"""
.version 7.0
.target sm_70
.address_size 64
.visible .entry vtpu_slice_watch(.param .u64 p_dev, .param .u64 p_rec,
    .param .u64 p_tag, .param .u64 p_gap, .param .u64 p_max)
{
  .reg .pred %p<4>;
  .reg .b64 %rd<20>;
  ld.param.u64 %rd1, [p_dev];
  ld.param.u64 %rd2, [p_rec];
  ld.param.u64 %rd3, [p_tag];
  ld.param.u64 %rd4, [p_gap];
  ld.param.u64 %rd5, [p_max];
  cvta.to.global.u64 %rd1, %rd1;
  cvta.to.global.u64 %rd2, %rd2;
  mov.u64 %rd6, %globaltimer;
  mov.u64 %rd7, %rd6;
  st.volatile.global.u64 [%rd1+32], %rd3;
  membar.sys;
  mov.u64 %rd8, 0;
  mov.u64 %rd9, 0;
  mov.u64 %rd10, 0;
  mov.u64 %rd15, 0;
LOOP:
  mov.u64 %rd11, %globaltimer;
  sub.u64 %rd12, %rd11, %rd7;
  setp.gt.u64 %p1, %rd12, %rd4;
  setp.ne.u64 %p2, %rd10, 0;
  and.pred %p3, %p1, %p2;
  @%p3 add.u64 %rd8, %rd8, %rd12;
  @%p3 add.u64 %rd9, %rd9, 1;
  mov.u64 %rd7, %rd11;
  ld.volatile.global.u64 %rd13, [%rd1];
  setp.eq.u64 %p1, %rd13, %rd3;
  selp.u64 %rd10, 1, 0, %p1;
  ld.volatile.global.u64 %rd14, [%rd1+16];
  setp.eq.u64 %p1, %rd14, %rd3;
  @%p1 bra DONE;
  sub.u64 %rd12, %rd11, %rd6;
  setp.lt.u64 %p1, %rd12, %rd5;
  nanosleep.u32 2000;
  @%p1 bra LOOP;
  mov.u64 %rd15, 1;
DONE:
  ld.volatile.global.u64 %rd16, [%rd1+8];
  ld.volatile.global.u64 %rd17, [%rd1+24];
  st.volatile.global.u64 [%rd2+8], %rd6;
  st.volatile.global.u64 [%rd2+16], %rd8;
  st.volatile.global.u64 [%rd2+24], %rd16;
  st.volatile.global.u64 [%rd2+32], %rd17;
  st.volatile.global.u64 [%rd2+40], %rd9;
  st.volatile.global.u64 [%rd2+48], %rd15;
  membar.sys;
  st.volatile.global.u64 [%rd2], %rd3;
  ret;
}
.visible .entry vtpu_slice_stamp(.param .u64 p_word, .param .u64 p_tag,
    .param .u64 p_wait)
{
  .reg .pred %p<3>;
  .reg .b64 %rd<8>;
  ld.param.u64 %rd1, [p_word];
  ld.param.u64 %rd2, [p_tag];
  ld.param.u64 %rd3, [p_wait];
  cvta.to.global.u64 %rd1, %rd1;
  setp.eq.u64 %p1, %rd3, 0;
  @%p1 bra STAMP;
  cvta.to.global.u64 %rd3, %rd3;
  mov.u64 %rd4, %globaltimer;
WAIT:
  ld.volatile.global.u64 %rd5, [%rd3];
  setp.eq.u64 %p1, %rd5, %rd2;
  @%p1 bra STAMP;
  mov.u64 %rd6, %globaltimer;
  sub.u64 %rd6, %rd6, %rd4;
  setp.lt.u64 %p2, %rd6, 1000000;
  @%p2 bra WAIT;
STAMP:
  mov.u64 %rd7, %globaltimer;
  st.volatile.global.u64 [%rd1+8], %rd7;
  membar.sys;
  st.volatile.global.u64 [%rd1], %rd2;
  ret;
}
"""


class StepClock:
    """A step's own card time beside other contexts: the watch kernel on
    a stream of its own reads %globaltimer from before the start stamp to
    the stop stamp, and the gaps longer than 20 us in its reads are other
    contexts' slices (`csrc/shim/enforce_rate.cc`, "A co-tenant outside
    the ledger"). For a process without the interposer."""

    GAP_NS = 20_000
    MAX_NS = 2_000_000_000

    def __init__(self, torch):
        import ctypes
        self._c = ctypes
        self.cu = ctypes.CDLL("libcuda.so.1")
        mod = ctypes.c_void_p()
        self._check(self.cu.cuModuleLoadData(
            ctypes.byref(mod), ctypes.c_char_p(_CLOCK_PTX.encode() + b"\0")))
        self.watch, self.stamp = ctypes.c_void_p(), ctypes.c_void_p()
        for fn, name in ((self.watch, b"vtpu_slice_watch"),
                         (self.stamp, b"vtpu_slice_stamp")):
            self._check(self.cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                                    name))
        host = ctypes.c_void_p()
        # CU_MEMHOSTALLOC_PORTABLE | CU_MEMHOSTALLOC_DEVICEMAP
        self._check(self.cu.cuMemHostAlloc(ctypes.byref(host),
                                           ctypes.c_size_t(128),
                                           ctypes.c_uint(3)))
        ctypes.memset(host, 0, 128)
        self.words = (ctypes.c_uint64 * 16).from_address(host.value)
        dev = ctypes.c_uint64()
        self._check(self.cu.cuMemHostGetDevicePointer_v2(
            ctypes.byref(dev), host, ctypes.c_uint(0)))
        self.dev = dev.value
        self.side = torch.cuda.Stream()
        self.torch = torch
        self.tag = 0

    @staticmethod
    def _check(rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"slice clock: CUDA driver error {rc}")

    def _launch(self, fn, stream, args) -> None:
        c = self._c
        vals = [c.c_uint64(a) for a in args]
        ptrs = (c.c_void_p * len(vals))(*[c.cast(c.byref(v), c.c_void_p)
                                           for v in vals])
        self._check(self.cu.cuLaunchKernel(fn, 1, 1, 1, 1, 1, 1, 0,
                                           c.c_void_p(stream.cuda_stream),
                                           ptrs, None))

    def start(self) -> None:
        self.tag += 1
        self._launch(self.watch, self.side,
                     [self.dev, self.dev + 64, self.tag, self.GAP_NS,
                      self.MAX_NS])
        self._launch(self.stamp, self.torch.cuda.current_stream(),
                     [self.dev, self.tag, self.dev + 32])

    def stop(self) -> None:
        self._launch(self.stamp, self.torch.cuda.current_stream(),
                     [self.dev + 16, self.tag, 0])

    def own_ns(self) -> int | None:
        """The last clocked stretch's own time, once the card has run it
        (the caller has synchronized); None when the watch missed it."""
        rec = self.words[8:15]
        deadline = time.monotonic() + 1.0
        while self.words[8] != self.tag and time.monotonic() < deadline:
            time.sleep(1e-4)
            rec = self.words[8:15]
        tag, start, gap, t0, t1, _, timed_out = rec
        if tag != self.tag or timed_out or start > t0 or t1 <= t0 \
                or gap > t1 - t0:
            return None
        return t1 - t0 - gap


def _tenant(args) -> None:
    import torch

    from vtpu_manager_torch.bench_quota import _shim_counters, _wait_file
    from vtpu_manager_torch.bench_steps import (ATTN_SHAPE, _quota_input,
                                                _quota_step)
    from vtpu_manager_torch.runtime.client import step_telemetry
    from vtpu_manager_torch.workloads import block_attention as attn

    dev = torch.device("cuda")
    x = _quota_input(args.dim, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(ATTN_SHAPE, generator=gen, device=dev)
               for _ in range(3))
    bias = torch.zeros((ATTN_SHAPE[2], ATTN_SHAPE[2]), device=dev)
    tel = step_telemetry()
    if tel is None and not args.unmetered:
        raise RuntimeError("no step ring: the plugin armed no StepTelemetry")
    # F4's pair times its own steps in the charge window
    clock = StepClock(torch) if args.clock else None
    owns: list[int] = []
    steps = 0

    def step(clocked: bool = False) -> None:
        nonlocal x, steps
        s0 = time.monotonic_ns()
        if clocked:
            clock.start()
        x, loss = _quota_step(x)
        if args.attn:
            attn.attention_block(q, k, v, bias)
        if clocked:
            clock.stop()
        _ = float(loss)
        if clocked:
            own = clock.own_ns()
            if own is not None:
                owns.append(own)
        if tel is not None:
            tel.record(time.monotonic_ns() - s0,
                       hbm_highwater_bytes=torch.cuda.max_memory_allocated(),
                       compiled=(steps == 0))
        steps += 1

    def warm_up() -> torch.Tensor:
        for _ in range(WARMUP):
            step()
        hold = torch.ones(args.hold_mib * MIB, dtype=torch.uint8,
                          device=dev)
        torch.cuda.synchronize()
        return hold

    def charged() -> int:
        return _shim_counters().get("vtpu_charged_ns_total", 0)

    if not args.late_warmup:
        hold = warm_up()
    print("READY", flush=True)
    _wait_file(args.go_file)
    if args.late_warmup:
        hold = warm_up()
    # the charge is read from the mark file (the go file unless named)
    mark = args.mark_file or args.go_file
    charged0 = steps0 = None
    while steps < args.max_steps - TAIL_STEPS and not os.path.exists(
            args.pause_file):
        if charged0 is None and os.path.exists(mark):
            charged0, steps0 = charged(), steps
        step(clocked=clock is not None and charged0 is not None
             and (steps - steps0) % OUTSIDE_CLOCK_EVERY == 0)
    if charged0 is None:
        charged0, steps0 = charged(), steps
    print("PAUSED " + json.dumps({
        "records": steps, "run_steps": steps - steps0,
        "charged_ns": charged() - charged0, "clocked": len(owns),
        "clock_own_ms": (sum(owns) / len(owns) / 1e6 if owns else None)}),
        flush=True)
    _wait_file(args.resume_file)
    for _ in range(TAIL_STEPS):
        step()
    print("WORKER " + json.dumps({
        "pid": os.getpid(), "records": steps, "hold_bytes": hold.numel(),
        "attn_launches": attn.LAUNCHES["attn_block"],
        **_shim_counters()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenant", action="store_true")
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--hold-mib", type=int, default=HOLD_MIB)
    ap.add_argument("--attn", action="store_true")
    ap.add_argument("--go-file")
    ap.add_argument("--mark-file",
                    help="the charge is read from when this file appears "
                    "(default: the go file)")
    ap.add_argument("--pause-file")
    ap.add_argument("--resume-file")
    ap.add_argument("--late-warmup", action="store_true",
                    help="warm up after the go file, not before READY")
    ap.add_argument("--max-steps", type=int, default=MAX_STEPS)
    ap.add_argument("--unmetered", action="store_true",
                    help="a process outside the interposer: no step ring")
    ap.add_argument("--clock", action="store_true",
                    help="time every few steps after the mark by a slice "
                    "clock of the bench's own (without the interposer)")
    ap.add_argument("--f4", action="store_true",
                    help="run the phase's checks with F4's pair on the card")
    args = ap.parse_args(argv)
    if args.tenant:
        _tenant(args)
        return 0
    if args.f4:
        return _f4_phase()
    ap.error("bench_monitor runs as a tenant, or with --f4; the phase is "
             "driven by chip_smoke.py")


def _f4_phase() -> int:
    """The phase's checks with F4's pair, one `MONITOR {json}` line each;
    1 when any fails."""
    import tempfile

    import torch

    from vtpu_manager_torch import build
    if not torch.cuda.is_available():
        print("bench_monitor: no CUDA device", file=sys.stderr)
        return 1
    shim = str(build.build_for_card()["shim"])
    ok = True
    with tempfile.TemporaryDirectory(prefix="vtpu-node-") as root:
        phase = Phase(torch, shim, root)
        try:
            for name in ("setup", "running", "after", "outside", "publish"):
                rec = getattr(phase, f"check_{name}")()
                ok &= bool(rec["ok"])
                print("MONITOR " + json.dumps({"check": name, **rec},
                                              default=str), flush=True)
        finally:
            phase.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
