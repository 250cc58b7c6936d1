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
4. outside: F4's pair (ROADMAP R11, F4; `F4Pair`). On a second private
   node of its own (so the first node's exporter counts no third pod), a
   50 % / 16 GiB pod's tenant under the interposer runs the same 16384
   bf16 step beside a process outside the interposer. The yardstick is
   the tenant's own card time inside the pair, T_a * f: f is the card's
   own inflation of that step beside another busy context, measured by
   two processes outside the interposer side by side (both time their
   step alone before and after). In each of `PAIR_WINDOWS` windows the
   interposer's charge per step lies within CHARGE_REL of T_a * f; the
   step at the pod's duty is printed beside, with NVML's SM clock, power
   draw and clock-event reasons per stretch. Not a check of
   chip_smoke.py's; `python -m vtpu_manager_torch.bench_monitor --f4`
   runs the phase with it and exits 1 when a check fails;
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
import threading
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
PAIR_S = 3.0             # one window; the pair without the interposer too
PAIR_SETTLE_S = 2.0      # NVML's listing lags about a second
PAIR_WINDOWS = 4
PAIR_ALONE_STEPS = 30
PAIR_SAMPLE_S = 0.02
PAIR_MIN_UTIL = 95       # f's identity holds only on a card kept busy
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
        self.pair: F4Pair | None = None
        self.paused_counts: dict[str, int] = {}
        # the phase's own fold of the rings, scanned where the exporter's
        # last two scrapes were (the pause, and after the exit)
        self.rings = TenantStepTelemetry(self.node.base_dir)
        self.scrape_s: list[float] = []
        self.solo_s: dict[str, float] = {}
        self.duty_s: dict[str, float] = {}
        self.again_s: dict[str, float] = {}

    def close(self) -> None:
        for t in self.tenants.values():
            t.stop()
        if self.pair is not None:
            self.pair.close()
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
        for t in self.tenants.values():
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
        if not self.f4:
            raise RuntimeError("F4's pair was not asked for (f4=False)")
        self.pair = F4Pair(self.torch, self.root, self.chip,
                           self.responses[OUTSIDE_POD])
        rec = self.pair.measure(self.duty_s[OUTSIDE_POD] * 1e3)
        rec["solo_step_ms"] = self.solo_s[OUTSIDE_POD] * 1e3
        return rec

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


def _tenant(args) -> None:
    import torch

    from vtpu_manager_torch.bench_quota import shim_counters, _wait_file
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
    if tel is None:
        raise RuntimeError("no step ring: the plugin armed no StepTelemetry")
    steps = 0

    def step() -> None:
        nonlocal x, steps
        s0 = time.monotonic_ns()
        x, loss = _quota_step(x)
        if args.attn:
            attn.attention_block(q, k, v, bias)
        _ = float(loss)
        tel.record(time.monotonic_ns() - s0,
                   hbm_highwater_bytes=torch.cuda.max_memory_allocated(),
                   compiled=(steps == 0))
        steps += 1

    def charged() -> int:
        return shim_counters().get("vtpu_charged_ns_total", 0)

    for _ in range(WARMUP):
        step()
    hold = torch.ones(args.hold_mib * MIB, dtype=torch.uint8, device=dev)
    torch.cuda.synchronize()
    print("READY", flush=True)
    _wait_file(args.go_file)
    charged0, steps0 = charged(), steps
    while steps < args.max_steps - TAIL_STEPS and not os.path.exists(
            args.pause_file):
        step()
    print("PAUSED " + json.dumps({
        "records": steps, "run_steps": steps - steps0,
        "charged_ns": charged() - charged0}), flush=True)
    _wait_file(args.resume_file)
    for _ in range(TAIL_STEPS):
        step()
    print("WORKER " + json.dumps({
        "pid": os.getpid(), "records": steps, "hold_bytes": hold.numel(),
        "attn_launches": attn.LAUNCHES["attn_block"],
        **shim_counters()}), flush=True)


# --- F4's pair ---------------------------------------------------------------

class F4Pair:
    """F4's pair (ROADMAP R11, F4): does the card run the same step slower
    beside another busy context, and is the interposer's charge then the
    tenant's own card time?

    Three processes run the 16384 bf16 quota step, each ending in a scalar
    readback: `a` and `b` outside the interposer, and `m`, a 50 % / 16 GiB
    pod's tenant under it, on a private node of its own (`node-f4`). Each
    answers commands on its stdin (`_pair_worker`). The card's own
    inflation comes from `a` and `b` alone: each times its step alone
    (CUDA events around each step, the median), then both step side by
    side for `PAIR_S`; with the card busy throughout (NVML's utilization,
    sampled) and both running the same step, both inflate alike, so
    f = W / (n_a * T_a + n_b * T_b), with n counted in fractions of a
    step. Then `m` steps beside `b` for `PAIR_SETTLE_S` (the watcher's
    NVML listing and the slice clock settle) and `PAIR_WINDOWS` windows
    of `PAIR_S`: in each, what the interposer charged per step of `m` is
    judged against T_a * f, the tenant's own card time per step inside
    the pair, within CHARGE_REL. The pair (and T_a, T_b around it) runs
    before and after the windows; f is their mean. NVML's SM clock, power
    draw and clock-event reasons are sampled through the port's binding
    throughout, per stretch, to tell clocks from switches. The step timed
    alone at the pod's duty (`running`'s yardstick) is printed beside."""

    def __init__(self, torch, root: Path, chip, response):
        from vtpu_manager_torch.tpu.discovery import Nvml
        self.torch = torch
        self.root = Path(root)
        self.chip = chip
        self.nvml = Nvml.load()
        if self.nvml is None:
            raise RuntimeError("F4's pair needs NVML on the card")
        self.handle = self.nvml.handle(chip.index)
        outside = {k: v for k, v in os.environ.items()
                   if not k.startswith("VTPU_") and k != consts.ENV_LD_PRELOAD}
        outside["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
        args = ["-m", "vtpu_manager_torch.bench_monitor", "--pair-worker",
                "--dim", str(DIM)]
        self.workers = {
            "a": bq.Tenant("f4-a", args, outside, str(self.root), stdin=True),
            "b": bq.Tenant("f4-b", args, dict(outside), str(self.root),
                           stdin=True),
            "m": bq.Tenant("f4-m", args, ba.container_env(response),
                           str(self.root), stdin=True)}
        for w in self.workers.values():
            w.line("READY")
        self.samples: list[tuple] = []
        self._stretch = "idle"
        self._stop = False
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._sampler.start()
        self.runs = 0

    def _sample(self) -> None:
        n = self.nvml
        while not self._stop:
            try:
                self.samples.append((
                    self._stretch, n.utilization(self.handle),
                    n.sm_clock_mhz(self.handle), n.power_mw(self.handle),
                    n.clocks_event_reasons(self.handle)))
            except Exception as e:  # noqa: BLE001 - reported, not fatal
                self.samples.append((self._stretch, None, None, None,
                                     repr(e)))
            time.sleep(PAIR_SAMPLE_S)

    def close(self) -> None:
        self._stop = True
        for w in self.workers.values():
            w.stop()

    def nvml_summary(self, stretch: str) -> dict:
        rows = [r for r in self.samples if r[0] == stretch and r[1] is not None]

        def median(i):
            vals = sorted(r[i] for r in rows)
            return vals[len(vals) // 2] if vals else None
        reasons: dict[str, int] = {}
        for r in rows:
            reasons[hex(r[4])] = reasons.get(hex(r[4]), 0) + 1
        return {"n": len(rows), "util_median": median(1),
                "util_min": min((r[1] for r in rows), default=None),
                "sm_mhz_median": median(2),
                "sm_mhz_min": min((r[2] for r in rows), default=None),
                "sm_mhz_max": max((r[2] for r in rows), default=None),
                "power_w_median": (median(3) or 0) / 1e3,
                "reasons": reasons}

    def alone(self, name: str) -> float:
        """The card time of one step of `name`'s, alone (seconds)."""
        self._stretch = f"alone-{name}"
        w = self.workers[name]
        w.send("ALONE")
        return w.line("ALONE")["step_s"]

    def run(self, names: list[str], seconds: float, stretch: str
            ) -> tuple[int, dict]:
        """Each of `names` steps from a common start for `seconds`; returns
        the start (monotonic ns) and each one's marks: (ns, charged ns)
        after each step, the first at the start."""
        self.runs += 1
        stop = self.root / f"stop-{self.runs}"
        t0 = time.monotonic_ns() + int(0.3e9)
        for n in names:
            self.workers[n].send(f"RUN {t0} {stop}")
        time.sleep(max(0.0, (t0 - time.monotonic_ns()) / 1e9))
        self._stretch = stretch
        time.sleep(seconds)
        stop.touch()
        self._stretch = "idle"
        return t0, {n: self.workers[n].line("RUN", timeout=120)["marks"]
                    for n in names}

    @staticmethod
    def steps_in(marks: list, t0: int, t1: int) -> float:
        """The steps run inside [t0, t1], the partial ones at the ends in
        fractions of their own length."""
        n = 0.0
        for (s, _), (e, _) in zip(marks, marks[1:]):
            if e > s:
                n += max(0, min(e, t1) - max(s, t0)) / (e - s)
        return n

    @staticmethod
    def charge_in(marks: list, t0: int, t1: int) -> tuple[int, int]:
        """(charged ns, steps) over the whole steps that end in (t0, t1]."""
        idx = [i for i, (t, _) in enumerate(marks) if i and t0 < t <= t1]
        if not idx:
            return 0, 0
        return marks[idx[-1]][1] - marks[idx[0] - 1][1], len(idx)

    def pair(self, tag: str) -> dict:
        t_a0, t_b0 = self.alone("a"), self.alone("b")
        t0, marks = self.run(["a", "b"], PAIR_S, f"pair-{tag}")
        t_a1, t_b1 = self.alone("a"), self.alone("b")
        t1 = t0 + int(PAIR_S * 1e9)
        t_a, t_b = (t_a0 + t_a1) / 2, (t_b0 + t_b1) / 2
        n_a = self.steps_in(marks["a"], t0, t1)
        n_b = self.steps_in(marks["b"], t0, t1)
        return {"T_a_ms": [t_a0 * 1e3, t_a1 * 1e3],
                "T_b_ms": [t_b0 * 1e3, t_b1 * 1e3],
                "n_a": n_a, "n_b": n_b, "W_s": PAIR_S,
                "f": PAIR_S / (n_a * t_a + n_b * t_b),
                "T_a_s": t_a, "T_b_s": t_b, "nvml": self.nvml_summary(f"pair-{tag}"),
                "nvml_alone": self.nvml_summary("alone-a")}

    def metered(self) -> tuple[int, dict]:
        """`m` beside `b`: the settle stretch, then the windows."""
        total = PAIR_SETTLE_S + PAIR_WINDOWS * PAIR_S
        t0, marks = self.run(["m", "b"], total, "metered")
        return t0 + int(PAIR_SETTLE_S * 1e9), marks

    def measure(self, duty_ms: float) -> dict:
        before = self.pair("before")
        start, marks = self.metered()
        after = self.pair("after")
        f = (before["f"] + after["f"]) / 2
        t_a = (before["T_a_s"] + after["T_a_s"]) / 2
        t_b = (before["T_b_s"] + after["T_b_s"]) / 2
        own_ms = t_a * f * 1e3
        windows = []
        for k in range(PAIR_WINDOWS):
            w0 = start + int(k * PAIR_S * 1e9)
            w1 = w0 + int(PAIR_S * 1e9)
            charged, steps = self.charge_in(marks["m"], w0, w1)
            charged_ms = charged / 1e6 / max(steps, 1)
            n_m = self.steps_in(marks["m"], w0, w1)
            n_b = self.steps_in(marks["b"], w0, w1)
            windows.append({
                "steps": steps, "charged_ms_per_step": charged_ms,
                "charge_rel_own": charged_ms / own_ms - 1.0,
                "charge_rel_duty": charged_ms / duty_ms - 1.0,
                # the same identity inside the window, for the record: it
                # assumes both inflate alike, which b's stretches alone
                # (while m waits in the bucket) do not
                "f_window": PAIR_S / (n_m * t_a + n_b * t_b),
                "taken": 100.0 * n_m * t_a * f / PAIR_S})
        self.workers["m"].send("COUNTERS")
        counters = self.workers["m"].line("COUNTERS")
        rec = {"f": f, "f_before": before["f"], "f_after": after["f"],
               "T_a_ms": t_a * 1e3, "own_ms_per_step": own_ms,
               "duty_step_ms": duty_ms, "windows": windows,
               "pair_before": before, "pair_after": after,
               "nvml_metered": self.nvml_summary("metered"),
               "clocked": counters.get("vtpu_clocked_total"),
               "windows_opened": counters.get("vtpu_windows_total")}
        rec["ok"] = bool(
            all(abs(w["charge_rel_own"]) <= CHARGE_REL for w in windows)
            and all(p["nvml"]["util_median"] is not None
                    and p["nvml"]["util_median"] >= PAIR_MIN_UTIL
                    for p in (before, after))
            and (rec["clocked"] or 0) > 0)
        return rec


def _pair_worker(args) -> None:
    """One process of F4's pair: the quota step on commands from stdin.
    ALONE: the median card time of `PAIR_ALONE_STEPS` steps, each between
    its own CUDA events; RUN <start ns> <stop file>: steps from the start
    (monotonic) until the file appears, then the marks (monotonic ns,
    the interposer's charged ns) after each step; COUNTERS: the
    interposer's counters."""
    import ctypes

    import torch

    from vtpu_manager_torch.bench_quota import shim_counters
    from vtpu_manager_torch.bench_steps import _quota_input, _quota_step
    dev = torch.device("cuda")
    x = _quota_input(args.dim, dev)
    preload = os.environ.get(consts.ENV_LD_PRELOAD, "").split(":")[0]
    charged = None
    if preload:
        charged = ctypes.CDLL(preload).vtpu_charged_ns_total
        charged.restype = ctypes.c_uint64

    def step() -> None:
        nonlocal x
        x, loss = _quota_step(x)
        _ = float(loss)

    for _ in range(WARMUP):
        step()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    print("READY", flush=True)
    for line in sys.stdin:
        cmd, *rest = line.split()
        if cmd == "ALONE":
            times = []
            for _ in range(PAIR_ALONE_STEPS):
                start.record()
                x, loss = _quota_step(x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            print("ALONE " + json.dumps(
                {"step_s": sorted(times)[len(times) // 2]}), flush=True)
        elif cmd == "RUN":
            t0, stop = int(rest[0]), rest[1]
            while time.monotonic_ns() < t0:
                time.sleep(1e-4)
            marks = [(time.monotonic_ns(), charged() if charged else 0)]
            while not os.path.exists(stop):
                step()
                marks.append((time.monotonic_ns(),
                              charged() if charged else 0))
            print("RUN " + json.dumps({"marks": marks}), flush=True)
        elif cmd == "COUNTERS":
            print("COUNTERS " + json.dumps(shim_counters()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenant", action="store_true")
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--hold-mib", type=int, default=HOLD_MIB)
    ap.add_argument("--attn", action="store_true")
    ap.add_argument("--go-file")
    ap.add_argument("--pause-file")
    ap.add_argument("--resume-file")
    ap.add_argument("--max-steps", type=int, default=MAX_STEPS)
    ap.add_argument("--pair-worker", action="store_true",
                    help="one process of F4's pair, on stdin's commands")
    ap.add_argument("--f4", action="store_true",
                    help="run the phase's checks with F4's pair on the card")
    args = ap.parse_args(argv)
    if args.tenant:
        _tenant(args)
        return 0
    if args.pair_worker:
        _pair_worker(args)
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
