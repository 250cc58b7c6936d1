"""A pod's allocation-path timeline on the card: the checks of
chip_smoke.py's `tracing` phase.

On a private node (`bench_allocate.Node`: NVML discovery split 4, the
interposer installed, the NVML-fed watcher) whose node trace dir
(`consts.TRACE_DIR`, which the device plugin mounts into a sampled tenant)
lies inside the node's directory, the port's device plugin runs with the
Tracing gate at sampling rate `RATE` and with CompileCache. The phase
mints each pod's context with `trace.mint_for_pod`, as the admission
webhook would, and puts `trace.annotation_values` on the pod. Pods are
25 % and 8 GiB of the card. Pod S's uid is sampled, pod U's is not.

Checks, each a record with an `ok` verdict:

1. allocate: S's response carries `VTPU_TRACE_ID` = its uid,
   `VTPU_TRACE_SAMPLED=true` and the node trace dir mounted read-write;
   U's carries `VTPU_TRACE_SAMPLED=false` and no mount. A tenant
   (`bench_compilecache --tenant --store`) starts from each response
   alone, under the interposer;
2. tenants: S runs `install`, `mark_first_execute` and the first step of
   `workloads/compiled_step.py` through the store (a cold compile:
   outcome `miss`, the attention kernel launched), U the same (a hit);
   both exit 0; S traced and spooled, U neither;
3. dra: the DRA driver, traced at the same rate, prepares a claim
   reserved for S and one reserved for U: one `dra.prepare` and one
   `dra.cdi` span for S's claim, none for U's;
4. gate_off: with tracing off the plugin allocates a third annotated pod:
   no trace variable, no mount, and the spools do not change;
5. exporter: the port's exporter (a subprocess) serves S's timeline on
   `/traces?pod=`, with `plugin.allocate`, `plugin.config`, `dra.prepare`,
   `dra.cdi`, `shim.install`, `shim.first_execute`, `shim.compile` and
   `shim.compile_outcome` (`miss`); `plugin.config` inside
   `plugin.allocate`, which ends before `shim.install`, and
   `shim.install` <= `shim.first_execute` <= `shim.compile`'s start; no
   negative gap on the critical path; no drop; U's timeline 404; the
   `vtpu_trace_*` counts equal to the spools' spans; and
   `python -m vtpu_manager_torch.cmd.vtrace --pod <S> --json` gives the
   same timeline. Reported: the seconds from `plugin.allocate`'s start to
   S's first-step outputs;
6. allocate_time: Allocate's wall time with tracing off and on (every pod
   sampled), `TIMED` allocations each, in turns; reported, no band.

`close()` turns tracing off and gives `consts.TRACE_DIR` back, so that no
recorder or flusher outlives the phase. Run through chip_smoke.py (or
`chip_smoke.tracing`); `--tenant` processes are bench_compilecache's.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

from vtpu_manager_torch import bench_allocate as ba
from vtpu_manager_torch import build, trace
from vtpu_manager_torch import bench_monitor as bm
from vtpu_manager_torch.trace import assemble, context
from vtpu_manager_torch.util import consts

GIB = 2**30
RATE = 0.5
CORES, MEMORY_GIB = 25, 8
TIMED = 20
TENANT_TIMEOUT_S = 240.0
# the stages of S's timeline, and the order their spans must keep
STAGES = ("plugin.allocate", "plugin.config", "dra.prepare", "dra.cdi",
          "shim.install", "shim.first_execute", "shim.compile",
          "shim.compile_outcome")
CHECKS = ("allocate", "tenants", "dra", "gate_off", "exporter",
          "allocate_time")


def pick_pod(prefix: str, sampled: bool) -> str:
    """The first pod name `<prefix><i>` whose uid the mint samples at
    RATE as asked."""
    for i in range(1000):
        name = f"{prefix}{i}"
        ctx = context.mint({"metadata": {"uid": bm.pod_uid(name)}}, RATE)
        if ctx.sampled == sampled:
            return name
    raise RuntimeError(f"no {prefix} pod sampled={sampled} in 1000 uids")


def spool_state(trace_dir: str) -> dict[str, int]:
    """Each spool file's size: what a check that must write nothing
    compares before and after."""
    if not os.path.isdir(trace_dir):
        return {}
    return {n: os.path.getsize(os.path.join(trace_dir, n))
            for n in sorted(os.listdir(trace_dir))}


class Phase:
    def __init__(self, torch, shim: str, root: str):
        self.torch = torch
        self.node = ba.Node(root, shim)
        self.root = self.node.root
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")
        self.pods = {"s": pick_pod("pod-s", True),
                     "u": pick_pod("pod-u", False)}
        self.responses: dict = {}
        self.tenants: dict = {}
        self.rows: dict[str, dict] = {}
        self.exporter = None
        self.plugin = self.node.plugin(False)
        self.plugin.compile_cache_enabled = True
        # the plugin mounts consts.TRACE_DIR, not its spool dir (as the
        # JAX plugin does): both point into this node's directory until
        # close()
        self.trace_dir = str(self.root / "trace")
        self._node_trace_dir = consts.TRACE_DIR
        consts.TRACE_DIR = self.trace_dir
        trace.configure("plugin", spool_dir=self.trace_dir,
                        sampling_rate=RATE)

    def close(self) -> None:
        try:
            for t in self.tenants.values():
                try:
                    t.proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pass        # stop() kills it
                t.stop()
            if self.exporter is not None:
                self.exporter.close()
            self.node.close()
        finally:
            trace.reset()
            consts.TRACE_DIR = self._node_trace_dir

    def _allocate(self, name: str, annotations: dict | None):
        """Commits pod `name` (with `annotations` on it) and allocates it;
        (response, seconds in Allocate)."""
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import device_id
        pod = ba.committed_pod(name, self.chip, CORES, MEMORY_GIB * GIB)
        pod["metadata"]["annotations"].update(annotations or {})
        self.node.client.add_pod(pod)
        req = api.AllocateRequest([api.ContainerAllocateRequest(
            [device_id(self.chip.uuid, 0)])])
        t0 = time.perf_counter()
        (resp,) = self.plugin.allocate(req).container_responses
        return resp, time.perf_counter() - t0

    @staticmethod
    def _trace_view(resp) -> dict:
        return {"env": {k: resp.envs.get(k) for k in (
                    consts.ENV_TRACE_ID, consts.ENV_TRACE_SAMPLED)},
                "mount": [[m.host_path, m.read_only] for m in resp.mounts
                          if m.container_path == consts.TRACE_DIR]}

    # --- 1. allocate --------------------------------------------------------

    def check_allocate(self) -> dict:
        from vtpu_manager_torch import bench_quota as bq
        rec = {}
        for key, name in self.pods.items():
            # the admission webhook's stand-in: mint, then annotate
            ctx = trace.mint_for_pod({"metadata": {"uid": bm.pod_uid(name)}})
            resp, _ = self._allocate(name, trace.annotation_values(ctx))
            self.responses[key] = resp
            rec[key] = {"pod": name, "sampled": ctx.sampled,
                        **self._trace_view(resp)}
        uid_s = bm.pod_uid(self.pods["s"])
        rec["ok"] = bool(
            rec["s"]["env"] == {consts.ENV_TRACE_ID: uid_s,
                                consts.ENV_TRACE_SAMPLED: "true"}
            and rec["s"]["mount"] == [[self.trace_dir, False]]
            and rec["u"]["env"] == {
                consts.ENV_TRACE_ID: bm.pod_uid(self.pods["u"]),
                consts.ENV_TRACE_SAMPLED: "false"}
            and rec["u"]["mount"] == [])
        # both tenants start now and wait at READY; S goes first
        for key, resp in self.responses.items():
            env = ba.container_env(resp)
            for var in (consts.ENV_INDUCTOR_CACHE_DIR,
                        consts.ENV_TRITON_CACHE_DIR):
                # empty dirs of the tenant's own: S's compile is cold
                env[var] = str(self.root / f"tenant-{key}" / var.lower())
            self.tenants[key] = bq.Tenant(
                f"trace-{key}",
                ["-m", "vtpu_manager_torch.bench_compilecache", "--tenant",
                 "--store", "--go-file", str(self.root / f"{key}.go"),
                 "--out", str(self.root / f"{key}.pt")], env,
                str(self.root))
            rec[key]["trace_dir_env"] = env.get(consts.ENV_TRACE_DIR)
        t0 = time.monotonic()
        for t in self.tenants.values():
            t.line("READY", TENANT_TIMEOUT_S)
        rec["tenants_ready_s"] = time.monotonic() - t0
        rec["ok"] = bool(rec["ok"]
                         and rec["s"]["trace_dir_env"] == self.trace_dir
                         and rec["u"]["trace_dir_env"] is None)
        return rec

    # --- 2. tenants ---------------------------------------------------------

    def check_tenants(self) -> dict:
        rec = {}
        done = {}
        for key in ("s", "u"):
            # U goes once S's entry is stored; S exits meanwhile
            (self.root / f"{key}.go").touch()
            row = self.tenants[key].line("WORKER ", TENANT_TIMEOUT_S)
            done[key] = time.monotonic()
            self.rows[key] = row
            rec[key] = {k: row[k] for k in (
                "pid", "outcome", "ttfs_s", "traced", "step_launches",
                "op_launches", "op_shim_launches", "first_step_wall")}
        for key in ("s", "u"):
            # the tenant's last spans are flushed at its exit
            rec[key]["rc"] = self.tenants[key].proc.wait(timeout=90)
            rec[key]["exit_s"] = time.monotonic() - done[key]
        spools = spool_state(self.trace_dir)
        rec["spools"] = spools
        s, u = rec["s"], rec["u"]
        rec["ok"] = bool(
            s["rc"] == 0 and u["rc"] == 0
            and s["outcome"] == "miss" and u["outcome"] == "hit"
            and s["traced"] and not u["traced"]
            and s["step_launches"] >= 1 and s["op_shim_launches"] >= 1
            and f"tenant.{s['pid']}.jsonl" in spools
            and not any(f".{u['pid']}." in n for n in spools))
        return rec

    # --- 3. dra -------------------------------------------------------------

    def check_dra(self) -> dict:
        from vtpu_manager_torch import bench_dra as bd
        from vtpu_manager_torch.kubeletplugin.api import messages as api
        from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
        from vtpu_manager_torch.kubeletplugin.driver import (ClaimSource,
                                                             DraDriver)
        node = self.node
        trace.flush()
        trace.configure("dra", spool_dir=self.trace_dir, sampling_rate=RATE)
        claims = {}
        for key, slot in (("s", 1), ("u", 2)):
            name = f"claim-{key}"
            claim = bd.allocated_claim(name, self.chip.index, {"gpu": [slot]},
                                       CORES, MEMORY_GIB * 1024)
            pod = self.pods[key]
            claim["status"]["reservedFor"] = [
                {"resource": "pods", "name": pod, "uid": bm.pod_uid(pod)}]
            node.client.add_resourceclaim(claim)
            claims[key] = claim["metadata"]["uid"]
        state = DeviceState(
            ba.NODE, node.manager.chips, base_dir=str(self.root / "dra"),
            cdi_dir=str(self.root / "cdi"),
            node_config=node.manager.node_config,
            minors=node.manager.minors, shim_host_dir=node.driver_dir,
            lock_dir=node.lock_dir, vmem_dir=node.vmem_dir,
            watcher_dir=node.watcher_dir,
            registry_dir=str(self.root / "registry"))
        driver = DraDriver(ba.NODE, ClaimSource(node.client), state,
                           plugin_dir=str(self.root / "plugins"))
        resp = driver.node_prepare(api.NodePrepareResourcesRequest([
            api.Claim(uid, f"claim-{key}", bd.NAMESPACE)
            for key, uid in claims.items()]))
        trace.flush()
        spans, _ = assemble.read_spools(self.trace_dir)
        counts = {key: {stage: sum(1 for sp in spans if sp.stage == stage
                                   and sp.pod_uid == bm.pod_uid(pod))
                        for stage in ("dra.prepare", "dra.cdi")}
                  for key, pod in self.pods.items()}
        rec = {"errors": {k: resp.claims[uid].error
                          for k, uid in claims.items()},
               "spans": counts}
        rec["ok"] = bool(
            not any(rec["errors"].values())
            and counts["s"] == {"dra.prepare": 1, "dra.cdi": 1}
            and counts["u"] == {"dra.prepare": 0, "dra.cdi": 0})
        return rec

    # --- 4. gate_off --------------------------------------------------------

    def check_gate_off(self) -> dict:
        trace.flush()
        trace.reset()
        before = spool_state(self.trace_dir)
        name = "pod-off0"
        ctx = trace.TraceContext(trace_id=bm.pod_uid(name),
                                 pod_uid=bm.pod_uid(name), sampled=True)
        resp, _ = self._allocate(name, trace.annotation_values(ctx))
        view = self._trace_view(resp)
        after = spool_state(self.trace_dir)
        rec = {"pod": name, **view, "spools_unchanged": before == after,
               "null_span": trace.span(ctx, "plugin.allocate")
               is trace._NULL_SPAN}
        rec["ok"] = bool(
            view["env"] == {consts.ENV_TRACE_ID: None,
                            consts.ENV_TRACE_SAMPLED: None}
            and view["mount"] == [] and rec["spools_unchanged"]
            and rec["null_span"])
        return rec

    # --- 5. exporter --------------------------------------------------------

    def check_exporter(self) -> dict:
        checkpoint = str(self.root / "kubelet_internal_checkpoint")
        bm.write_checkpoint(checkpoint, [])
        node_config = self.root / "node-config.json"
        node_config.write_text(json.dumps({"default": {
            "deviceSplitCount": ba.SPLIT}}))
        self.exporter = bm.Exporter(self.root, self.node, checkpoint,
                                 str(node_config))
        uid_s = bm.pod_uid(self.pods["s"])
        status, body = self.exporter.get(f"/traces?pod={uid_s}")
        doc = json.loads(body) if status == 200 else {}
        spans = (doc.get("timeline") or {}).get("spans") or []
        by_stage: dict[str, list] = {}
        for sp in spans:
            by_stage.setdefault(sp["stage"], []).append(sp)
        first = {st: by_stage[st][0] for st in STAGES if st in by_stage}
        rec = {"status": status, "stages": sorted(by_stage),
               "missing": [st for st in STAGES if st not in by_stage]}
        order_ok = False
        if not rec["missing"]:
            alloc, cfg = first["plugin.allocate"], first["plugin.config"]
            install = first["shim.install"]
            fexec = first["shim.first_execute"]
            comp = first["shim.compile"]
            rec["outcome"] = first["shim.compile_outcome"]["attrs"].get(
                "outcome")
            order_ok = (alloc["start"] <= cfg["start"]
                        and cfg["dur"] <= alloc["dur"]
                        and alloc["start"] + alloc["dur"] < install["start"]
                        and install["start"] <= fexec["start"]
                        <= comp["start"])
            rec["to_first_step_s"] = (self.rows["s"]["first_step_wall"]
                                      - alloc["start"])
            rec["stage_ms"] = {st: first[st]["dur"] * 1e3 for st in STAGES}
        gaps = [row["gap_s"] for row in doc.get("critical_path") or []]
        rec["min_gap_s"] = min(gaps, default=None)
        rec["order_ok"] = order_ok
        # the unsampled pod has no timeline at all
        rec["u_status"] = self.exporter.get(
            f"/traces?pod={bm.pod_uid(self.pods['u'])}")[0]
        # the exporter's families against the spools it reads
        _, samples = self.exporter.metrics()
        spool_spans, drops = assemble.read_spools(self.trace_dir)
        want = {}
        for sp in spool_spans:
            want[sp.stage] = want.get(sp.stage, 0) + 1
        got = {lab["stage"]: int(v) for n, lab, v in samples
               if n == "vtpu_trace_stage_duration_seconds_count"}
        rec["stage_counts"] = got
        rec["drops"] = sum(drops.values())
        rec["dropped_total"] = sum(
            v for n, _, v in samples if n == "vtpu_trace_spool_dropped_total")
        # the CLI reads the same spools into the same timeline
        cli = subprocess.run(
            [sys.executable, "-m", "vtpu_manager_torch.cmd.vtrace",
             "--spool-dir", self.trace_dir, "--steps-dir", self.node.base_dir,
             "--pod", uid_s, "--json"], cwd=str(build.REPO),
            env=self.exporter.env, capture_output=True, text=True,
            timeout=120)
        cli_doc = json.loads(cli.stdout) if cli.returncode == 0 else {}
        rec["vtrace_rc"] = cli.returncode
        rec["vtrace_equal"] = bool(
            cli_doc.get("timeline") == doc.get("timeline")
            and cli_doc.get("critical_path") == doc.get("critical_path"))
        rec["ok"] = bool(
            status == 200 and order_ok and rec.get("outcome") == "miss"
            and all(len(by_stage[st]) == 1 for st in STAGES)
            and rec["min_gap_s"] is not None and rec["min_gap_s"] >= 0
            and rec["u_status"] == 404 and got == want
            and rec["drops"] == 0 and rec["dropped_total"] == 0
            and rec["vtrace_equal"])
        return rec

    # --- 6. allocate_time ---------------------------------------------------

    def check_allocate_time(self) -> dict:
        """Allocate's wall time, tracing off and on in turns (each pod
        annotated sampled, so on records both spans and mounts the dir)."""
        times = {"off": [], "on": []}
        for i in range(TIMED):
            for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                if mode == "on":
                    trace.configure("plugin",
                                    spool_dir=str(self.root / "trace-timed"),
                                    sampling_rate=RATE)
                else:
                    trace.reset()
                name = f"pod-timed-{mode}{i}"
                ctx = trace.TraceContext(trace_id=bm.pod_uid(name),
                                         pod_uid=bm.pod_uid(name))
                resp, seconds = self._allocate(
                    name, trace.annotation_values(ctx))
                if (consts.ENV_TRACE_ID in resp.envs) != (mode == "on"):
                    raise AssertionError(f"{name}: trace env with tracing "
                                         f"{mode}")
                times[mode].append(seconds)
        trace.flush()
        trace.reset()
        rec = {f"median_{m}_ms": statistics.median(t) * 1e3
               for m, t in times.items()}
        rec["allocations"] = {m: len(t) for m, t in times.items()}
        rec["ok"] = True        # reported, no band
        return rec
