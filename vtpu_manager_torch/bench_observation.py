"""The node calibrates the interposer's after-idle discount, and every
tenant under the interposer writes its own step ring: the checks of
chip_smoke.py's `observation` phase.

On a private node (`bench_allocate.Node`) the device plugin starts as
`cmd/device_plugin.py` does with `VTPU_OBS_CALIBRATE=1`: the observation
calibration (`manager/obs_calibrate.py`) runs in a throwaway process on
the idle card. Meanwhile the phase's two tenant processes start with the
node's interposer preloaded, import torch and wait at a go file without
touching the card; they take their container's environment (the Allocate
response's, `bench_allocate.container_env`) from a file once they go, and
none goes before the calibration process has exited.

Checks, each a record with an `ok` verdict:

1. calibration: a table came back (its first point (0, 0), one point per
   default gap); the manager holds it and annotates the node with it; the
   feed's calibration block holds it; the Allocate response of each pod
   carries it in VTPU_OBS_EXCESS_TABLE; the port's exporter
   (`cmd/device_monitor.py`) reports its largest excess as
   `vtpu_node_obs_excess_max_us`;
2. unmodified: a q50 / 16 GiB pod's tenant that never calls
   `step_telemetry()`: a plain torch loop of `STEPS` steps, each the 8192
   bf16 quota step, one `torch.ops.vtpu.attn_block` launch and
   `float(loss)`. Its interposer reports the table at every gap
   (`vtpu_obs_excess_at_us`: adopted); its ring (written by the
   interposer) holds one record per step (one more or less at the ends),
   with the median record within DURATION_REL of the tenant's own median
   step, throttle waits that add up to the interposer's counter and
   `compiled` only on the first steps; the exporter's fold counts the
   ring's records as the tenant's steps; and the tenant's share of the
   card (the step alone, timed by the phase before it went, over its step
   at the quota) lies within SHARE_BAND points of 50, the enforcement
   phase's band;
3. late: an unthrottled pod's tenant (no core limit, 8 GiB) steps
   `LATE_BEFORE` times, then calls `step_telemetry()` and records
   `LATE_AFTER` steps itself. The ring holds one stream: the interposer's
   records up to the handover, then the Python writer's, with an unbroken
   index.

Run `python -m vtpu_manager_torch.bench_observation --tenant ...` only as
the tenant subprocess the phase starts. `--excess-effect` calibrates the
card and runs `bench_quota`'s q25 sweep tenant without and with the table
(`excess_effect`), one `EXCESS_EFFECT {json}` line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import threading
import time
from pathlib import Path

from vtpu_manager_torch import bench_allocate as ba
from vtpu_manager_torch import bench_monitor as bm
from vtpu_manager_torch import bench_quota as bq
from vtpu_manager_torch.build import REPO
from vtpu_manager_torch.util import consts

GIB = 2**30
DIM = 8192
STEPS = 200            # inside one ring
SOLO_STEPS = 40
LATE_BEFORE = 30
LATE_AFTER = 30
DURATION_REL = 0.10
SHARE_BAND = 15.0      # the enforcement phase's band
SHARE_FROM = 20        # steps before it are the tenant's warm-up
# pod: (cores %, memory GiB, kubelet's slot)
PODS = {"pod-obs": (50, 16, 0), "pod-late": (0, 8, 1)}
CHECKS = ("calibration", "unmodified", "late")


class Phase:
    def __init__(self, torch, shim: str, root: str):
        from vtpu_manager_torch.deviceplugin.vnum import install_interposer
        self.torch = torch
        self.root = Path(root)
        self.node: ba.Node | None = None
        self.tenants: dict[str, bq.Tenant] = {}
        self.exporter: bm.Exporter | None = None
        self.responses: dict = {}
        try:
            self._start(shim, install_interposer)
        except BaseException:
            self.close()
            raise

    def _start(self, shim: str, install_interposer) -> None:
        root, torch = str(self.root), self.torch
        # the interposer where the node's driver mount puts it: the
        # tenants preload it from their start
        preload = install_interposer(shim, str(self.root / "driver"))
        t0 = time.perf_counter()
        node_err: list[BaseException] = []

        def start_node():
            try:
                self.node = ba.Node(root, shim, obs_calibrate="1")
            except BaseException as e:  # noqa: BLE001 - raised below
                node_err.append(e)

        starter = threading.Thread(target=start_node)
        starter.start()
        try:
            self._start_tenants(preload)
        finally:
            starter.join()
        self.ready_s = self.tenants_s - t0
        self.node_s = time.perf_counter() - t0
        if node_err:
            raise node_err[0]
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")

    def _start_tenants(self, preload: str) -> None:
        """Both tenants, preloaded, until each says READY (torch imported,
        the card untouched)."""
        base = {k: v for k, v in os.environ.items()
                if not k.startswith(("VTPU_", "DISABLE_VTPU"))
                and k not in (consts.ENV_LD_PRELOAD, "CUDA_VISIBLE_DEVICES")}
        base[consts.ENV_LD_PRELOAD] = preload
        base["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
        for pod in PODS:
            args = ["-m", "vtpu_manager_torch.bench_observation", "--tenant",
                    "--env-file", str(self.root / f"{pod}.env"),
                    "--go-file", str(self.root / f"{pod}.go")]
            if pod == "pod-late":
                args += ["--steps", str(LATE_BEFORE + LATE_AFTER),
                         "--late", str(LATE_BEFORE)]
            self.tenants[pod] = bq.Tenant(pod, args, dict(base),
                                          str(self.root))
        for t in self.tenants.values():
            t.line("READY")
        self.tenants_s = time.perf_counter()

    def close(self) -> None:
        for t in self.tenants.values():
            t.stop()
        if self.exporter is not None:
            self.exporter.close()
        if self.node is not None:
            self.node.close()

    def _ring(self, pod: str):
        from vtpu_manager_torch.telemetry.stepring import StepRingReader
        reader = StepRingReader(os.path.join(
            self.node.base_dir, f"{bm.pod_uid(pod)}_main",
            consts.TELEMETRY_SUBDIR, consts.STEP_RING_NAME))
        try:
            return reader.poll(0)
        finally:
            reader.close()

    # --- 1. the calibration ------------------------------------------------

    def check_calibration(self) -> dict:
        from vtpu_manager_torch.config.tc_watcher import TcUtilFile
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import device_id
        from vtpu_manager_torch.manager.obs_calibrate import (GAPS_MS,
                                                              decode_table)
        node, chip = self.node, self.chip
        raw = node.manager.obs_excess_table
        table = decode_table(raw) if raw else None
        plugin = node.plugin(True)
        for pod, (cores, gib, slot) in PODS.items():
            node.client.add_pod(ba.committed_pod(pod, chip, cores, gib * GIB))
            (self.responses[pod],) = plugin.allocate(api.AllocateRequest(
                [api.ContainerAllocateRequest(
                    [device_id(chip.uuid, slot)])])).container_responses
            (self.root / f"{pod}.env").write_text(json.dumps(
                ba.container_env(self.responses[pod])))
        feed = TcUtilFile(os.path.join(node.watcher_dir, os.path.basename(
            consts.TC_UTIL_CONFIG)))
        try:
            feed_table = feed.read_calibration()
        finally:
            feed.close()
        checkpoint = str(self.root / "kubelet_internal_checkpoint")
        bm.write_checkpoint(checkpoint, [])
        node_config = self.root / "node-config.json"
        node_config.write_text(json.dumps({"default": {
            "deviceSplitCount": ba.SPLIT}}))
        self.exporter = bm.Exporter(self.root, node, checkpoint,
                                    str(node_config), tag="observation")
        _, samples = self.exporter.metrics()
        gauge = bm.value(samples, "vtpu_node_obs_excess_max_us")
        annotation = node.client.get_node(node.name)["metadata"][
            "annotations"].get(consts.node_obs_overhead_annotation())
        rec = {"table": raw, "calibration_s": node.calibration_s,
               "tenants_ready_s": self.ready_s, "node_ready_s": self.node_s,
               "feed_table": feed_table, "annotation": annotation,
               "exporter_max_us": gauge,
               "envs": {p: r.envs.get(consts.ENV_OBS_EXCESS_TABLE)
                        for p, r in self.responses.items()}}
        rec["ok"] = bool(
            table is not None and table[0] == (0, 0)
            and [g for g, _ in table[1:]] == [g * 1000 for g in GAPS_MS]
            and feed_table == table and annotation == raw
            and all(v == raw for v in rec["envs"].values())
            and gauge == max(e for _, e in table))
        self.table = table
        return rec

    # --- 2. a tenant that never writes its ring ----------------------------

    def _solo_wall_s(self) -> float:
        """The tenant's step alone, in this process (no interposer): the
        median wall of SOLO_STEPS steps, each ending in its readback."""
        torch = self.torch
        from vtpu_manager_torch.bench_steps import (ATTN_SHAPE, _quota_input,
                                                    _quota_step)
        # registers torch.ops.vtpu.attn_block
        from vtpu_manager_torch.workloads import block_attention  # noqa: F401
        dev = torch.device("cuda")
        x = _quota_input(DIM, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn(ATTN_SHAPE, generator=gen, device=dev)
                   for _ in range(3))
        bias = torch.zeros((ATTN_SHAPE[2], ATTN_SHAPE[2]), device=dev)
        walls = []
        for i in range(SOLO_STEPS + 5):
            t0 = time.perf_counter()
            x, loss = _quota_step(x)
            torch.ops.vtpu.attn_block(q, k, v, bias)
            _ = float(loss)
            if i >= 5:
                walls.append(time.perf_counter() - t0)
        del x, q, k, v, bias
        torch.cuda.empty_cache()
        return statistics.median(walls)

    def check_unmodified(self) -> dict:
        pod = "pod-obs"
        solo_s = self._solo_wall_s()
        (self.root / f"{pod}.go").touch()
        worker = self.tenants[pod].line("WORKER ", timeout=300)
        self.tenants[pod].proc.wait(timeout=60)
        recs, head, drops = self._ring(pod)
        _, samples = self.exporter.metrics()
        folded = bm.value(samples, "vtpu_tenant_step_duration_seconds_count",
                          pod_uid=bm.pod_uid(pod), container="main")
        walls = worker["walls_ns"]
        durs = [r.duration_ns for r in recs]
        compiled = [r.index for r in recs if r.compiled]
        steady = walls[SHARE_FROM:]
        share = 100.0 * solo_s / (sum(steady) / len(steady) / 1e9)
        med_rec, med_wall = statistics.median(durs or [0]), \
            statistics.median(walls)
        rec = {"steps": len(walls), "records": len(recs), "head": head,
               "drops": drops, "shim_records": worker["step_records"],
               "median_record_ms": med_rec / 1e6,
               "median_wall_ms": med_wall / 1e6,
               "duration_rel": med_rec / med_wall - 1.0,
               "wait_sum_ns": sum(r.throttle_wait_ns for r in recs),
               "wait_counter_ns": worker["vtpu_throttle_wait_ns_total"],
               "compiled": compiled, "hbm_highwater": [
                   recs[0].hbm_highwater_bytes, recs[-1].hbm_highwater_bytes]
               if recs else None,
               "folded_count": folded, "solo_step_ms": solo_s * 1e3,
               "share": share, "excess_at": worker["excess_at"],
               "attn_block_launches": worker["attn_block_launches"],
               "launches": worker["vtpu_launches_total"]}
        want = {str(g): e for g, e in self.table} if self.table else None
        rec["adopted"] = want is not None and worker["excess_at"] == want
        rec["ok"] = bool(
            rec["adopted"] and drops == 0
            and abs(len(recs) - len(walls)) <= 1
            and head == len(recs) == worker["step_records"]
            and abs(rec["duration_rel"]) <= DURATION_REL
            and rec["wait_sum_ns"] == rec["wait_counter_ns"] > 0
            and compiled and compiled == list(range(len(compiled)))
            and len(compiled) <= 2 and recs[-1].hbm_highwater_bytes > 0
            and folded == len(recs)
            and abs(share - PODS[pod][0]) <= SHARE_BAND
            and rec["attn_block_launches"] == len(walls))
        return rec

    # --- 3. a Python writer that arms late ---------------------------------

    def check_late(self) -> dict:
        pod = "pod-late"
        (self.root / f"{pod}.go").touch()
        worker = self.tenants[pod].line("WORKER ", timeout=300)
        self.tenants[pod].proc.wait(timeout=60)
        recs, head, drops = self._ring(pod)
        shim_n = worker["step_records"]
        python = recs[shim_n:]
        rec = {"records": len(recs), "head": head, "drops": drops,
               "shim_records": shim_n, "python_records": len(python),
               "indices_continuous": [r.index for r in recs]
               == list(range(len(recs))),
               "python_durations_match": [r.duration_ns for r in python]
               == worker["walls_ns"][LATE_BEFORE:],
               "attn_block_launches": worker["attn_block_launches"]}
        rec["ok"] = bool(
            drops == 0 and head == len(recs) and rec["indices_continuous"]
            and abs(shim_n - LATE_BEFORE) <= 1 and len(python) == LATE_AFTER
            and rec["python_durations_match"])
        return rec


def _tenant(args) -> None:
    import torch

    from vtpu_manager_torch.bench_quota import shim_counters, _wait_file

    from vtpu_manager_torch.bench_steps import (ATTN_SHAPE, _quota_input,
                                                _quota_step)
    from vtpu_manager_torch.runtime.client import step_telemetry
    from vtpu_manager_torch.workloads import block_attention as attn
    print("READY", flush=True)
    # the card stays untouched until the go: the container's environment
    # first, then CUDA
    _wait_file(args.go_file)
    with open(args.env_file) as f:
        os.environ.update(json.load(f))
    dev = torch.device("cuda")
    x = _quota_input(args.dim, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(ATTN_SHAPE, generator=gen, device=dev)
               for _ in range(3))
    bias = torch.zeros((ATTN_SHAPE[2], ATTN_SHAPE[2]), device=dev)
    tel = None
    walls = []
    for i in range(args.steps):
        if args.late and i == args.late:
            tel = step_telemetry()
            if tel is None:
                raise RuntimeError("step_telemetry() armed no writer")
        s0 = time.monotonic_ns()
        x, loss = _quota_step(x)
        torch.ops.vtpu.attn_block(q, k, v, bias)
        _ = float(loss)
        walls.append(time.monotonic_ns() - s0)
        if tel is not None:
            tel.record(walls[-1], start_mono_ns=s0)
    lib = ctypes.CDLL(os.environ[consts.ENV_LD_PRELOAD].split(":")[0])
    lib.vtpu_step_records_total.restype = ctypes.c_uint64
    lib.vtpu_obs_excess_at_us.restype = ctypes.c_int64
    lib.vtpu_obs_excess_at_us.argtypes = [ctypes.c_int64]
    from vtpu_manager_torch.manager.obs_calibrate import GAPS_MS
    print("WORKER " + json.dumps({
        "pid": os.getpid(), "walls_ns": walls,
        "step_records": int(lib.vtpu_step_records_total()),
        "excess_at": {str(g): int(lib.vtpu_obs_excess_at_us(g))
                      for g in (0, *(1000 * g for g in GAPS_MS))},
        "attn_block_launches": attn.LAUNCHES["attn_block"],
        **shim_counters()}), flush=True)


def excess_effect(shim: str, table: str, quota: int = 25,
                  rounds: int = 2) -> dict:
    """What the table does to a throttled tenant: `bench_quota`'s sweep
    tenant at `quota` beside its quota-100 pair (the share is their walls'
    ratio), without and with `VTPU_OBS_EXCESS_TABLE`, in turns (none,
    table, table, none, ...), with the charge per timed step and the
    probe's estimate of each quota tenant."""
    out: dict = {"table": table, "quota": quota, "none": [], "table_on": []}
    for tag in ["none", "table_on", "table_on", "none"] * rounds:
        env = ({consts.ENV_OBS_EXCESS_TABLE: table} if tag == "table_on"
               else {})
        r100 = bq.run_worker(shim, 100, extra_env=env)
        rq = bq.run_worker(shim, quota, extra_env=env)
        if r100 is None or rq is None:
            raise RuntimeError(f"a sweep tenant failed ({tag})")
        out[tag].append({
            "share": 100.0 * r100["ms_per_step"] / rq["ms_per_step"],
            "ms_per_step": [r100["ms_per_step"], rq["ms_per_step"]],
            "obs_overhead_ns": rq.get("vtpu_obs_overhead_ns"),
            "charged_ns_per_step": rq.get("charged_ns_per_step")})
    return out


def _excess_effect_main() -> int:
    """`--excess-effect`: the table measured on this card, then
    `excess_effect` at q25; one `EXCESS_EFFECT {json}` line."""
    import torch

    from vtpu_manager_torch import build
    from vtpu_manager_torch.manager.obs_calibrate import \
        calibrate_in_subprocess
    if not torch.cuda.is_available():
        print("bench_observation: no CUDA device", file=sys.stderr)
        return 1
    shim = str(build.build_shim())
    table = calibrate_in_subprocess()
    if table is None:
        print("bench_observation: the calibration gave no table",
              file=sys.stderr)
        return 1
    print("EXCESS_EFFECT " + json.dumps(excess_effect(shim, table)),
          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenant", action="store_true")
    ap.add_argument("--env-file")
    ap.add_argument("--go-file")
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--late", type=int, default=0,
                    help="call step_telemetry() after this many steps and "
                    "record the rest (0: never)")
    ap.add_argument("--excess-effect", action="store_true",
                    help="calibrate this card, then run a q25 sweep tenant "
                    "without and with the table")
    args = ap.parse_args(argv)
    if args.excess_effect:
        return _excess_effect_main()
    if not args.tenant:
        ap.error("bench_observation runs as a tenant or with "
                 "--excess-effect; the phase is driven by chip_smoke.py")
    _tenant(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
