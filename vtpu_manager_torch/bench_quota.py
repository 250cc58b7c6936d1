"""Enforcement checks: the quota sweep, the exact memory cap, and several
tenants on one card.

Ports `bench.py:293 paired_quota_sweep`, `bench.py:536 run_hbm_check`,
`bench.py:579 run_fake_sweep` and the co-tenancy harness of
`tests/test_multitenant.py:36-90`. Each measurement on the card runs in a
fresh tenant subprocess with the interposer preloaded (the preload reaches
that subprocess only):

- quota sweep: the step loop of `bench_steps.quota_step_measure` at quotas
  100/50/25, limits in the environment. A quota's share is t(100)/t(q)
  from a back-to-back pair, and the tracking error is |share - q|,
  averaged over the throttled quotas;
- memory cap: under a 64 MiB cap the card must report a 64 MiB total and
  a 256 MiB tensor must fail with torch.cuda.OutOfMemoryError;
- fake sweep: the same quotas against the fake driver, with no card,
  paired as the card's sweep is (`paired_fake_sweep`);
- co-tenancy (`World`, `run_tenants`): tenants that each read their limits
  from their own `vtpu.config` (`tenant_config`, fields as the device
  plugin writes them, `deviceplugin/vnum.py:370-399`) and share one memory
  ledger, one utilization feed and one lock directory.

The tenants of the sweep and the harness runs get a node of their own too:
a private directory under $TMPDIR for the lock directory, ledger, feed and
config paths, so they never touch the node's fixed paths
(/tmp/.vtpu_lock, /tmp/.vmem_node, /etc/vtpu-manager) or meet another
process's runs there.

Run `python -m vtpu_manager_torch.bench_quota --worker ...` (or
`--hold-worker`) only as the tenant subprocess these functions start.
"""

from __future__ import annotations

import argparse
import atexit
import ctypes
import itertools
import json
import os
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from vtpu_manager_torch import build
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.tc_watcher import TcUtilFile
from vtpu_manager_torch.config.vmem import VmemLedger
from vtpu_manager_torch.runtime.client import effective_limits, install
from vtpu_manager_torch.util import consts

QUOTAS = (100, 50, 25)
CAP_BYTES = 64 * 2**20
OVER_CAP_SHAPE = (64, 1024, 1024)     # 256 MiB of float32


_private_root: str | None = None


def private_node_env() -> dict:
    """The node paths of a node of this process's own: the lock directory
    in a private directory under $TMPDIR (removed at exit), and a config
    file, ledger and feed there that do not exist, so the limits come from
    the environment and no co-tenant is seen."""
    global _private_root
    if _private_root is None or not os.path.isdir(_private_root):
        _private_root = tempfile.mkdtemp(prefix="vtpu-node-")
        atexit.register(shutil.rmtree, _private_root, True)
    root = Path(_private_root)
    return {consts.ENV_LOCK_DIR: str(root / "locks"),
            consts.ENV_CONFIG_PATH: str(root / "vtpu.config"),
            consts.ENV_VMEM_PATH: str(root / "vmem_node.config"),
            consts.ENV_TC_UTIL_PATH: str(root / "tc_util.config")}


def tenant_env(shim: str | None, quota: int = 100,
               mem_limit: int = 0) -> dict:
    """This process's environment plus the interposer (none when `shim` is
    None: the overhead baseline), a private node and the limits."""
    env = dict(os.environ)
    if shim is not None:
        env.update(install(shim_path=shim) or {})
    env.update(private_node_env())
    env["VTPU_CORE_LIMIT_0"] = str(quota if quota < 100 else 0)
    env["VTPU_MEM_LIMIT_0"] = str(mem_limit)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(build.REPO), env.get("PYTHONPATH")) if p)
    return env


def _run_tenant(args: list[str], env: dict, tag: str,
                timeout: int, pools: dict | None = None) -> dict | None:
    """The tenant's `<tag> {json}` record, or None when it failed. With
    `pools` (TenantPool by the preload its processes were started with,
    "" for none) the tenant is a pooled process: its imports done ahead."""
    if pools is not None:
        t = pools[env.get(consts.ENV_LD_PRELOAD, "")].take(
            tag.lower(), args, env, timeout)
        try:
            return t.line(f"{tag} ", timeout)
        except (RuntimeError, TimeoutError) as e:
            print(f"{tag} failed: {e}", file=sys.stderr)
            return None
        finally:
            try:
                t.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass        # stop() kills it
            t.stop()
    try:
        res = subprocess.run([sys.executable, *args], env=env,
                             cwd=str(build.REPO), capture_output=True,
                             text=True, timeout=timeout, check=False)
    except subprocess.TimeoutExpired:
        print(f"{tag} timed out", file=sys.stderr)
        return None
    for line in res.stdout.splitlines():
        if line.startswith(f"{tag} "):
            return json.loads(line[len(tag) + 1:])
    print(f"{tag} failed (rc={res.returncode}):\n{res.stdout[-600:]}\n"
          f"{res.stderr[-1500:]}", file=sys.stderr)
    return None


# A sweep tenant's steps. Its share is the ratio of two tenants' walls, so
# the timed section must outlast a stall of the shared host: at 30 steps of
# 1.8 ms, one 8 ms stall in either tenant moves the share by 15 points.
SWEEP_WARMUP = 30
SWEEP_STEPS = 150


def run_worker(shim: str | None, quota: int, dim: int = 8192,
               warmup: int = SWEEP_WARMUP, steps: int = SWEEP_STEPS,
               timeout: int = 300, extra_env: dict | None = None,
               pools: dict | None = None) -> dict | None:
    """One tenant run of the step loop at `quota` (`shim` None: no
    interposer), with `extra_env` over its environment. At quota 100
    under the interposer the tenant also launches the block-attention
    kernel once, to show the interposer meters a hand-written kernel
    too. `pools`: as `_run_tenant`'s."""
    args = ["-m", "vtpu_manager_torch.bench_quota", "--worker",
            "--dim", str(dim), "--warmup", str(warmup),
            "--steps", str(steps)]
    if shim is not None and quota >= 100:
        args.append("--kernel")
    env = {**tenant_env(shim, quota), **(extra_env or {})}
    return _run_tenant(args, env, "WORKER", timeout, pools)


GRAPH_QUOTAS = (50, 25)


def run_graph_worker(shim: str, quota: int, capture_mode: str = "global",
                     dim: int = 8192, warmup: int = SWEEP_WARMUP,
                     steps: int = SWEEP_STEPS, timeout: int = 300,
                     pools: dict | None = None) -> dict | None:
    """One tenant run of the quota step and one block-attention launch
    (`bench_steps.graph_step_measure`): eager at quota 100, replayed from
    a CUDA graph below it, captured in `capture_mode` (torch's
    capture_error_mode). The tenant also makes one cooperative launch."""
    args = ["-m", "vtpu_manager_torch.bench_quota", "--worker", "--graph",
            "--capture-mode", capture_mode, "--dim", str(dim), "--warmup",
            str(warmup), "--steps", str(steps)]
    return _run_tenant(args, tenant_env(shim, quota), "WORKER", timeout,
                       pools)


def graph_sweep(shim: str, capture_mode: str = "global",
                pools: dict | None = None) -> dict:
    """Graph tenants at GRAPH_QUOTAS, each paired with an eager tenant of
    the same step at quota 100 (`paired_quota_sweep`). A tenant that
    failed leaves its quota out of the shares."""
    times, shares, records = paired_quota_sweep(
        lambda q: run_graph_worker(shim, q, capture_mode, pools=pools),
        GRAPH_QUOTAS)
    return {"ms_per_step": times, "shares": shares, "records": records,
            "capture_mode": capture_mode}


def graph_sweep_ok(sweep: dict, band: float) -> dict:
    """The F1 verdicts of a graph sweep: shares within `band` of their
    quotas and in order; every replay counted by the interposer; nothing
    charged during a capture that held captured launches; one cooperative
    launch counted in every tenant."""
    shares = sweep["shares"]
    graphs = [r for r in sweep["records"] if r.get("graph")]
    out = {
        "shares": all(q in shares and abs(shares[q] - q) <= band
                      for q in GRAPH_QUOTAS)
        and shares[50] > shares[25],
        "replays_counted": len(graphs) == len(GRAPH_QUOTAS) and all(
            r.get("graph_launches_timed") == r["timed_steps"]
            for r in graphs),
        "capture_uncharged": bool(graphs) and all(
            r.get("capture_vtpu_charged_ns_total") == 0
            and r.get("capture_vtpu_captured_launches_total", 0) > 0
            for r in graphs),
        "cooperative_counted": bool(sweep["records"]) and all(
            r["cooperative_rc"] == 0
            and r["cooperative_shim_launches_delta"] == 1
            for r in sweep["records"]),
    }
    out["ok"] = all(out.values())
    return out


def run_entry_check(shim: str, timeout: int = 300,
                    pools: dict | None = None) -> dict | None:
    """Under the 64 MiB cap, each allocating entry the CUDA runtime does not
    reach by cuMemAlloc_v2 (`ENTRY_CHECKS`), called through ctypes on
    libcuda.so.1: its verdicts for 256 MiB, then 32 MiB, its free, and
    32 MiB again."""
    return _run_tenant(["-m", "vtpu_manager_torch.bench_quota",
                        "--entry-worker"],
                       tenant_env(shim, 100, mem_limit=CAP_BYTES), "ENTRIES",
                       timeout, pools)


def paired_quota_sweep(run, quotas=QUOTAS, reps: int = 1
                       ) -> tuple[dict[int, float], dict[int, float],
                                  list[dict]]:
    """(ms/step per quota, share % per quota, every worker's record).

    `run(quota)` returns a worker record or None. Each rep runs (t100, tq)
    back to back and the pair with the least summed wall gives the share,
    so both sides of the ratio come from one moment of the machine."""
    times: dict[int, float] = {}
    shares: dict[int, float] = {}
    records: list[dict] = []
    for quota in quotas:
        best = None
        for _ in range(max(1, reps)):
            r100 = run(100)
            rq = run(quota)
            records += [r for r in (r100, rq) if r is not None]
            if r100 is None or rq is None:
                continue
            t100, tq = r100["ms_per_step"], rq["ms_per_step"]
            if 100 not in times or t100 < times[100]:
                times[100] = t100
            if best is None or t100 + tq < sum(best):
                best = (t100, tq)
        if best is not None:
            times[quota] = best[1]
            shares[quota] = 100.0 * best[0] / best[1]
    return times, shares, records


def tracking_mae(shares: dict[int, float]) -> float | None:
    """Mean |share - quota| over the throttled quotas."""
    errs = [abs(s - q) for q, s in shares.items() if q < 100]
    return sum(errs) / len(errs) if errs else None


def run_hbm_check(shim: str, timeout: int = 300,
                  pools: dict | None = None) -> dict:
    """Exact-cap check. `error` is 0 when the cap held with the right error
    and the capped view, 100 on a violation or a wrong error class, None
    when the check could not run."""
    out = _run_tenant(["-m", "vtpu_manager_torch.bench_quota",
                       "--hbm-worker"],
                      tenant_env(shim, 100, mem_limit=CAP_BYTES), "HBM",
                      timeout, pools)
    if out is None:
        return {"error": None}
    ok = out["verdict"] == "oom" and out["total"] == CAP_BYTES
    return {**out, "cap": CAP_BYTES, "error": 0 if ok else 100}


def fake_harness_env(**extra) -> dict:
    """The environment of the interposer's harness against the fake
    driver: this process's environment without any VTPU_* variable, on a
    private node (no config file, ledger or feed unless `extra` names
    them)."""
    shim = str(build.build_shim())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "DISABLE_VTPU", "FAKE_", "SHIM_"))}
    env.update({"LD_PRELOAD": shim, "SHIM_PATH": shim,
                "VTPU_REAL_CUDA_LIBRARY_PATH": str(build.build_fake_driver()),
                **private_node_env()})
    env.update({k: str(v) for k, v in extra.items()})
    return env


def parse_harness(stdout: str) -> dict:
    """wall_ms (and the fake's own_busy_ns beside it), VERDICT lines by
    label and the COUNTERS line's values."""
    out: dict = {"verdicts": {}}
    for line in stdout.splitlines():
        parts = line.split()
        if line.startswith("wall="):
            out["wall_ms"] = float(line.split("=")[1].split("ms")[0])
            for f in parts[1:]:
                if f.startswith("own_busy_ns="):
                    out["own_busy_ns"] = int(f.split("=")[1])
        elif parts and parts[0] == "VERDICT":
            out["verdicts"][parts[1]] = int(parts[2])
        elif parts and parts[0] == "COUNTERS":
            out.update({k: int(v) for k, v in
                        (f.split("=") for f in parts[1:])})
    return out


def run_fake_harness(mode: str, timeout: float = 120, **extra) -> dict:
    """One harness run (`--throttle-only`, `--alloc`, ...) against the
    fake driver; its parsed output, with the exit code as `rc`."""
    res = subprocess.run([str(build.build_shim_test()), mode],
                         env=fake_harness_env(**extra), capture_output=True,
                         text=True, timeout=timeout, check=False)
    return {"rc": res.returncode, "stdout": res.stdout, "stderr": res.stderr,
            **parse_harness(res.stdout)}


def paired_fake_sweep(**env) -> tuple[dict[int, float],
                                      dict[int, float]] | None:
    """(ms/step, share %) per quota against the fake driver, paired as the
    card's sweep is (`paired_quota_sweep`): each rep runs (t100, tq) back to
    back, and the pair with the least summed wall gives the share. The
    throttled runs are paced by the interposer; the unthrottled run is not,
    so on a loaded host its wall carries the host's stalls, and one stalled
    t100 of a single unpaired run moves both shares by as much. `env` is
    added to every run's environment (a gate the interposer reads)."""
    iters = 100

    def run(quota: int) -> dict | None:
        res = run_fake_harness(
            "--throttle-only", VTPU_CORE_LIMIT_0=quota if quota < 100 else 0,
            FAKE_EXEC_US=2000, SHIM_TEST_ITERS=iters, **env)
        return ({"ms_per_step": res["wall_ms"] / iters} if "wall_ms" in res
                else None)

    times, shares, _ = paired_quota_sweep(run, QUOTAS, reps=5)
    return (times, shares) if len(shares) == len(QUOTAS) else None


COUNTERS = ("vtpu_launches_total", "vtpu_sampled_launches_total",
            "vtpu_throttle_wait_ns_total", "vtpu_charged_ns_total",
            "vtpu_gap_bypass_total", "vtpu_fail_open_total",
            "vtpu_proc_address_hooked_total", "vtpu_probes_total",
            "vtpu_obs_overhead_ns", "vtpu_watcher_external_total",
            "vtpu_watcher_fallback_total", "vtpu_blind_ticks_total",
            "vtpu_oom_rejected_total", "vtpu_graph_launches_total",
            "vtpu_captured_launches_total", "vtpu_windows_total",
            "vtpu_stand_aside_ns_total", "vtpu_clocked_total",
            # CommTelemetry's totals (0 unarmed)
            "vtpu_comm_time_ns_total", "vtpu_comm_bytes_total",
            "vtpu_collectives_total",
            # the quota market's rewrites adopted, the generation in force
            # and the time launches parked under a migration freeze
            "vtpu_quota_reloads_total", "vtpu_quota_epoch",
            "vtpu_freeze_wait_ns_total",
            # the part of the throttle wait the interposer's ring took
            "vtpu_step_wait_ns_total",
            # HBMOvercommit's overflow tier: grants, refusals, time
            "vtpu_spills_total", "vtpu_spill_rejected_total",
            "vtpu_spill_fill_ns_total")
SIGNED = ("vtpu_charged_ns_total", "vtpu_obs_overhead_ns")
# what a graph tenant reports across its capture
CAPTURE_COUNTERS = ("vtpu_launches_total", "vtpu_sampled_launches_total",
                    "vtpu_charged_ns_total", "vtpu_captured_launches_total")


def tenant_config(path: str, pod_uid: str, *, cap: int = 0,
                  real_memory: int = 0, hard_core: int = 0,
                  soft_core: int | None = None, container: str = "main",
                  uuid: str = "", host_index: int = 0,
                  compat_mode: int = consts.COMPAT_HOST,
                  virtual_memory: int = 0,
                  spill_budget: int = 0) -> vc.VtpuConfig:
    """Writes a tenant's `vtpu.config` with the port's writer, one device,
    its fields as the device plugin sets them (`vnum.py:370-399`): a
    compute limit is hard unless `soft_core` (balance mode) is above it;
    `virtual_memory` and `spill_budget` are HBMOvercommit's."""
    soft = hard_core if soft_core is None else soft_core
    policy = (vc.CORE_LIMIT_NONE if hard_core <= 0 else
              vc.CORE_LIMIT_SOFT if soft > hard_core else vc.CORE_LIMIT_HARD)
    cfg = vc.VtpuConfig(
        pod_uid=pod_uid, pod_name=pod_uid, pod_namespace="default",
        container_name=container, compat_mode=compat_mode,
        devices=[vc.DeviceConfig(
            uuid=uuid, total_memory=cap, real_memory=real_memory,
            hard_core=hard_core, soft_core=soft, core_limit=policy,
            memory_limit=cap > 0, host_index=host_index,
            virtual_hbm_bytes=virtual_memory,
            spill_budget_bytes=spill_budget)])
    vc.write_config(path, cfg)
    return cfg


class World:
    """One node's shared state in a directory: the memory ledger, the
    utilization feed, the per-device locks, and one config file per
    tenant container."""

    def __init__(self, root: str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.vmem_path = str(self.root / "vmem_node.config")
        self.tc_path = str(self.root / "tc_util.config")
        self.lock_dir = str(self.root / "locks")
        VmemLedger(self.vmem_path, create=True).close()
        TcUtilFile(self.tc_path, create=True).close()

    def env(self, shim: str, pod_uid: str, container: str = "main",
            **config) -> dict:
        """A tenant container's environment: the interposer, its own
        config file (written here), the node's shared files, and no
        VTPU_*_LIMIT variable."""
        path = str(self.root / f"{pod_uid}_{container}" / "vtpu.config")
        tenant_config(path, pod_uid, container=container, **config)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("VTPU_", "DISABLE_VTPU"))}
        env.update(install(shim_path=shim) or {})
        env.update({
            consts.ENV_CONFIG_PATH: path, consts.ENV_POD_UID: pod_uid,
            consts.ENV_CONTAINER_NAME: container,
            consts.ENV_VMEM_PATH: self.vmem_path,
            consts.ENV_TC_UTIL_PATH: self.tc_path,
            consts.ENV_LOCK_DIR: self.lock_dir,
            "PYTHONPATH": os.pathsep.join(
                p for p in (str(build.REPO), os.environ.get("PYTHONPATH"))
                if p)})
        return env

    def go_file(self, name: str) -> str:
        return str(self.root / f"{name}.go")


class Tenant:
    """A tenant subprocess whose stdout lines are read as they come; its
    stderr goes to a file beside the world's state."""

    def __init__(self, tag: str, args: list[str], env: dict, log_dir: str,
                 stdin: bool = False, cwd: str | None = None):
        self.tag = tag
        self.err_path = os.path.join(log_dir, f"{tag}.stderr")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen([sys.executable, *args], env=env,
                                     cwd=cwd or str(build.REPO),
                                     stdin=subprocess.PIPE if stdin else None,
                                     stdout=subprocess.PIPE,
                                     stderr=self._err, text=True, bufsize=1)
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line.rstrip("\n"))
        self._lines.put(None)

    def line(self, prefix: str, timeout: float = 300.0) -> dict | None:
        """The JSON after the next line starting with `prefix` (an empty
        dict for a bare marker line)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._lines.get(timeout=max(
                    0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"{self.tag}: no {prefix} line")
            if line is None:
                self.proc.wait()
                raise RuntimeError(f"{self.tag} exited "
                                   f"(rc={self.proc.returncode}):\n"
                                   f"{self.stderr_tail()}")
            if line.startswith(prefix):
                rest = line[len(prefix):].strip()
                return json.loads(rest) if rest else {}

    def send(self, line: str) -> None:
        """One command line to a tenant started with `stdin`."""
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def horizon_log(self, n: int = 20) -> list[str]:
        """The interposer's lines on horizons it found suspect and on
        going blind (logged at VTPU_LOGGER_LEVEL 2 and 1)."""
        self._err.flush()
        return [line for line in Path(self.err_path).read_text().splitlines()
                if "horizon suspect" in line or "judged blind" in line][:n]

    def stderr_tail(self, n: int = 1500) -> str:
        self._err.flush()
        return Path(self.err_path).read_text()[-n:]

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._err.close()


def worker_args(steps: int, *, go_file: str | None = None,
                warmup_s: float = 0.0, device_times: int = 0,
                dim: int = 8192, profile_after: int = 0) -> list[str]:
    args = ["-m", "vtpu_manager_torch.bench_quota", "--worker", "--dim",
            str(dim), "--warmup", "10", "--steps", str(steps),
            "--device-times", str(device_times), "--warmup-s", str(warmup_s),
            "--profile-after", str(profile_after)]
    return args + (["--go-file", go_file] if go_file else [])


def hold_args(alloc_gib: str, go_file: str, hold_file: str,
              retry_s: float = 0.0) -> list[str]:
    return ["-m", "vtpu_manager_torch.bench_quota", "--hold-worker",
            "--alloc-gib", alloc_gib, "--go-file", go_file, "--hold-file",
            hold_file, "--retry-s", str(retry_s)]


class TenantPool:
    """Worker processes started ahead, each with the imports done (about
    9 s of a card machine's CPU, PERF.md §6, PR 16) and no CUDA call made,
    waiting for the tenant it is to become (`--pooled`): so a check's
    tenants start from their context and warm-up, not from `import torch`.
    Each is started under the interposer `preload` and takes a tenant's
    environment only before its first CUDA call. `refill()` starts new ones
    up to `size`; `run_tenants` calls it once every tenant of its batch
    has finished its timed steps, so an import never runs beside a timed
    stretch of that batch. `module` is the tenants' bench (its `--pooled`
    takes the ticket: `run_pooled`)."""

    _count = itertools.count()

    def __init__(self, log_dir: str, preload: str, size: int,
                 module: str = "vtpu_manager_torch.bench_quota"):
        self.log_dir = log_dir
        self.module = module
        # the pool's processes, tickets and logs, apart from another pool's
        # in the same directory
        self.name = f"pool{next(TenantPool._count)}"
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith(("VTPU_", "DISABLE_VTPU"))}
        self.env.update({"LD_PRELOAD": preload, "PYTHONPATH": os.pathsep.join(
            p for p in (str(build.REPO), os.environ.get("PYTHONPATH")) if p)})
        self.size = size
        self.idle: list[tuple[Tenant, str]] = []
        self.loaded: set[str] = set()
        self.started = 0
        self.refill()

    def wait_loaded(self, timeout: float = 300.0) -> None:
        """Returns once every idle process has its imports done: no
        import then runs beside a timed tenant."""
        for t, _ in self.idle:
            if t.tag not in self.loaded:
                t.line("LOADED", timeout)
                self.loaded.add(t.tag)

    def refill(self) -> None:
        while len(self.idle) < self.size:
            self.started += 1
            tag = f"{self.name}-{self.started}"
            ticket = os.path.join(self.log_dir, f"{tag}.ticket")
            self.idle.append((Tenant(tag, [
                "-m", self.module, "--pooled", ticket],
                self.env, self.log_dir), ticket))

    def take(self, tag: str, args: list[str], env: dict,
             timeout: float = 300.0) -> Tenant:
        """The oldest pooled process, once loaded, as tenant `tag`: `args`
        are a worker's of the pool's module (`-m <module> ...`)."""
        if args[:2] != ["-m", self.module]:
            raise ValueError(f"a pooled process runs {self.module}: {args}")
        args = args[2:]
        t, ticket = self.idle.pop(0)
        if t.tag not in self.loaded:
            t.line("LOADED", timeout)
        tmp = f"{ticket}.tmp"
        with open(tmp, "w") as f:
            json.dump({"argv": args, "env": env}, f)
        os.replace(tmp, ticket)
        t.tag = tag
        return t

    def close(self) -> None:
        for t, _ in self.idle:
            t.stop()
        self.idle = []


def run_tenants(world: World, specs: list[tuple[str, list[str], dict]],
                timeout: float = 300.0,
                pool: TenantPool | None = None) -> dict[str, dict]:
    """Starts every (tag, args, env) tenant at once (from `pool` when
    given); each warms up, says READY, and waits for the one go file, so
    the timed loops begin together. Returns each tenant's WORKER record by
    tag."""
    go = world.go_file("together-" + "-".join(t for t, _, _ in specs))
    if pool is None:
        tenants = [Tenant(tag, [*args, "--go-file", go], env,
                          str(world.root)) for tag, args, env in specs]
    else:
        tenants = [pool.take(tag, [*args, "--go-file", go], env, timeout)
                   for tag, args, env in specs]
    try:
        for t in tenants:
            t.line("READY", timeout)
        Path(go).touch()
        if pool is not None:
            for t in tenants:
                t.line("TIMED", timeout)
            pool.refill()
        out = {t.tag: t.line("WORKER ", timeout) for t in tenants}
        # a tenant that exits clears its ledger entries; a killed one
        # leaves them to count against the card until they go stale
        for t in tenants:
            t.proc.wait(timeout=60)
            out[t.tag]["horizon_log"] = t.horizon_log()
        return out
    finally:
        for t in tenants:
            t.stop()


def shim_counters() -> dict:
    """The preloaded interposer's exported counters (those its build
    has); none without it."""
    path = os.environ.get("LD_PRELOAD", "").split(":")[0]
    if not path:
        return {}
    lib = ctypes.CDLL(path)
    out = {}
    for name in COUNTERS:
        fn = getattr(lib, name, None)
        if fn is None:
            continue
        fn.restype = ctypes.c_int64 if name in SIGNED else ctypes.c_uint64
        out[name] = int(fn())
    for name in ("vtpu_up_limit", "vtpu_core_limit"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int]
            out[name] = int(fn(0))
    return out


def _wait_file(path: str | None, timeout_s: float = 300.0,
               poll_s: float = 0.005) -> None:
    deadline = time.monotonic() + timeout_s
    while path and not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(poll_s)


def run_cross_capture(shim: str | None, launches: str = "raw",
                      quota: int = 50, steps: int = 40,
                      timeout: int = 300) -> dict | None:
    """S1 on the card (`_cross_capture_worker`) in a tenant under the
    interposer at `quota` (`shim` None: without it)."""
    args = ["-m", "vtpu_manager_torch.bench_quota", "--cross-capture-worker",
            "--cross-launches", launches, "--steps", str(steps)]
    return _run_tenant(args, tenant_env(shim, quota), "WORKER", timeout)


def _cross_capture_worker(args) -> None:
    """Thread A captures the quota step and one attention launch into a
    torch.cuda.CUDAGraph in torch's default (global) capture mode; while
    the capture is open, thread B launches on a stream of its own, which
    the interposer meters (samples recorded and drained with event
    queries): `args.steps` launches of an empty kernel through the driver
    API (`raw`: nothing but the launch, loaded before the capture), or
    `args.steps` eager quota steps (`torch`). The capture must end valid
    and its replay give the eager outputs."""
    import threading

    import torch

    from vtpu_manager_torch.bench_steps import _quota_input, _quota_step
    from vtpu_manager_torch.workloads import block_attention as ba
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((8, 16, 512, 128), generator=gen, device=dev)
               for _ in range(3))
    bias = torch.zeros((512, 512), device=dev)
    x = _quota_input(args.dim, dev)
    xb = _quota_input(args.dim, dev)
    side_a, side_b = torch.cuda.Stream(), torch.cuda.Stream()
    # warm-ups, so that nothing is allocated or initialised during the
    # capture: B on its own stream, A on a side stream as capture needs
    with torch.cuda.stream(side_b):
        for _ in range(3):
            _quota_step(xb)
    side_a.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side_a):
        for _ in range(3):
            eager_y, _ = _quota_step(x)
            eager_o = ba.attention_block(q, k, v, bias)
    torch.cuda.synchronize()
    cu = _libcuda()
    vp = ctypes.c_void_p
    module, fn = vp(), vp()
    if cu.cuModuleLoadData(ctypes.byref(module), NOOP_PTX) != 0 or \
            cu.cuModuleGetFunction(ctypes.byref(fn), module,
                                   b"vtpu_noop") != 0:
        raise RuntimeError("the empty kernel did not load")
    launch = cu.cuLaunchKernel
    launch.argtypes = [vp] + [ctypes.c_uint] * 7 + [vp, vp, vp]
    stream_b = vp(side_b.cuda_stream)
    capturing, b_done = threading.Event(), threading.Event()
    b_rec: dict = {}

    def thread_b() -> None:
        try:
            capturing.wait(60)
            before = shim_counters()
            rcs = []
            for _ in range(args.steps):
                if args.cross_launches == "raw":
                    rcs.append(launch(fn, 1, 1, 1, 32, 1, 1, 0, stream_b,
                                      None, None))
                    time.sleep(0.001)   # the sample ends before the next
                else:
                    with torch.cuda.stream(side_b):
                        _quota_step(xb)
            b_rec["b_failed_launches"] = sum(rc != 0 for rc in rcs)
            after = shim_counters()
            b_rec.update({f"b_{k}": after[k] - before[k] for k in (
                "vtpu_launches_total", "vtpu_sampled_launches_total",
                "vtpu_captured_launches_total") if k in after})
        except Exception as e:  # noqa: BLE001 - reported in the record
            b_rec["b_error"] = repr(e)
        finally:
            b_done.set()

    t = threading.Thread(target=thread_b)
    t.start()
    graph = torch.cuda.CUDAGraph()
    error = None
    try:
        with torch.cuda.graph(graph):
            capturing.set()
            y, _ = _quota_step(x)
            o = ba.attention_block(q, k, v, bias)
            b_done.wait(120)   # the capture stays open while B launches
    except Exception as e:  # noqa: BLE001 - the verdict under test
        error = repr(e)
    capturing.set()
    t.join(timeout=120)
    out = {"capture_error": error, "launches": args.cross_launches, **b_rec}
    if error is None:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        out["max_abs_err"] = max(
            (y.float() - eager_y.float()).abs().max().item(),
            max((a - b).abs().max().item() for a, b in zip(o, eager_o)))
    print("WORKER " + json.dumps({**out, **shim_counters()}), flush=True)


def _worker(args) -> None:
    import torch

    from vtpu_manager_torch.bench_steps import (graph_step_measure,
                                                kernel_ms_per_step,
                                                quota_step_measure,
                                                step_device_times)
    at_start = {}
    capture = {}

    def before_timed():
        until = time.monotonic() + args.warmup_s   # balance mode's climb
        while time.monotonic() < until:
            quota_step_measure(dim=args.dim, warmup=0, steps=5)
        print("READY", flush=True)
        _wait_file(args.go_file)
        at_start.update(shim_counters(), t=time.monotonic())

    if args.graph:
        # eager at quota 100 (the pair's reference), a graph below it
        devices = effective_limits().devices
        replay = bool(devices) and 0 < devices[0].hard_core < 100
        at_capture = {}

        def around_capture(when: str) -> None:
            # the interposer's counters across the capture alone
            if when == "before":
                at_capture.update(shim_counters())
            else:
                now = shim_counters()
                capture.update({f"capture_{k}": now[k] - at_capture[k]
                                for k in CAPTURE_COUNTERS if k in now})

        ms = graph_step_measure(
            dim=args.dim, warmup=args.warmup, steps=args.steps, graph=replay,
            capture_mode=args.capture_mode, before_timed=before_timed,
            around_capture=around_capture)
    else:
        ms = quota_step_measure(dim=args.dim, warmup=args.warmup,
                                steps=args.steps, device=args.device,
                                before_timed=before_timed)
    t_end = time.monotonic()
    print("TIMED", flush=True)
    out = {"ms_per_step": ms, "steps": args.warmup + args.steps,
           "timed_steps": args.steps, "t_start": at_start["t"],
           "t_end": t_end, "source": effective_limits().source,
           "graph": bool(capture), **capture, **shim_counters()}
    if "vtpu_graph_launches_total" in at_start:
        out["graph_launches_timed"] = (
            out["vtpu_graph_launches_total"]
            - at_start["vtpu_graph_launches_total"])
    if "vtpu_charged_ns_total" in at_start:
        out["charged_ns_per_step"] = (
            out["vtpu_charged_ns_total"]
            - at_start["vtpu_charged_ns_total"]) / args.steps
    if args.profile_after:
        # the tenant's own kernel time at its duty, read by torch.profiler
        # over steps run on at the quota right after the charged stretch,
        # which itself runs unprofiled (CUPTI lengthens an isolated
        # launch's way to the card, and so the charge: PERF.md, PR 16)
        reading = kernel_ms_per_step(lambda: quota_step_measure(
            dim=args.dim, warmup=0, steps=args.profile_after),
            args.profile_after)
        out.update(duty_kernel_ms=reading["median_ms"],
                   duty_kernel_ms_sum=reading["sum_ms"],
                   duty_kernels=reading["kernels"])
    if args.device_times:
        before = shim_counters().get("vtpu_throttle_wait_ns_total", 0)
        times = step_device_times(args.dim, args.device_times, pause_s=0.3)
        out.update(times)
        out["isolated_span_ms"] = statistics.median(times["isolated_ms"])
        out["device_ms_per_step"] = times["loop_kernel_ms"]
        out["device_times_wait_ns"] = (shim_counters().get(
            "vtpu_throttle_wait_ns_total", 0) - before)
    if args.kernel:
        out.update(kernel_launch_once())
    if args.graph:
        out.update(cooperative_launch_once())
    print("WORKER " + json.dumps(out), flush=True)


def kernel_launch_once() -> dict:
    """Launches the block-attention kernel once on the card: how many
    launches its wrapper and the interposer counted for it."""
    import torch

    from vtpu_manager_torch.workloads import block_attention as ba
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((8, 16, 512, 128), generator=gen, device="cuda")
               for _ in range(3))
    bias = torch.zeros((512, 512), device="cuda")
    torch.cuda.synchronize()
    before = shim_counters()["vtpu_launches_total"]
    kernel_before = ba.LAUNCHES["attn_block"]
    ba.attention_block(q, k, v, bias)
    torch.cuda.synchronize()
    return {"kernel_shim_launches_delta":
            shim_counters()["vtpu_launches_total"] - before,
            "kernel_launches_delta": ba.LAUNCHES["attn_block"] - kernel_before}


# an empty kernel, JIT-compiled by the driver: what a cooperative launch
# needs (no torch or library call makes one)
NOOP_PTX = b"""
.version 7.8
.target sm_90
.address_size 64
.visible .entry vtpu_noop()
{
    ret;
}
\0"""


def _libcuda():
    """libcuda.so.1 by ctypes: its symbols come through the interposer's
    dlsym, as the CUDA runtime's do."""
    return ctypes.CDLL("libcuda.so.1")


def cooperative_launch_once() -> dict:
    """One cuLaunchCooperativeKernel of an empty kernel on torch's current
    stream: its driver result and how many launches the interposer
    counted for it."""
    import torch
    torch.cuda.synchronize()
    cu = _libcuda()
    vp = ctypes.c_void_p
    module, fn = vp(), vp()
    rc = cu.cuModuleLoadData(ctypes.byref(module), NOOP_PTX)
    if rc == 0:
        rc = cu.cuModuleGetFunction(ctypes.byref(fn), module, b"vtpu_noop")
    launch = cu.cuLaunchCooperativeKernel
    launch.argtypes = [vp] + [ctypes.c_uint] * 7 + [vp, vp]
    before = shim_counters().get("vtpu_launches_total", 0)
    if rc == 0:
        rc = launch(fn, 1, 1, 1, 32, 1, 1, 0,
                    vp(torch.cuda.current_stream().cuda_stream), None)
    torch.cuda.synchronize()
    return {"cooperative_rc": rc, "cooperative_shim_launches_delta":
            shim_counters().get("vtpu_launches_total", 0) - before}


ENTRY_CHECKS = ("managed", "pitch", "pool")
OOM_RC = 2                           # CUDA_ERROR_OUT_OF_MEMORY


def _entry_alloc(cu, entry: str, nbytes: int, pool, stream):
    """(driver result, pointer) of one allocation through `entry`."""
    ptr = ctypes.c_uint64()
    if entry == "managed":
        rc = cu.cuMemAllocManaged(ctypes.byref(ptr), ctypes.c_size_t(nbytes),
                                  ctypes.c_uint(1))   # CU_MEM_ATTACH_GLOBAL
    elif entry == "pitch":
        pitch = ctypes.c_size_t()
        rc = cu.cuMemAllocPitch_v2(ctypes.byref(ptr), ctypes.byref(pitch),
                                   ctypes.c_size_t(65536),
                                   ctypes.c_size_t(nbytes // 65536),
                                   ctypes.c_uint(4))
    else:
        rc = cu.cuMemAllocFromPoolAsync(ctypes.byref(ptr),
                                        ctypes.c_size_t(nbytes), pool, stream)
    return rc, ptr


def _entry_free(cu, entry: str, ptr, stream) -> int:
    if entry == "pool":
        rc = cu.cuMemFreeAsync(ptr, stream)
        return rc or cu.cuStreamSynchronize(stream)
    return cu.cuMemFree_v2(ptr)


def _entry_worker() -> None:
    import torch
    x = torch.ones((64, 64), device="cuda")
    _ = float(x.sum())                  # context and allocator are up
    cu = _libcuda()
    pool = ctypes.c_void_p()
    cu.cuDeviceGetDefaultMemPool(ctypes.byref(pool), 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out = {}
    for entry in ENTRY_CHECKS:
        over, big = _entry_alloc(cu, entry, 256 * 2**20, pool, stream)
        if over == 0:
            _entry_free(cu, entry, big, stream)
        granted, ptr = _entry_alloc(cu, entry, 32 * 2**20, pool, stream)
        free_at_hold = torch.cuda.mem_get_info()[0]
        freed = _entry_free(cu, entry, ptr, stream) if granted == 0 else None
        again, ptr = _entry_alloc(cu, entry, 32 * 2**20, pool, stream)
        if again == 0:
            _entry_free(cu, entry, ptr, stream)
        out[entry] = {"over": over, "granted": granted, "freed": freed,
                      "again": again, "free_while_held": free_at_hold}
    free, total = torch.cuda.mem_get_info()
    print("ENTRIES " + json.dumps({"entries": out, "free": free,
                                   "total": total, **shim_counters()}),
          flush=True)


def entry_check_ok(rec: dict | None) -> bool:
    """Every entry: 256 MiB refused with CUDA_ERROR_OUT_OF_MEMORY, 32 MiB
    granted, freed, and granted again; the view is the cap."""
    return bool(rec) and rec["total"] == CAP_BYTES and all(
        e["over"] == OOM_RC and e["granted"] == 0 and e["freed"] == 0
        and e["again"] == 0 for e in rec["entries"].values())


def _hold_worker(args) -> None:
    """Allocates each size (GiB) in turn, retrying a refused one for up to
    --retry-s, keeps what it got and holds it until --hold-file exists."""
    import torch
    x = torch.ones((64, 64), device="cuda")
    _ = float(x.sum())                  # context and allocator are up
    print("READY", flush=True)
    _wait_file(args.go_file)
    held, verdicts, granted_at = [], [], []
    for gib in [float(v) for v in args.alloc_gib.split(",") if v]:
        deadline = time.monotonic() + args.retry_s
        while True:
            try:
                held.append(torch.empty(int(gib * 2**30), dtype=torch.uint8,
                                        device="cuda"))
                torch.cuda.synchronize()
                verdicts.append("granted")
                granted_at.append(time.monotonic())
                break
            except torch.cuda.OutOfMemoryError:
                if time.monotonic() >= deadline:
                    verdicts.append("refused")
                    granted_at.append(None)
                    break
                time.sleep(0.05)
    free, total = torch.cuda.mem_get_info()
    print("HOLD " + json.dumps({
        "verdicts": verdicts, "granted_at": granted_at, "free": free,
        "total": total, "source": effective_limits().source,
        **shim_counters()}), flush=True)
    _wait_file(args.hold_file)


def _hbm_worker() -> None:
    import torch
    x = torch.ones((64, 64), device="cuda")
    _ = float((x * 2).sum())           # context and allocator are up
    free, total = torch.cuda.mem_get_info()
    try:
        y = torch.ones(OVER_CAP_SHAPE, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        verdict = "violation"
        del y
    except torch.cuda.OutOfMemoryError:
        verdict = "oom"
    except RuntimeError as e:           # refused, but with the wrong class
        verdict = f"unexpected: {type(e).__name__}: {str(e)[:160]}"
    print("HBM " + json.dumps({"verdict": verdict, "free": free,
                               "total": total,
                               "source": effective_limits().source}),
          flush=True)


def run_pooled(ticket: str, main) -> None:
    """A pooled tenant process: the imports every worker makes, then a
    wait for its ticket (the tenant's argv and environment), which it takes
    as its own before its first CUDA call; the interposer it was started
    with reads its limits only then. Then `main(argv)`."""
    import torch  # noqa: F401

    from vtpu_manager_torch import bench_steps  # noqa: F401
    print("LOADED", flush=True)
    _wait_file(ticket, timeout_s=3600.0, poll_s=0.05)
    with open(ticket) as f:
        job = json.load(f)
    preload = os.environ.get("LD_PRELOAD", "")
    if job["env"].get("LD_PRELOAD", "") != preload:
        raise SystemExit(f"pooled under LD_PRELOAD={preload!r}, the tenant "
                         f"needs {job['env'].get('LD_PRELOAD')!r}")
    os.environ.clear()
    os.environ.update(job["env"])
    main(job["argv"])


def _pooled(ticket: str) -> None:
    run_pooled(ticket, main)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--hbm-worker", action="store_true")
    ap.add_argument("--dim", type=int, default=8192)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--kernel", action="store_true")
    ap.add_argument("--graph", action="store_true",
                    help="the quota step and one attention launch, replayed "
                    "from a CUDA graph below quota 100")
    ap.add_argument("--capture-mode", default="global",
                    choices=("global", "thread_local", "relaxed"))
    ap.add_argument("--entry-worker", action="store_true")
    ap.add_argument("--graph-sweep", metavar="SHIM",
                    help="run the graph sweep under this interposer and "
                    "print GRAPH_SWEEP {json} (on the card)")
    ap.add_argument("--warmup-s", type=float, default=0.0)
    ap.add_argument("--go-file")
    ap.add_argument("--device-times", type=int, default=0,
                    help="after the loop, the step's device time "
                    "(bench_steps.step_device_times, this many loop steps)")
    ap.add_argument("--profile-after", type=int, default=0,
                    help="after the timed steps, this many more at the "
                    "quota under torch.profiler: the kernels' time at "
                    "the tenant's duty")
    ap.add_argument("--cross-capture-worker", action="store_true")
    ap.add_argument("--cross-launches", default="raw",
                    choices=("raw", "torch"))
    ap.add_argument("--hold-worker", action="store_true")
    ap.add_argument("--alloc-gib", default="")
    ap.add_argument("--retry-s", type=float, default=0.0)
    ap.add_argument("--hold-file")
    ap.add_argument("--device", default=None,
                    help="the worker's device: the card unless 'cpu'")
    ap.add_argument("--pooled", metavar="TICKET",
                    help="import, say LOADED, then run as the tenant the "
                    "ticket file names (TenantPool)")
    args = ap.parse_args(argv)
    if args.pooled:
        _pooled(args.pooled)
    elif args.worker:
        _worker(args)
    elif args.cross_capture_worker:
        _cross_capture_worker(args)
    elif args.hold_worker:
        _hold_worker(args)
    elif args.hbm_worker:
        _hbm_worker()
    elif args.entry_worker:
        _entry_worker()
    elif args.graph_sweep:
        sweep = graph_sweep(args.graph_sweep, args.capture_mode)
        print("GRAPH_SWEEP " + json.dumps(
            {**sweep, "verdicts": graph_sweep_ok(sweep, 15.0)}), flush=True)
    else:
        ap.error("bench_quota runs as a tenant worker; the sweep is driven "
                 "by chip_smoke.py")


if __name__ == "__main__":
    main()
