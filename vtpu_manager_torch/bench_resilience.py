"""The node survives its own faults and attributes a CLIENT-mode tenant on
the card: the checks of chip_smoke.py's `resilience` phase.

On a private node (`bench_allocate.Node`: NVML discovery split 4, the
interposer installed, the NVML-fed watcher), the port's device plugin
and DRA driver run in this process, with the failpoint registry armed as
the commands arm it under FaultInjection (`failpoints.arm_from_env`), and
tenants run as subprocesses under the interposer, started from nothing
but the plugin's responses (`bench_allocate.container_env`).

The node has two plugins over one device manager: one with the default
node config and one whose node config has `compat_mode: client`, beside a
`RegistryServer` on a socket in a short `mkdtemp` (what the device
plugin's ClientMode gate and `--registry-socket` start). The card machine
has no kubelet cgroups, so the registry is handed a stand-in
`cgroup_of_pid` / `pids_in_cgroup`, as `tests/test_registry.py`'s fixture
is: every process here lies in the CLIENT pod's cgroup (`pod<uid>` in
its path), whose live members are the pod's two tenant processes.

Checks, each a record with an `ok` verdict:

1. torn_config: `VTPU_FAILPOINTS='plugin.config_write=partial-write(count=1)'`.
   The Allocate of a 25 % / 8 GiB pod crashes (`CrashFailpoint`, caught
   by this check alone); its `vtpu.config` is then shorter than a whole
   record; the retried Allocate writes it whole; a tenant started from
   the retried response reads its limits from the file (source
   `config-file`), its `mem_get_info` total is the claim and twice the
   claim is refused with OutOfMemoryError. (PreStartContainer rewrites
   only a missing config, as the JAX plugin's does: the retry heals it.)
2. torn_cdi: `dra.cdi_write=partial-write(count=1)` armed beside it. The
   DRA driver's Prepare of a claim fails; the spec on disk does not
   parse; the claim is not checkpointed; a fresh `DeviceState` (a
   restart) prepares it whole and checkpoints it;
3. metrics: the device plugin's `/metrics` (`cmd.device_plugin.
   serve_metrics`) counts `vtpu_failpoint_fires_total` for the two sites
   as the registry's `stats()` does; another path answers 404; with the
   registry off (the gate off) no site is armed and nothing is counted;
4. client_mode: the CLIENT pod (25 % / 8 GiB, traced) was allocated when
   the phase started, and its two processes started then, each held at a
   go file once warm, from a directory outside the repo with a
   PYTHONPATH that lacks it (a tenant image without the package; each
   process puts the repo on its own path). Each process's interposer
   starts the stdlib-only registrar the node installed beside it in the
   driver dir (`tools/vtpu_device_client.py`), which registers over the
   socket (F7). Verdicts: each interposer logged that command;
   both registrations accepted; `pids.config`
   holds both tenant pids (with the attested registrar's, as the server
   adds the peer) and decodes; each interposer logged its client pid set
   refreshed with that count; then each process runs `STEPS` steps of the
   quota step and one `vtpu::attn_block` launch, counted by the kernel's
   wrapper; one process holds 6 GiB and the other's 4 GiB is refused
   (the one 8 GiB cap); the pod's timeline holds `shim.register` (the
   registrar's) and `registry.register` once per registration; a
   registration that claims another pod's uid is refused.

Run `python -m vtpu_manager_torch.bench_resilience --tenant ...` only as
the tenant subprocess the phase starts.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
import uuid

from vtpu_manager_torch import bench_allocate as ba
from vtpu_manager_torch import build, trace
from vtpu_manager_torch.resilience import failpoints
from vtpu_manager_torch.util import consts

GIB = 2**30
CORES, MEMORY_GIB = 25, 8
HOLD_GIB, ASK_GIB = 6, 4
STEPS, WARMUP = 20, 5
TENANT_TIMEOUT_S = 240.0
PLUGIN_SPEC = "plugin.config_write=partial-write(count=1)"
DRA_SPEC = "dra.cdi_write=partial-write(count=1)"
CHECKS = ("torn_config", "torn_cdi", "metrics", "client_mode")


def pod_uid(name: str) -> str:
    """A UUID-shaped uid, as the registry requires."""
    return str(uuid.uuid5(uuid.NAMESPACE_DNS, f"vtpu-{name}"))


def fires_scraped(text: str) -> dict[str, int]:
    out = {}
    for line in text.splitlines():
        if line.startswith("vtpu_failpoint_fires_total{"):
            site = line.split('site="', 1)[1].split('"', 1)[0]
            out[site] = int(line.rsplit(" ", 1)[1])
    return out


class Phase:
    def __init__(self, torch, shim: str, root: str):
        from vtpu_manager_torch.config.node_config import NodeConfig
        from vtpu_manager_torch.registry.server import RegistryServer
        self.torch = torch
        self.node = ba.Node(root, shim)
        self.root = self.node.root
        uuid_ = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid_), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid_}")
        self.tenants: dict = {}
        self.metrics = None
        # the CLIENT pod's tenant gets the node trace dir (sampled)
        self.trace_dir = str(self.root / "trace")
        self._node_trace_dir = consts.TRACE_DIR
        consts.TRACE_DIR = self.trace_dir
        trace.configure("plugin", spool_dir=self.trace_dir,
                        sampling_rate=1.0)
        self.client_pod = "pod-client"
        self.client_uid = pod_uid(self.client_pod)
        self.tenant_pids: list[int] = []
        self.reg_dir = tempfile.mkdtemp(prefix="vreg")
        cgroup = f"/kubepods/burstable/pod{self.client_uid}/main"
        self.registry = RegistryServer(
            socket_path=os.path.join(self.reg_dir, "socket.sock"),
            base_dir=self.node.base_dir,
            cgroup_of_pid=lambda pid: cgroup,
            pids_in_cgroup=lambda cg: [p for p in self.tenant_pids
                                       if _alive(p)])
        self.registry.start()
        self.host_plugin = self.node.plugin(False)
        self.client_plugin = self.node.plugin(False)
        self.client_plugin.node_config = NodeConfig(
            device_split_count=ba.SPLIT, compat_mode="client")
        # the CLIENT pod first, and its processes at once: their start-up
        # runs while the fault checks do
        ctx = trace.mint_for_pod({"metadata": {"uid": self.client_uid}})
        self.client_resp = self._allocate(
            self.client_plugin, self.client_pod, 1,
            trace.annotation_values(ctx))
        env = ba.container_env(self.client_resp)
        env[consts.ENV_REGISTRY_SOCKET] = self.registry.socket_path
        env["VTPU_LOGGER_LEVEL"] = "2"       # the pid-set refreshes
        # an image without the package: the registrar must come from the
        # driver dir, not from the repo on the path or in the cwd
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p and os.path.realpath(p) != os.path.realpath(build.REPO))
        env.pop(consts.ENV_DEVICE_CLIENT_CMD, None)
        self.registrar = os.path.join(self.node.driver_dir,
                                      consts.DEVICE_CLIENT_SCRIPT)
        for key, role in (("p1", ["--hold-gib", str(HOLD_GIB),
                                  "--release-file",
                                  str(self.root / "release")]),
                          ("p2", ["--ask-gib", str(ASK_GIB), "--ask-file",
                                  str(self.root / "ask")])):
            self.tenants[key] = self._tenant(key, "client", env, [
                "--go-file", str(self.root / "client.go"), *role],
                outside=True)
            self.tenant_pids.append(self.tenants[key].proc.pid)

    def close(self) -> None:
        try:
            for name in ("release", "ask", "client.go"):
                (self.root / name).touch()
            for t in self.tenants.values():
                try:
                    t.proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pass        # stop() kills it
                t.stop()
            if self.metrics is not None:
                self.metrics.shutdown()
                self.metrics.server_close()
            self.registry.stop()
            shutil.rmtree(self.reg_dir, ignore_errors=True)
            self.node.close()
        finally:
            failpoints.disable()
            trace.reset()
            consts.TRACE_DIR = self._node_trace_dir

    def _allocate(self, plugin, name: str, slot: int,
                  annotations: dict | None = None):
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import device_id
        if not any(p["metadata"]["name"] == name
                   for p in self.node.client.list_pods()):
            pod = ba.committed_pod(name, self.chip, CORES, MEMORY_GIB * GIB)
            pod["metadata"]["uid"] = pod_uid(name)
            pod["metadata"]["annotations"].update(annotations or {})
            self.node.client.add_pod(pod)
        req = api.AllocateRequest([api.ContainerAllocateRequest(
            [device_id(self.chip.uuid, slot)])])
        (resp,) = plugin.allocate(req).container_responses
        return resp

    def _tenant(self, key: str, kind: str, env: dict, extra: list[str],
                outside: bool = False):
        """A tenant process; `outside`: started from the phase's directory
        with the repo on its own sys.path only, so nothing it starts finds
        the package."""
        from vtpu_manager_torch import bench_quota as bq
        argv = ["--tenant", kind, *extra]
        if not outside:
            return bq.Tenant(f"resilience-{key}", [
                "-m", "vtpu_manager_torch.bench_resilience", *argv], env,
                str(self.root))
        return bq.Tenant(f"resilience-{key}", [
            "-c", f"import sys; sys.path.insert(0, {str(build.REPO)!r}); "
            f"from vtpu_manager_torch.bench_resilience import main; "
            f"main({argv!r})"], env, str(self.root), cwd=str(self.root))

    def _config_path(self, name: str) -> str:
        return os.path.join(self.node.base_dir, f"{pod_uid(name)}_main",
                            "config", "vtpu.config")

    # --- 1. torn_config -----------------------------------------------------

    def check_torn_config(self) -> dict:
        from vtpu_manager_torch.config import vtpu_config as vc
        failpoints.arm_from_env({"VTPU_FAILPOINTS": PLUGIN_SPEC,
                                 "VTPU_FAILPOINTS_SEED": "0"})
        rec: dict = {"spec": PLUGIN_SPEC}
        name = "pod-torn"
        try:
            self._allocate(self.host_plugin, name, 0)
            rec["crashed"] = False
        except failpoints.CrashFailpoint as e:
            rec["crashed"] = e.site
        path = self._config_path(name)
        rec["torn_bytes"] = os.path.getsize(path)
        try:
            vc.read_config(path)
            rec["torn_reads"] = True
        except ValueError:
            rec["torn_reads"] = False
        resp = self._allocate(self.host_plugin, name, 0)
        cfg = vc.read_config(path)
        rec["whole_bytes"] = os.path.getsize(path)
        rec["config"] = {"memory": cfg.devices[0].total_memory,
                         "cores": cfg.devices[0].hard_core}
        tenant = self._tenant("cap", "cap", ba.container_env(resp), [])
        self.tenants["cap"] = tenant
        row = tenant.line("WORKER ", TENANT_TIMEOUT_S)
        rec["tenant"] = row
        rec["tenant_rc"] = tenant.proc.wait(timeout=60)
        claim = MEMORY_GIB * GIB
        rec["ok"] = bool(
            rec["crashed"] == "plugin.config_write"
            and 0 < rec["torn_bytes"] < vc.CONFIG_SIZE
            and not rec["torn_reads"]
            and rec["whole_bytes"] == vc.CONFIG_SIZE
            and rec["config"] == {"memory": claim, "cores": CORES}
            and rec["tenant_rc"] == 0 and row["source"] == "config-file"
            and row["claim"] == claim and row["total"] == claim
            and row["over_claim"] == "oom")
        return rec

    # --- 2. torn_cdi --------------------------------------------------------

    def _dra_state(self):
        from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
        node = self.node
        return DeviceState(
            ba.NODE, node.manager.chips, base_dir=str(self.root / "dra"),
            cdi_dir=str(self.root / "cdi"),
            node_config=node.manager.node_config,
            minors=node.manager.minors, shim_host_dir=node.driver_dir,
            lock_dir=node.lock_dir, vmem_dir=node.vmem_dir,
            watcher_dir=node.watcher_dir,
            registry_dir=str(self.root / "registry"))

    def check_torn_cdi(self) -> dict:
        from vtpu_manager_torch import bench_dra as bd
        from vtpu_manager_torch.kubeletplugin import cdi
        # the DRA plugin's own spec, beside the device plugin's
        failpoints.arm_spec(DRA_SPEC)
        claim = bd.allocated_claim("claim-torn", self.chip.index,
                                   {"gpu": [2]}, CORES, MEMORY_GIB * 1024)
        uid = claim["metadata"]["uid"]
        state = self._dra_state()
        rec: dict = {"spec": DRA_SPEC}
        try:
            state.prepare_claim(claim)
            rec["crashed"] = False
        except failpoints.CrashFailpoint as e:
            rec["crashed"] = e.site
        spec_path = cdi.spec_path(uid, state.cdi_dir)
        rec["torn_bytes"] = os.path.getsize(spec_path)
        try:
            with open(spec_path) as f:
                json.load(f)
            rec["torn_parses"] = True
        except json.JSONDecodeError:
            rec["torn_parses"] = False
        rec["checkpointed_after_crash"] = uid in state.prepared_uids()
        restarted = self._dra_state()
        rec["restart_had_claim"] = uid in restarted.prepared_uids()
        rec["devices"] = restarted.prepare_claim(claim)
        with open(spec_path) as f:
            spec = json.load(f)
        rec["whole_bytes"] = os.path.getsize(spec_path)
        rec["checkpointed"] = uid in self._dra_state().prepared_uids()
        rec["ok"] = bool(
            rec["crashed"] == "dra.cdi_write"
            and 0 < rec["torn_bytes"] < rec["whole_bytes"]
            and not rec["torn_parses"]
            and not rec["checkpointed_after_crash"]
            and not rec["restart_had_claim"]
            and rec["devices"] == [cdi.cdi_device_name(uid)]
            and bool(spec.get("devices")) and rec["checkpointed"])
        return rec

    # --- 3. metrics ---------------------------------------------------------

    def _scrape(self, path: str) -> tuple[int, str]:
        url = f"http://127.0.0.1:{self.metrics.server_address[1]}{path}"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, ""

    def check_metrics(self) -> dict:
        from vtpu_manager_torch.cmd.device_plugin import serve_metrics
        self.metrics = serve_metrics(0, host="127.0.0.1")
        status, text = self._scrape("/metrics")
        stats = failpoints.stats()
        rec = {"status": status, "scraped": fires_scraped(text),
               "stats": stats["fires"],
               "other_path": self._scrape("/traces")[0]}
        failpoints.disable()        # the gate off
        status_off, text_off = self._scrape("/metrics")
        rec["off"] = {"status": status_off, "armed": failpoints.armed_sites(),
                      "scraped": fires_scraped(text_off),
                      "evaluations": "vtpu_failpoint_evaluations_total 0"
                      in text_off}
        rec["ok"] = bool(
            status == 200 and rec["scraped"] == rec["stats"]
            == {"plugin.config_write": 1, "dra.cdi_write": 1}
            and rec["other_path"] == 404
            and rec["off"] == {"status": 200, "armed": [], "scraped": {},
                               "evaluations": True})
        return rec

    # --- 4. client_mode -----------------------------------------------------

    def check_client_mode(self) -> dict:
        from vtpu_manager_torch.registry.server import read_pids_config
        from vtpu_manager_torch.trace import assemble
        rec: dict = {"mounts_registry": any(
            m.container_path == consts.REGISTRY_DIR
            for m in self.client_resp.mounts),
            "compat_env": self.client_resp.envs.get(consts.ENV_COMPAT_MODE)}
        t0 = time.monotonic()
        p1, p2 = self.tenants["p1"], self.tenants["p2"]
        for t in (p1, p2):
            t.line("READY", TENANT_TIMEOUT_S)
        rec["ready_wait_s"] = time.monotonic() - t0
        deadline = time.monotonic() + 30
        while (len(self.registry.registrations) < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        regs = list(self.registry.registrations)
        rec["registrations"] = [{k: r[k] for k in ("pod_uid", "peer_pid",
                                                   "pids")} for r in regs]
        pids_path = os.path.join(os.path.dirname(
            self._config_path(self.client_pod)), consts.PIDS_CONFIG_NAME)
        pids = read_pids_config(pids_path)
        rec["pids"] = pids
        (self.root / "client.go").touch()
        rows = {key: t.line("STEPPED ", TENANT_TIMEOUT_S)
                for key, t in (("p1", p1), ("p2", p2))}
        rec["steps"] = rows
        held = p1.line("HELD ", TENANT_TIMEOUT_S)
        (self.root / "ask").touch()
        asked = p2.line("ASKED ", TENANT_TIMEOUT_S)
        (self.root / "release").touch()
        rec["held"], rec["asked"] = held, asked
        rec["rc"] = {key: t.proc.wait(timeout=60)
                     for key, t in (("p1", p1), ("p2", p2))}
        refreshed = f"client pid set refreshed ({len(pids)} pids)"
        logs = {key: open(t.err_path).read() for key, t in (("p1", p1),
                                                            ("p2", p2))}
        rec["refresh_logged"] = {key: refreshed in log
                                 for key, log in logs.items()}
        spawned = f"device-client spawned: python3 '{self.registrar}'"
        rec["registrar_logged"] = {key: spawned in log
                                   for key, log in logs.items()}
        # a registration that claims another pod's uid
        spoof_env = ba.container_env(self.client_resp)
        spoof_env.update({consts.ENV_POD_UID: pod_uid("pod-torn"),
                          consts.ENV_REGISTRY_SOCKET:
                          self.registry.socket_path})
        for var in (consts.ENV_LD_PRELOAD, consts.ENV_TRACE_ID,
                    consts.ENV_TRACE_SAMPLED, consts.ENV_TRACE_DIR):
            spoof_env.pop(var, None)
        spoof = subprocess.run(
            [sys.executable, "-m", "vtpu_manager_torch.runtime.client"],
            cwd=str(build.REPO), env=spoof_env, capture_output=True,
            text=True, timeout=60)
        rec["spoof_rc"] = spoof.returncode
        rec["spoof_registered"] = len(self.registry.registrations) > len(regs)
        # the timeline: both sides of each registration
        time.sleep(0.2)
        trace.flush()
        spans, _ = assemble.read_spools(self.trace_dir)
        rec["spans"] = {st: sum(1 for s in spans if s.stage == st
                                and s.pod_uid == self.client_uid)
                        for st in ("shim.register", "registry.register")}
        tenant_pids = set(self.tenant_pids)
        claim = MEMORY_GIB * GIB
        rec["ok"] = bool(
            rec["mounts_registry"]
            and rec["compat_env"] == str(consts.COMPAT_CLIENT)
            and len(regs) == 2
            and all(r["pod_uid"] == self.client_uid for r in regs)
            and tenant_pids <= set(pids)
            and set(pids) <= tenant_pids | {r["peer_pid"] for r in regs}
            and all(rec["refresh_logged"].values())
            and all(rec["registrar_logged"].values())
            and all(r["attn_block_launches"] == STEPS
                    and r["source"] == "config-file" and r["total"] == claim
                    for r in rows.values())
            and held["verdict"] == "granted" and asked["verdict"] == "oom"
            and rec["rc"] == {"p1": 0, "p2": 0}
            and rec["spoof_rc"] != 0 and not rec["spoof_registered"]
            and rec["spans"] == {"shim.register": len(regs),
                                 "registry.register": len(regs)})
        return rec


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _alloc_verdict(torch, gib: float):
    try:
        t = torch.empty(int(gib * GIB), dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        return "granted", t
    except torch.cuda.OutOfMemoryError:
        return "oom", None


def _tenant(args) -> None:
    import torch

    from vtpu_manager_torch.bench_quota import shim_counters, _wait_file
    from vtpu_manager_torch.runtime.client import effective_limits

    if args.tenant == "cap":
        limits = effective_limits()
        claim = limits.devices[0].total_memory if limits.devices else 0
        free, total = torch.cuda.mem_get_info()
        verdict, _ = _alloc_verdict(torch, 2 * claim / GIB)
        print("WORKER " + json.dumps({
            "pid": os.getpid(), "source": limits.source, "claim": claim,
            "free": free, "total": total, "over_claim": verdict}),
            flush=True)
        return

    from vtpu_manager_torch.bench_steps import _quota_input, _quota_step
    from vtpu_manager_torch.workloads import block_attention as blk
    dev = torch.device("cuda")
    x = _quota_input(args.dim, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((8, 16, 512, 128), generator=gen, device=dev)
               for _ in range(3))
    bias = torch.zeros((512, 512), device=dev)

    def step(x):
        x, loss = _quota_step(x)
        torch.ops.vtpu.attn_block(q, k, v, bias)
        _ = float(loss)
        return x

    for _ in range(args.warmup):
        x = step(x)
    print("READY", flush=True)
    _wait_file(args.go_file)
    blk.reset_launches()
    before = shim_counters()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        x = step(x)
    ms = 1000 * (time.perf_counter() - t0) / args.steps
    after = shim_counters()
    limits = effective_limits()
    free, total = torch.cuda.mem_get_info()
    print("STEPPED " + json.dumps({
        "pid": os.getpid(), "ms_per_step": ms, "steps": args.steps,
        "attn_block_launches": blk.LAUNCHES["attn_block"],
        "shim_launches": after.get("vtpu_launches_total", 0)
        - before.get("vtpu_launches_total", 0),
        "source": limits.source, "total": total, "free": free}), flush=True)
    if args.hold_gib:
        verdict, held = _alloc_verdict(torch, args.hold_gib)
        print("HELD " + json.dumps({"verdict": verdict}), flush=True)
        _wait_file(args.release_file)
        del held
    if args.ask_gib:
        _wait_file(args.ask_file)
        verdict, _ = _alloc_verdict(torch, args.ask_gib)
        print("ASKED " + json.dumps({"verdict": verdict}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenant", choices=("cap", "client"))
    ap.add_argument("--dim", type=int, default=8192)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--go-file")
    ap.add_argument("--hold-gib", type=float, default=0.0)
    ap.add_argument("--release-file")
    ap.add_argument("--ask-gib", type=float, default=0.0)
    ap.add_argument("--ask-file")
    args = ap.parse_args(argv)
    if args.tenant:
        _tenant(args)
    else:
        ap.error("bench_resilience runs as a tenant; the phase is driven by "
                 "chip_smoke.py")


if __name__ == "__main__":
    sys.exit(main())
