"""Replicas of one pod share torch.compile's output through the node
compile cache: the port of `scripts/bench_compilecache.py`, and the checks
of chip_smoke.py's `compile_cache` phase.

On a private node (`bench_allocate.Node`: NVML discovery split 4, the
interposer installed, the NVML-fed watcher), the port's device plugin
allocates three pods of 25 % and 8 GiB of the card for each scenario,
with the step ring, with the CompileCache gate off for `off`'s and on for
the others'. Each replica
is a subprocess started from its Allocate response alone
(`bench_allocate.container_env`), under the interposer; it calls
`runtime.client.install()`, imports Dynamo and Inductor, makes the inputs
of `workloads/compiled_step.py` (the 8192² bf16 quota step with an
Inductor tail and one `vtpu::attn_block` call at (8, 16, 512, 128) fp32)
and says READY; on its scenario's go file it marks its first execute
(`runtime.client.mark_first_execute`, a traced tenant's
`shim.first_execute`) and reaches its first step, and its time to first
step runs from the go file to the step's outputs. The
replicas of every scenario start together with the phase and wait; the
three of a scenario go together:

- `off`: the gate is off; each replica compiles alone, in Inductor and
  Triton directories of its own, empty;
- `cold`: the store is armed and empty; the replicas go through
  `compile_cache().get_or_compile`, with Inductor's and Triton's
  directories where `install()` puts them, under the mount: one compiles
  and stores `save_cache_artifacts()`, the others wait on its lease and
  load the entry;
- `warm`: the store holds the entry; the replicas, in empty directories
  of their own, load it: the store path alone;
- `env`: the replicas do not call the store; `install()` left their
  directories under the mount, where `cold`'s compile wrote: the
  transparent path alone;
- `peer`: a second node B on the card (`bench_allocate.Node` named
  `node-b`, one fake API client with the first node A), its device plugin
  with CompileCache and ClusterCompileCache, its store empty. `cold`'s
  pods had ClusterCompileCache too, and the pods declare the program
  fingerprint (`VTPU_PROGRAM_FINGERPRINT`), so A's store holds the
  entry's `fps/` marker. A's exporter and B's run as subprocesses with
  the gate on and a token; A's advertiser publishes A's warm key with its
  exporter's address, B's writes `peers.json` from it, and B's replicas,
  in empty Inductor and Triton directories of their own and with the
  exporters' token as `VTPU_CACHE_PEER_TOKEN`, fetch A's entry over
  `/cache/entry` under B's lease.

Checks, each a record with an `ok` verdict:

1. allocate: gate on, the response mounts `<base>/compilecache`
   read-write at `/etc/vtpu-manager/compilecache`, sets
   VTPU_COMPILE_CACHE=true and VTPU_COMPILE_CACHE_DIR, and the config
   file names the dir; gate off, none of the three; VTPU_CLUSTER_CACHE=true
   exactly where ClusterCompileCache is on too (`cold` and `peer`);
2. off: 3 compiles (each replica's Inductor graph cache missed);
3. cold: exactly 1 `miss` and 2 `wait`s, one entry, nothing quarantined
   or left in tmp/;
4. warm: 3 `hit`s and no Inductor compile;
5. env: time to first step and the Inductor graph cache's hits (report);
6. peer: exactly 1 `fetch` and 2 `wait`s on B, no Inductor compile, one
   entry on B, nothing quarantined or left in tmp/, and B's exporter's
   `vtpu_compile_cache_peer_fetches_total` at 1 (failures 0); its time to
   first step beside `cold`'s and `warm`'s (report);
7. shared: every replica's first-step outputs within TOL of a replica
   that compiled alone (`off`'s first); `warm`'s mean time to first step
   below `off`'s; after each scenario the exporter's
   `vtpu_compile_cache_*` block (`render_node_metrics`) counts the hits,
   misses and waits the replicas counted; in every replica the compiled
   step launched the attention kernel, one more call of the operator is
   one launch the interposer counted, and the ring's first record is
   marked `compiled`.

Run `python -m vtpu_manager_torch.bench_compilecache` on a card for the
scenarios alone (a summary table); `--tenant` is the replica subprocess.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from vtpu_manager_torch import bench_allocate as ba
from vtpu_manager_torch.util import consts

GIB = 2**30
REPLICAS = 3
CORES, MEMORY_GIB = 25, 8
SCENARIOS = ("off", "cold", "warm", "env")
PEER = "peer"                 # the cluster tier's scenario, on node B
PEER_NODE = "node-b"
FINGERPRINT = "compiled-step-8192"   # the pods' declared program
TOL = 1e-4                    # the kernel's tolerance on its outputs
WAVE_TIMEOUT_S = 240.0


def pod_names(scenario: str) -> list[str]:
    """The scenario's own pods, one per replica (a replica is a pod of a
    gang: its own container, config and ring)."""
    return [f"pod-{scenario}{i}" for i in range(REPLICAS)]


def summarize(name: str, rows: list[dict]) -> dict:
    """The scenario's counts and times (the JAX bench's `summarize`):
    compiles are the replicas whose Inductor graph cache missed; `store`
    is what the replicas' store clients counted (a wait is also a hit)."""
    ttfs = [r["ttfs_s"] for r in rows]
    outcomes = [r["outcome"] for r in rows]
    waits, fetches = outcomes.count("wait"), outcomes.count("fetch")
    return {"scenario": name, "replicas": len(rows),
            "compiles": sum(r["fxgraph_cache_miss"] > 0 for r in rows),
            "outcomes": outcomes,
            "hits": outcomes.count("hit"),
            "single_flight_waits": waits,
            "fetches": fetches,
            "misses": sum(o in ("miss", "timeout") for o in outcomes),
            # a fetched entry counts a hit
            "store": {"hits_total": outcomes.count("hit") + waits + fetches,
                      "misses_total": sum(o in ("miss", "timeout")
                                          for o in outcomes),
                      "single_flight_waits_total": waits},
            "ttfs_mean_s": statistics.mean(ttfs),
            "ttfs_max_s": max(ttfs)}


def exporter_counts(root: str, node: str = ba.NODE) -> dict:
    """The exporter's compile-cache block for the node, as numbers."""
    from vtpu_manager_torch.bench_monitor import parse_metrics
    from vtpu_manager_torch.compilecache.cache import render_node_metrics
    return {n[len("vtpu_compile_cache_"):]: v for n, _, v in parse_metrics(
        render_node_metrics(root, node))}


class Phase:
    def __init__(self, torch, shim: str, root: str):
        self.torch = torch
        self.node = ba.Node(root, shim)
        self.root = Path(root)
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")
        self.plugin = self.node.plugin(True)
        self.cache_root = self.plugin.compile_cache_host_dir()
        # node B of the peer scenario, on the same card and API client
        self.peer_node = ba.Node(str(self.root / PEER_NODE), shim,
                                 name=PEER_NODE, client=self.node.client)
        self.peer_plugin = self.peer_node.plugin(True)
        self.peer_plugin.compile_cache_enabled = True
        self.peer_plugin.cluster_cache_enabled = True
        self.peer_root = self.peer_plugin.compile_cache_host_dir()
        self.exporters: dict = {}            # node name -> its exporter
        self.responses: dict = {}
        self.waves: dict[str, list] = {}     # scenario -> its replicas
        self.rows: dict[str, list[dict]] = {}
        self.exported: dict[str, dict] = {}

    def close(self) -> None:
        for tenants in self.waves.values():
            for t in tenants:
                try:
                    t.proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pass        # stop() kills it
                t.stop()
        for exporter in self.exporters.values():
            exporter.close()
        self.node.close()
        self.peer_node.close()

    # --- 1. allocate --------------------------------------------------------

    def check_allocate(self) -> dict:
        from vtpu_manager_torch.config import vtpu_config as vc
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import device_id
        pods = {}
        for name in (*SCENARIOS, PEER):
            gate = name != "off"
            cluster = name in ("cold", PEER)
            node, plugin, root = ((self.peer_node, self.peer_plugin,
                                   self.peer_root) if name == PEER else
                                  (self.node, self.plugin, self.cache_root))
            plugin.compile_cache_enabled = gate
            plugin.cluster_cache_enabled = cluster
            for i, pod in enumerate(pod_names(name)):
                self.node.client.add_pod(ba.committed_pod(
                    pod, self.chip, CORES, MEMORY_GIB * GIB, node=node.name))
                (resp,) = plugin.allocate(api.AllocateRequest(
                    [api.ContainerAllocateRequest(
                        [device_id(self.chip.uuid, i)])])).container_responses
                self.responses[pod] = resp
                mounts = {m.container_path: m for m in resp.mounts}
                mount = mounts.get(consts.COMPILE_CACHE_DIR)
                cfg = vc.read_config(ba.host_path(resp,
                                                  consts.CONTAINER_CONFIG))
                rec = {"mount": None if mount is None else
                       [mount.host_path, mount.read_only],
                       "env": [resp.envs.get(consts.ENV_COMPILE_CACHE),
                               resp.envs.get(consts.ENV_COMPILE_CACHE_DIR),
                               resp.envs.get(consts.ENV_CLUSTER_CACHE)],
                       "config_dir": cfg.compile_cache_dir}
                want = ([root, False], ["true", consts.COMPILE_CACHE_DIR,
                                        "true" if cluster else None],
                        consts.COMPILE_CACHE_DIR) \
                    if gate else (None, [None, None, None], "")
                rec["ok"] = (rec["mount"], rec["env"],
                             rec["config_dir"]) == want
                pods[pod] = rec
        # every scenario's replicas start now and wait at READY: their
        # start-ups overlap, and each scenario starts on its own go file
        t0 = time.monotonic()
        for name in (*SCENARIOS, PEER):
            self.waves[name] = self._spawn(name)
        # both nodes' exporters, the cluster tier's route on, meanwhile
        from vtpu_manager_torch.bench_monitor import Exporter
        node_config = self.root / "node-config.json"
        node_config.write_text(json.dumps({"default": {
            "deviceSplitCount": ba.SPLIT}}))
        for node in (self.node, self.peer_node):
            self.exporters[node.name] = Exporter(
                self.root, node, str(self.root / "no-checkpoint"),
                str(node_config), gates="ClusterCompileCache=true",
                tag=f"exporter-{node.name}")
        for tenants in self.waves.values():
            for t in tenants:
                t.line("READY", WAVE_TIMEOUT_S)
        return {"pods": pods, "cache_root": self.cache_root,
                "replicas_ready_s": time.monotonic() - t0,
                "ok": all(r["ok"] for r in pods.values())
                and os.path.isdir(self.cache_root)}

    # --- 2-5. the scenarios -------------------------------------------------

    def _spawn(self, name: str) -> list:
        """The scenario's REPLICAS replica processes, from their pods'
        Allocate responses."""
        from vtpu_manager_torch import bench_monitor as bm
        from vtpu_manager_torch import bench_quota as bq
        wave_dir = self.root / f"wave-{name}"
        wave_dir.mkdir()
        tenants = []
        for i, pod in enumerate(pod_names(name)):
            env = ba.container_env(self.responses[pod])
            if name in ("cold", PEER):
                # what the pod's spec declares (the webhook's source)
                env[consts.ENV_PROGRAM_FINGERPRINT] = FINGERPRINT
            if name == PEER:
                env[consts.ENV_CACHE_PEER_TOKEN] = bm.TOKEN
            if name in ("off", "warm", PEER):
                # fresh directories of the replica's own: nothing but the
                # store (or nothing at all) can hand it a compile
                for var in (consts.ENV_INDUCTOR_CACHE_DIR,
                            consts.ENV_TRITON_CACHE_DIR):
                    env[var] = str(wave_dir / f"r{i}" / var.lower())
            else:
                env.pop(consts.ENV_INDUCTOR_CACHE_DIR, None)
                env.pop(consts.ENV_TRITON_CACHE_DIR, None)
            args = ["-m", "vtpu_manager_torch.bench_compilecache",
                    "--tenant", "--go-file", str(wave_dir / "go"),
                    "--out", str(wave_dir / f"r{i}.pt")]
            if name in ("cold", "warm", PEER):
                args.append("--store")
            tenants.append(bq.Tenant(f"{name}-r{i}", args, env,
                                     str(wave_dir)))
        return tenants

    def _wave(self, name: str, root: str | None = None,
              node: str = ba.NODE) -> list[dict]:
        """Lets the scenario's replicas go together; their WORKER records,
        each with its first-step outputs' sample path. The exporter's
        counts are read from `root` (node A's store by default)."""
        wave_dir = self.root / f"wave-{name}"
        tenants = self.waves[name]
        (wave_dir / "go").touch()
        rows = []
        for i, t in enumerate(tenants):
            row = t.line("WORKER ", WAVE_TIMEOUT_S)
            row["sample"] = str(wave_dir / f"r{i}.pt")
            rows.append(row)
        # the replicas exit while the next scenario runs; close() reaps them
        self.rows[name] = rows
        self.exported[name] = exporter_counts(root or self.cache_root, node)
        return rows

    def _scenario(self, name: str, verdict) -> dict:
        rows = self._wave(name)
        rec = {**summarize(name, rows), "exporter": self.exported[name],
               "rows": rows}
        rec["ok"] = bool(verdict(rec) and all(self._replica_ok(r)
                                              for r in rows))
        return rec

    @staticmethod
    def _replica_ok(row: dict) -> bool:
        return (row["step_launches"] >= 1 and row["op_launches"] == 1
                and row["op_shim_launches"] >= 1 and row["ring_compiled"])

    def check_off(self) -> dict:
        return self._scenario("off", lambda r: r["compiles"] == REPLICAS)

    def check_cold(self) -> dict:
        root = self.cache_root
        rec = self._scenario("cold", lambda r: (
            r["compiles"] == 1 and r["misses"] == 1
            and r["single_flight_waits"] == REPLICAS - 1))
        rec["entries"] = os.listdir(os.path.join(root, "entries"))
        rec["quarantine"] = os.listdir(os.path.join(root, "quarantine"))
        rec["tmp"] = os.listdir(os.path.join(root, "tmp"))
        rec["ok"] = bool(rec["ok"] and len(rec["entries"]) == 1
                         and not rec["quarantine"] and not rec["tmp"]
                         and rec["exporter"]["quarantined_total"] == 0)
        return rec

    def check_warm(self) -> dict:
        return self._scenario("warm", lambda r: (
            r["hits"] == REPLICAS and r["compiles"] == 0))

    def check_env(self) -> dict:
        rec = self._scenario("env", lambda r: True)
        rec["fxgraph_cache_hits"] = [r["fxgraph_cache_hit"]
                                     for r in rec["rows"]]
        return rec

    # --- 6. a warm peer seeds node B ---------------------------------------

    def check_peer(self) -> dict:
        from vtpu_manager_torch.bench_monitor import value
        from vtpu_manager_torch.clustercache import CacheAdvertiser
        client = self.node.client
        a, b = (self.exporters[n.name] for n in (self.node, self.peer_node))
        published = CacheAdvertiser(
            client, ba.NODE, self.cache_root,
            endpoint=a.url.removeprefix("http://")).publish_once()
        peers = CacheAdvertiser(
            client, PEER_NODE, self.peer_root,
            endpoint=b.url.removeprefix("http://")).refresh_peers()
        rows = self._wave(PEER, self.peer_root, PEER_NODE)
        rec = {**summarize(PEER, rows), "rows": rows,
               "advertised": [list(p) for p in published.pairs],
               "peers": peers}
        root = self.peer_root
        rec["entries"] = os.listdir(os.path.join(root, "entries"))
        rec["entry_bytes"] = [os.path.getsize(os.path.join(root, "entries", e))
                              for e in rec["entries"]]
        rec["store_s"] = {name: [r["store_s"] for r in self.rows[name]]
                          for name in ("cold", "warm", PEER)}
        rec["quarantine"] = os.listdir(os.path.join(root, "quarantine"))
        rec["tmp"] = os.listdir(os.path.join(root, "tmp"))
        _, samples = b.metrics()
        rec["exporter"] = {
            k: value(samples, f"vtpu_compile_cache_{k}", node=PEER_NODE)
            for k in ("peer_fetches_total", "peer_fetch_failures_total",
                      "hits_total", "misses_total",
                      "single_flight_waits_total")}
        # the peer's time to first step beside the node tier's two
        rec["ttfs_vs"] = {
            "cold": summarize("cold", self.rows["cold"])["ttfs_mean_s"],
            "warm": summarize("warm", self.rows["warm"])["ttfs_mean_s"],
            PEER: rec["ttfs_mean_s"]}
        rec["ok"] = bool(
            rec["fetches"] == 1 and rec["single_flight_waits"] == REPLICAS - 1
            and rec["compiles"] == 0 and rec["misses"] == 0
            and len(rec["advertised"]) == 1 and peers == 1
            and len(rec["entries"]) == 1 and not rec["quarantine"]
            and not rec["tmp"]
            and rec["exporter"]["peer_fetches_total"] == 1
            and rec["exporter"]["peer_fetch_failures_total"] == 0
            and all(self._replica_ok(r) for r in rows))
        return rec

    # --- 7. across the scenarios --------------------------------------------

    def check_shared(self) -> dict:
        torch = self.torch
        ref_y, ref_a = torch.load(self.rows["off"][0]["sample"])
        errs = {}
        for name, rows in self.rows.items():
            for i, row in enumerate(rows):
                y, a = torch.load(row["sample"])
                errs[f"{name}-r{i}"] = max(
                    (y - ref_y).abs().max().item(),
                    (a - ref_a).abs().max().item())
        # the replicas' own count of what the store did, summed scenario by
        # scenario, against the exporter's totals after each
        want = {"hits_total": 0, "misses_total": 0,
                "single_flight_waits_total": 0}
        exporter = {}
        for name in SCENARIOS:
            store = summarize(name, self.rows[name])["store"]
            want = {k: v + store[k] for k, v in want.items()}
            got = self.exported[name]
            exporter[name] = {"replicas": want, "exporter": {
                k: got.get(k) for k in want}}
        ttfs = {name: summarize(name, self.rows[name])["ttfs_mean_s"]
                for name in SCENARIOS}
        rec = {"max_abs_err": errs, "tol": TOL, "ttfs_mean_s": ttfs,
               "counters": exporter}
        rec["ok"] = bool(
            max(errs.values()) <= TOL and ttfs["warm"] < ttfs["off"]
            and all(v["replicas"] == v["exporter"]
                    for v in exporter.values()))
        return rec


CHECKS = ("allocate", "off", "cold", "warm", "env", PEER, "shared")


def _tenant(args) -> None:
    from vtpu_manager_torch import trace
    from vtpu_manager_torch.runtime import client as rt
    rt.install()
    import torch

    from vtpu_manager_torch.bench_quota import _shim_counters, _wait_file
    from vtpu_manager_torch.workloads import block_attention as attn
    from vtpu_manager_torch.workloads import compiled_step as cs

    # what every scenario pays alike happens before READY: torch, Dynamo
    # and Inductor imported, the inputs on the card
    import torch._inductor.compile_fx  # noqa: F401
    inputs = cs.make_inputs(device="cuda")
    key = cs.entry_key(inputs, rt.effective_limits().devices)
    cache = rt.compile_cache() if args.store else None
    if args.store and cache is None:
        raise RuntimeError("--store without an armed compile cache")
    tel = rt.step_telemetry()
    store_s = 0.0
    if cache is not None:
        # the time inside the store (a compile, a wait, a fetch or a read)
        # apart from the artifacts' load and the first call
        get_or_compile = cache.get_or_compile

        def timed(*a, **k):
            nonlocal store_s
            t0 = time.monotonic()
            try:
                return get_or_compile(*a, **k)
            finally:
                store_s = time.monotonic() - t0

        cache.get_or_compile = timed
    torch.cuda.synchronize()
    print("READY", flush=True)
    _wait_file(args.go_file)
    rt.mark_first_execute()
    s0 = time.monotonic_ns()
    (y, a), outcome, ttfs = cs.first_step(inputs, cache, key)
    first_step_wall = time.time()
    if tel is not None:
        tel.record(time.monotonic_ns() - s0, compiled=True)
    step_launches = attn.LAUNCHES["attn_block"]
    torch.save([y[::64, ::64].float().cpu(), a[:, :, ::8].cpu()], args.out)
    # one more call of the operator, between two reads of the interposer's
    # launch counter
    before = _shim_counters().get("vtpu_launches_total", 0)
    torch.ops.vtpu.attn_block(*inputs[1:])
    torch.cuda.synchronize()
    shim_delta = _shim_counters().get("vtpu_launches_total", 0) - before
    # the container's ring holds a record per replica that ran in it; this
    # one's is the last
    ring_compiled = False
    if tel is not None:
        from vtpu_manager_torch.telemetry.stepring import StepRingReader
        reader = StepRingReader(os.environ[consts.ENV_STEP_RING_PATH])
        try:
            records = reader.poll(0)[0]
        finally:
            reader.close()
        ring_compiled = bool(records) and bool(records[-1].compiled)
    print("WORKER " + json.dumps({
        "pid": os.getpid(), "outcome": outcome, "ttfs_s": ttfs,
        "store_s": store_s,
        "key": key[:16], **cs.compile_counters(),
        "step_launches": step_launches,
        "op_launches": attn.LAUNCHES["attn_block"] - step_launches,
        "op_shim_launches": shim_delta,
        "ring_compiled": ring_compiled,
        "inductor_dir": os.environ.get(consts.ENV_INDUCTOR_CACHE_DIR),
        "stats": None if cache is None else cache.stats.as_dict(),
        "first_step_wall": first_step_wall,
        "traced": trace.is_enabled()}),
        flush=True)


def table(results: dict) -> str:
    """One line per scenario, node B's `peer` last: compiles, hits (a
    fetch counts one), waits and the time to first step."""
    lines = [f"{'scenario':8} {'compiles':>8} {'hits':>5} {'waits':>6} "
             f"{'ttfs mean':>10} {'max':>8}"]
    for name in (*SCENARIOS, PEER):
        r = results[name]
        lines.append(
            f"{name:8} {r['compiles']:8d} {r['hits'] + r['fetches']:5d} "
            f"{r['single_flight_waits']:6d} {r['ttfs_mean_s']:9.3f}s "
            f"{r['ttfs_max_s']:7.3f}s")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenant", action="store_true")
    ap.add_argument("--store", action="store_true")
    ap.add_argument("--go-file")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.tenant:
        _tenant(args)
        return 0
    import torch

    from vtpu_manager_torch import build
    if not torch.cuda.is_available():
        print("bench_compilecache: no CUDA device", file=sys.stderr)
        return 1
    shim = str(build.build_for_card()["shim"])
    with tempfile.TemporaryDirectory(prefix="vtpu-node-") as root:
        phase = Phase(torch, shim, root)
        try:
            results = {name: getattr(phase, f"check_{name}")()
                       for name in CHECKS}
        finally:
            phase.close()
    print(table(results))
    print(json.dumps({n: r["ok"] for n, r in results.items()}))
    return 0 if all(r["ok"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
