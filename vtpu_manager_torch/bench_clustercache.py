"""A fleet's cold start through the cluster tier of the compile cache: one
compile, every other node seeded from a warm peer. The port of
`scripts/bench_clustercache.py`.

    python -m vtpu_manager_torch.bench_clustercache [--nodes 4]

N nodes are simulated on one host with a card, each a private root with
its compile-cache store, its node exporter (`cmd/device_monitor.py` as a
subprocess with ClusterCompileCache on, serving `/cache/entry` on
127.0.0.1 behind a token) and its device plugin's advertiser
(`clustercache.CacheAdvertiser`), all over one fake API client. A worker
is `bench_compilecache`'s replica (`--tenant`): a process that arms the
store from its environment (`VTPU_COMPILE_CACHE`, `VTPU_CLUSTER_CACHE`,
the pod's `VTPU_PROGRAM_FINGERPRINT`, the peer token) and reaches the
first step of `workloads/compiled_step.py` through it, in Inductor and
Triton directories of its own; its time to first step runs from its go
file to the step's outputs. Waves, one after the other:

1. `seed`: node 0, one worker: the fleet's one compile (`miss`);
2. `warm`: node 0 again, N - 1 workers at once: `hit`s;
3. then every advertiser publishes and writes its `peers.json`;
4. `cold_fetch`: nodes 1 .. N - 1, one worker each, at once: each a
   `fetch` from node 0's exporter, no compile;
5. `gate_off`: a fresh node with `peers.json` but the cluster tier off:
   a local compile (`miss`) with no fetch attempted.

It checks that the fleet compiled once for the shared fingerprint (waves
1, 2 and 4: Inductor's graph cache missed in the seed worker only), that
every cold node fetched, and the gate-off worker's miss; it prints a
table and one JSON line, and exits 1 when a check fails. The scheduler's
warm placement (the JAX bench's last part) is not carried.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

from vtpu_manager_torch.util import consts

FINGERPRINT = "compiled-step-8192"
WAVE_TIMEOUT_S = 300.0


def node_dirs(base: Path, name: str) -> SimpleNamespace:
    """A simulated node: its name and the directories its exporter reads
    (the store is `<base_dir>/compilecache`)."""
    root = base / name
    node = SimpleNamespace(name=name, base_dir=str(root / "mgr"),
                           watcher_dir=str(root / "watcher"),
                           vmem_dir=str(root / "vmem"))
    node.cache_root = os.path.join(node.base_dir, consts.COMPILE_CACHE_SUBDIR)
    os.makedirs(node.cache_root, exist_ok=True)
    return node


def worker_env(node, work: Path, cluster: bool, token: str) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("VTPU_") and k != consts.ENV_LD_PRELOAD}
    env.update({consts.ENV_COMPILE_CACHE: "true",
                consts.ENV_COMPILE_CACHE_DIR: node.cache_root,
                consts.ENV_PROGRAM_FINGERPRINT: FINGERPRINT,
                consts.ENV_CACHE_PEER_TOKEN: token,
                # no config file here: the worker runs unmetered
                consts.ENV_CONFIG_PATH: str(work / "no-config"),
                consts.ENV_INDUCTOR_CACHE_DIR: str(work / "inductor"),
                consts.ENV_TRITON_CACHE_DIR: str(work / "triton")})
    if cluster:
        env[consts.ENV_CLUSTER_CACHE] = "true"
    return env


def run_wave(base: Path, name: str, nodes: list, cluster: bool,
             token: str) -> list[dict]:
    """One worker per entry of `nodes`, started together, let go together;
    their WORKER records."""
    from vtpu_manager_torch import bench_quota as bq
    wave = base / f"wave-{name}"
    wave.mkdir()
    workers = []
    for i, node in enumerate(nodes):
        work = wave / f"w{i}"
        work.mkdir()
        workers.append(bq.Tenant(
            f"{name}-w{i}",
            ["-m", "vtpu_manager_torch.bench_compilecache", "--tenant",
             "--store", "--go-file", str(wave / "go"),
             "--out", str(work / "out.pt")],
            worker_env(node, work, cluster, token), str(wave)))
    try:
        for w in workers:
            w.line("READY", WAVE_TIMEOUT_S)
        (wave / "go").touch()
        rows = [w.line("WORKER ", WAVE_TIMEOUT_S) for w in workers]
        for w in workers:
            w.proc.wait(timeout=60)
    finally:
        for w in workers:
            w.stop()
    return rows


def summarize(name: str, rows: list[dict]) -> dict:
    """`bench_compilecache.summarize`, with the median time to first step
    and the fetches each worker tried."""
    from vtpu_manager_torch.bench_compilecache import summarize as counts
    ttfs = sorted(r["ttfs_s"] for r in rows)
    return {**counts(name, rows), "ttfs_p50_s": ttfs[len(ttfs) // 2],
            "fetch_attempts": sum(r["stats"]["peer_fetches"]
                                  + r["stats"]["peer_fetch_failures"]
                                  for r in rows)}


def run(n_nodes: int, base: Path) -> dict:
    from vtpu_manager_torch.bench_monitor import TOKEN, Exporter
    from vtpu_manager_torch.client.fake import FakeKubeClient
    from vtpu_manager_torch.clustercache import CacheAdvertiser

    nodes = [node_dirs(base, f"node-{i}") for i in range(n_nodes)]
    off = node_dirs(base, "node-off")
    node_config = base / "node-config.json"
    node_config.write_text(json.dumps({"default": {"deviceSplitCount": 4}}))
    client = FakeKubeClient()
    exporters = []
    try:
        for node in nodes:
            client.add_node({"metadata": {"name": node.name,
                                          "annotations": {}}})
            exporters.append(Exporter(
                base, node, str(base / "no-checkpoint"), str(node_config),
                gates="ClusterCompileCache=true", tag=f"exporter-{node.name}"))
        advertisers = [CacheAdvertiser(client, node.name, node.cache_root,
                                       endpoint=e.url.removeprefix("http://"))
                       for node, e in zip(nodes, exporters)]
        seed = summarize("seed", run_wave(base, "seed", nodes[:1], True,
                                          TOKEN))
        warm = summarize("warm", run_wave(base, "warm",
                                          nodes[:1] * (n_nodes - 1), True,
                                          TOKEN))
        for adv in advertisers:
            adv.publish_once()
            adv.refresh_peers()
        cold = summarize("cold_fetch", run_wave(base, "cold", nodes[1:],
                                                True, TOKEN))
        shutil.copy(os.path.join(nodes[1].cache_root,
                                 consts.CACHE_PEERS_NAME),
                    os.path.join(off.cache_root, consts.CACHE_PEERS_NAME))
        gate_off = summarize("gate_off", run_wave(base, "off", [off], False,
                                                  TOKEN))
    finally:
        for e in exporters:
            e.close()
    fleet = seed["compiles"] + warm["compiles"] + cold["compiles"]
    checks = {
        "fleet_compiles_1": fleet == 1,
        "every_cold_node_fetched": cold["fetches"] == n_nodes - 1,
        "warm_hits": warm["outcomes"] == ["hit"] * (n_nodes - 1),
        "gate_off_compiles_without_fetching": (
            gate_off["outcomes"] == ["miss"]
            and gate_off["fetch_attempts"] == 0)}
    return {"nodes": n_nodes, "scenarios": [seed, warm, cold, gate_off],
            "fleet_compiles_for_shared_fingerprint": fleet,
            "cold_vs_warm_ttfs_p50": cold["ttfs_p50_s"] / warm["ttfs_p50_s"],
            "cold_vs_seed_ttfs_p50": cold["ttfs_p50_s"] / seed["ttfs_p50_s"],
            "checks": checks, "ok": all(checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_clustercache: no CUDA device", file=sys.stderr)
        return 1
    if args.nodes < 2:
        ap.error("--nodes: a fleet needs a warm node and a cold one")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="vtpu-fleet-") as base:
        doc = run(args.nodes, Path(base))
    doc["seconds"] = time.monotonic() - t0
    doc["device"] = torch.cuda.get_device_name(0)
    print(f"{'scenario':10} {'workers':>7} {'compiles':>8} {'fetches':>7} "
          f"{'ttfs p50':>9} {'max':>8}")
    for r in doc["scenarios"]:
        print(f"{r['scenario']:10} {r['replicas']:7d} {r['compiles']:8d} "
              f"{r['fetches']:7d} {r['ttfs_p50_s']:8.3f}s "
              f"{r['ttfs_max_s']:7.3f}s")
    print("CLUSTERCACHE " + json.dumps(doc))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
