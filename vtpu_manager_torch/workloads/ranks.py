"""Rank processes: n processes joined in one `torch.distributed` group.

Where the JAX package runs n virtual devices in one process
(`__graft_entry__.py:33`, `tests/multihost_worker.py`), the port runs n
processes, one rank each. A job is a function `module:name` that takes the
rank's `Rank` and keyword arguments and returns a JSON-able dict; each rank
process runs it once and prints it on a `RANK_RESULT` line.

Rendezvous goes through a `file://` store in a temporary directory of the
launch's own, never a fixed port, so launches running at once (test
workers, a phase beside another) cannot meet each other's ranks.

The backend is the caller's choice, never a guess from what the process
finds: NCCL on the card by default, gloo on the CPU, and gloo on the card
where the caller asks for it (several ranks on one card: NCCL refuses two
ranks on one device). A rank whose NCCL init fails raises; nothing drops to
gloo or to the CPU.

    python -m vtpu_manager_torch.workloads.ranks --job mod:fn --rank r \\
        --world n --store <file> --backend nccl|gloo --device cuda|cpu \\
        [--args <json>] [--go-file <path>]

is one rank; `Ranks` starts all of them and collects their results.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist

from vtpu_manager_torch.util.torchplatform import (cap_cpu_threads,
                                                   resolve_device)

RANK_MODULE = "vtpu_manager_torch.workloads.ranks"
RESULT_TAG = "RANK_RESULT "
# a collective that waits longer than this on a lost peer raises
COLLECTIVE_TIMEOUT_S = 180


@dataclass(frozen=True)
class Rank:
    rank: int
    world: int
    device: torch.device
    backend: str


def default_backend(device: str | torch.device | None = None) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def rank_device(rank: int, device: str | torch.device | None,
                backend: str) -> torch.device:
    """The device a rank computes on. Over NCCL each rank takes its own
    card; over gloo on the card the ranks share the cards in turn."""
    dev = resolve_device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError("CPU ranks run over gloo")
        return dev
    count = torch.cuda.device_count()
    if backend == "nccl" and rank >= count:
        raise RuntimeError(
            f"rank {rank} over NCCL needs card {rank}, this machine has "
            f"{count}: NCCL takes one card per rank (ask for gloo to share "
            f"a card)")
    return torch.device("cuda", rank % count)


def init(rank: int, world: int, store: str, backend: str,
         device: str | torch.device | None = None) -> Rank:
    """Joins the group through the file store at `store`."""
    dev = rank_device(rank, device, backend)
    kwargs = {}
    if dev.type == "cpu":
        cap_cpu_threads()          # the ranks share the host's cores
    else:
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev          # eager init: errors here
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kwargs)
    return Rank(rank, world, dev, backend)


def _job(spec: str):
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)


def _wait_file(path: str, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"go file {path} never appeared")
        time.sleep(0.02)


class Ranks:
    """`world` rank processes of one job, started at once. With `go_file`,
    each imports torch and the job, then waits for that file before it
    touches a device or the group, so a caller can start them early and
    release them later. Use as a context manager, or call `close()`: it
    kills what still runs and removes the store."""

    def __init__(self, job: str, world: int, *,
                 device: str | torch.device | None = None,
                 backend: str | None = None, args: dict | None = None,
                 env: dict | None = None, go_file: str | None = None):
        dev = resolve_device(device)
        self.backend = backend or default_backend(dev)
        self.world = world
        self._dir = tempfile.mkdtemp(prefix="vtpu-ranks-")
        store = os.path.join(self._dir, "store")
        base_env = dict(os.environ if env is None else env)
        repo = str(Path(__file__).resolve().parents[2])
        base_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, base_env.get("PYTHONPATH")) if p)
        self._procs = []
        self._logs = []
        try:
            for rank in range(world):
                out = open(os.path.join(self._dir, f"rank{rank}.out"), "w+")
                err = open(os.path.join(self._dir, f"rank{rank}.err"), "w+")
                self._logs.append((out, err))
                cmd = [sys.executable, "-m", RANK_MODULE, "--job", job,
                       "--rank", str(rank), "--world", str(world),
                       "--store", store, "--backend", self.backend,
                       "--device", dev.type, "--args", json.dumps(args or {})]
                if go_file:
                    cmd += ["--go-file", go_file]
                self._procs.append(subprocess.Popen(
                    cmd, stdout=out, stderr=err, env=base_env))
        except BaseException:
            self.close()
            raise

    def _tail(self, rank: int, n: int = 3000) -> str:
        out, err = self._logs[rank]
        out.seek(0)
        err.seek(0)
        return (out.read()[-n:] + "\n--- stderr ---\n" + err.read()[-n:])

    def _stdout(self, rank: int) -> str:
        out = self._logs[rank][0]
        out.seek(0)
        return out.read()

    def results(self, timeout: float = 300.0) -> list[dict]:
        """Each rank's result, in rank order. A rank that fails or outlives
        `timeout` fails the launch: the others are killed (a lost rank
        leaves its peers blocked in a collective) and the error carries
        every failed rank's output."""
        deadline = time.monotonic() + timeout
        while True:
            codes = [proc.poll() for proc in self._procs]
            failed = [(r, f"exit {c}") for r, c in enumerate(codes)
                      if c not in (None, 0)]
            if not failed and None not in codes:
                break
            if not failed and time.monotonic() > deadline:
                failed = [(r, f"still running after {timeout} s")
                          for r, c in enumerate(codes) if c is None]
            if failed:
                self.kill()
                detail = "\n".join(f"rank {r} ({why}):\n{self._tail(r)}"
                                   for r, why in failed)
                raise RuntimeError(
                    f"{self.world}-rank launch failed: {detail}")
            time.sleep(0.05)
        out = []
        for rank in range(self.world):
            lines = [ln for ln in self._stdout(rank).splitlines()
                     if ln.startswith(RESULT_TAG)]
            if not lines:
                raise RuntimeError(f"rank {rank} printed no result:\n"
                                   f"{self._tail(rank)}")
            out.append(json.loads(lines[-1][len(RESULT_TAG):]))
        return out

    def kill(self) -> None:
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self._procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def close(self) -> None:
        self.kill()
        for out, err in self._logs:
            out.close()
            err.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> Ranks:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch(job: str, world: int, *, device: str | torch.device | None = None,
           backend: str | None = None, args: dict | None = None,
           env: dict | None = None, timeout: float = 300.0) -> list[dict]:
    """Runs `job` on `world` ranks; every rank's result, in rank order."""
    with Ranks(job, world, device=device, backend=backend, args=args,
               env=env) as ranks:
        return ranks.results(timeout)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--job", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), required=True)
    p.add_argument("--args", default="{}")
    p.add_argument("--go-file")
    a = p.parse_args(argv)
    fn = _job(a.job)
    if a.go_file:
        _wait_file(a.go_file, COLLECTIVE_TIMEOUT_S)
    rank = init(a.rank, a.world, a.store, a.backend, a.device)
    try:
        result = fn(rank, **json.loads(a.args))
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        # the peers may wait on this rank in a collective: leave at once
        # (the launcher kills them) rather than through the group's teardown
        os._exit(1)
    # every rank leaves together: a rank that exits while a peer still
    # sends to it would fail that peer's last collective
    dist.barrier()
    dist.destroy_process_group()
    print(RESULT_TAG + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
