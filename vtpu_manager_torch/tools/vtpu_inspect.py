#!/usr/bin/env python3
"""vtpu_inspect: dump a node's shared enforcement state.

The port's `library/tools/vtpu_inspect.py`: each container's config (and
its registry-attested `pids.config`), the memory ledger and the node
watcher's feed, read through the port's own layouts
(`config/vtpu_config.py`, `config/vmem.py`, `config/tc_watcher.py`,
`registry/server.py read_pids_config`). Every line the JAX tool prints
is printed the same way; the port adds, per container, the quota
market's generation and the migration freeze (`quota:`), and per device
its lease and the compute percent it is paced to under it
(`dev[i] lease=`).

    python -m vtpu_manager_torch.tools.vtpu_inspect [--base /etc/vtpu-manager]
        [--vmem <ledger>] [--tc <feed>] [--watch SEC]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import TextIO

from vtpu_manager_torch import quota
from vtpu_manager_torch.config import tc_watcher, vtpu_config as vc
from vtpu_manager_torch.config.vmem import VmemLedger
from vtpu_manager_torch.metrics.collector import _age_seconds
from vtpu_manager_torch.registry.server import read_pids_config
from vtpu_manager_torch.util import consts

# the lines this tool prints beyond the JAX tool's
PORT_ONLY_PREFIXES = ("    quota: ",)
PORT_ONLY_MARK = " lease="


def port_only(line: str) -> bool:
    """Whether `line` is one the port adds to the JAX tool's dump."""
    return line.startswith(PORT_ONLY_PREFIXES) or (
        line.startswith("    dev[") and PORT_ONLY_MARK in line)


def dump_configs(base: str, out: TextIO) -> None:
    print(f"== container configs under {base}", file=out)
    found = False
    if os.path.isdir(base):
        for entry in sorted(os.listdir(base)):
            path = os.path.join(base, entry, "config", "vtpu.config")
            if not os.path.exists(path):
                continue
            found = True
            try:
                cfg = vc.read_config(path)
            except (OSError, ValueError) as e:
                print(f"  {entry}: UNREADABLE ({e})", file=out)
                continue
            print(f"  {entry}: pod={cfg.pod_namespace}/{cfg.pod_name} "
                  f"compat={cfg.compat_mode:#x}", file=out)
            print(f"    quota: epoch={cfg.quota_epoch} "
                  f"class={cfg.workload_class} "
                  f"freeze={cfg.migration_freeze} "
                  f"freeze_epoch={cfg.freeze_epoch}", file=out)
            for dev in cfg.devices:
                print(f"    dev[{dev.host_index}] {dev.uuid} "
                      f"cap={dev.total_memory >> 20}MiB "
                      f"core={dev.hard_core}..{dev.soft_core} "
                      f"limit={dev.core_limit} "
                      f"oversold={int(dev.memory_oversold)}", file=out)
                effective = (0 if dev.core_limit == vc.CORE_LIMIT_NONE else
                             quota.effective_core(dev.hard_core,
                                                  dev.lease_core))
                print(f"    dev[{dev.host_index}] lease={dev.lease_core:+d} "
                      f"effective={effective}", file=out)
            pids = os.path.join(base, entry, "config",
                                consts.PIDS_CONFIG_NAME)
            if os.path.exists(pids):
                try:
                    print(f"    pids: {read_pids_config(pids)}", file=out)
                except ValueError:
                    print("    pids: UNREADABLE", file=out)
    if not found:
        print("  (none)", file=out)


def dump_ledger(path: str, out: TextIO) -> None:
    print(f"== vmem ledger {path}", file=out)
    try:
        ledger = VmemLedger(path)
    except (OSError, ValueError):
        print("  (absent)", file=out)
        return
    entries = ledger.entries()
    ledger.close()
    if not entries:
        print("  (empty)", file=out)
    for e in entries:
        print(f"  pid={e.pid} device={e.host_index} "
              f"bytes={e.bytes} ({e.bytes >> 20}MiB) "
              f"token={e.owner_token:016x} activity={e.activity}", file=out)


def dump_watcher(path: str, out: TextIO) -> None:
    print(f"== tc_util feed {path}", file=out)
    try:
        feed = tc_watcher.TcUtilFile(path)
    except (OSError, ValueError):
        print("  (absent)", file=out)
        return
    cal = feed.read_calibration_full()
    if cal is not None:
        table, ts = cal
        age = _age_seconds(ts) if ts else None
        pts = ",".join(f"{g}:{e}" for g, e in table)
        print(f"  calibration: {pts}"
              + (f" (age {age:.0f}s)" if age is not None else ""), file=out)
    else:
        print("  calibration: (none)", file=out)
    shown = 0
    for i in range(tc_watcher.MAX_DEVICE_COUNT):
        rec = feed.read_device(i)
        if rec is None or rec.timestamp_ns == 0:
            continue
        shown += 1
        fresh = "fresh" if rec.is_fresh() else "STALE"
        procs = [(p.pid, f"{p.util}%", f"{p.owner_token:016x}")
                 for p in rec.procs]
        print(f"  dev[{i}] util={rec.device_util}% {fresh} procs={procs}",
              file=out)
    feed.close()
    if not shown:
        print("  (no samples)", file=out)


def dump(base: str, vmem: str, tc: str, out: TextIO = sys.stdout) -> None:
    dump_configs(base, out)
    dump_ledger(vmem, out)
    dump_watcher(tc, out)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", default=consts.MANAGER_BASE_DIR)
    parser.add_argument("--vmem", default=consts.VMEM_NODE_CONFIG)
    parser.add_argument("--tc", default=consts.TC_UTIL_CONFIG)

    def non_negative(value: str) -> float:
        sec = float(value)
        if sec < 0:
            raise argparse.ArgumentTypeError("must be >= 0")
        return sec

    parser.add_argument("--watch", type=non_negative, default=0,
                        metavar="SEC",
                        help="redraw every SEC seconds (ctrl-c to stop)")
    args = parser.parse_args(argv)
    try:
        while True:
            if args.watch:
                print("\x1b[2J\x1b[H", end="")   # clear + home
                print(time.strftime("vtpu_inspect  %H:%M:%S"))
            dump(args.base, args.vmem, args.tc)
            if not args.watch:
                return 0
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
