"""HBMOvercommit on one card: a tenant past the card's physical memory
spills to host memory under the node's budget.

    python -m vtpu_manager_torch.bench_overcommit     # on the card

The port of the JAX package's `scripts/bench_overcommit.py` scenario, on
an H100 with the node agent running as `cmd/device_plugin.py` runs it
with `--feature-gates StepTelemetry=true,HBMOvercommit=true
--spill-budget-gib <budget>` (`start_overcommit`, its publisher every
PUBLISH_S). Checks, each one `OVERCOMMIT {json}` line:

- `ratio`: two StepTelemetry tenants of one class, each allocated
  SAMPLE_CAP and touching SAMPLE_TOUCH, give the policy its memory
  high-waters; the published annotation decodes (`parse_overcommit`) to a
  ratio above 1, the one the policy's formula gives for the samples the
  policy held at the annotation's stamp;
- `overflow`: a hold pod takes the card's memory but HEADROOM; a spill pod
  (SPILL_CAP, allocated at that ratio) takes RESIDENT within physical,
  then asks OVERFLOW, past physical: it is served from host memory (the
  driver reads back a host location for the memory mapped there), the
  ledger's
  `spilled` is exactly those bytes, and the card's free memory does not
  drop by them when the tenant writes a pattern over all of them, which
  reads back equal; its step runs `attn_block` with K and V in the
  overflow, within TOL of the plain version on the same inputs; the
  ring's spill block, the exporter's spill series (the collector with
  HBMOvercommit) and the host pool agree with the ledger; the next
  OVERFLOW is refused (torch.cuda.OutOfMemoryError, and a driver call
  past the budget refused, `vtpu_spill_rejected_total` up by 1); a pod
  allocated with the gate off is refused the same OVERFLOW and granted
  OFF_GRANT within its cap while the overflow is touched; after the
  spill pod's free, `spilled` is 0. The time to write a GiB into the
  overflow, against a GiB on the card, is reported.

The sizes follow the card: the hold pod takes what the card has free less
HEADROOM, so the ledger's physical check (against the device's memory as
discovery gives it) and the card's own free memory both bind.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from vtpu_manager_torch.util import consts

GIB = 2**30
MIB = 2**20
PUBLISH_S = 0.5
SAMPLE_CAP = 16 * GIB
SAMPLE_TOUCH = GIB
SAMPLE_S = 3.0
HEADROOM = 8 * GIB       # the card's free memory the hold pod leaves
RESIDENT = 2 * GIB       # the spill pod's bytes within physical
SPILL_CAP = 32 * GIB
OFF_GRANT = 2 * GIB
CHUNK = 128 * MIB
TOL = 1e-4
ATTN_SHAPE = (8, 16, 512, 128)
CHECKS = ("ratio", "overflow")
# pod: (kubelet's slot, the plugin's gate)
PODS = {"pod-s1": (0, True), "pod-s2": (1, True), "pod-hold": (2, True),
        "pod-spill": (3, True), "pod-off": (0, False)}
# CUmemLocationType: the host, a host NUMA node, the current one
HOST_LOCATIONS = (2, 3, 4)


def sizes(physical: int, card_free: int) -> dict:
    """The hold pod's bytes (what the card has free less HEADROOM, in
    whole 2 MiB: PyTorch's segment size), an overflow the ledger's
    headroom cannot take (the hold pod's and RESIDENT taken from the
    device's physical memory), rounded up to a GiB, and a budget that takes
    it once and not twice (half as much again)."""
    hold = (card_free - HEADROOM) // (2 * MIB) * (2 * MIB)
    ledger_headroom = physical - hold - RESIDENT
    ovf = (max(ledger_headroom, 0) // GIB + 1) * GIB
    return {"hold": hold, "overflow": ovf,
            "budget": ovf + ovf // (2 * GIB) * GIB}


def policy_ratio(samples: list[tuple[float, float]], key: str) -> float:
    """The policy's formula for one class (`overcommit/policy.py`),
    written out again: p95 of the live fractions times the class's safety,
    floored at 1/MAX_RATIO, inverted, scaled by the least confidence."""
    from vtpu_manager_torch.overcommit import policy
    live = sorted(min(max(f, 0.0), 1.0) for f, c in samples if c > 0)
    if len(live) < 2:
        return 1.0
    idx = int(round(0.95 * (len(live) - 1)))
    envelope = max(live[idx] * policy.SAFETY_FACTOR[key], 0.25)
    conf = min(c for _, c in samples if c > 0)
    return round(1.0 + (min(1.0 / envelope, 4.0) - 1.0) * conf, 2)


class Phase:
    def __init__(self, torch, shim: str, root: str):
        from vtpu_manager_torch import bench_allocate as ba
        from vtpu_manager_torch import bench_quota as bq
        from vtpu_manager_torch.cmd.device_plugin import start_overcommit

        self.torch = torch
        self.root = Path(root)
        torch.cuda.empty_cache()
        self.card_free, _ = torch.cuda.mem_get_info()
        self.node = ba.Node(root, shim)
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")
        # the tenants' processes, their imports done while the node starts
        self.pool = bq.TenantPool(
            str(self.root), os.path.join(self.node.driver_dir,
                                         consts.CONTROL_LIBRARY_NAME),
            len(PODS), module="vtpu_manager_torch.bench_overcommit")
        self.plugins = {gate: self.node.plugin(step_telemetry=True)
                        for gate in (True, False)}
        self.sizes = sizes(self.chip.memory, self.card_free)
        self.publisher = start_overcommit(
            self.plugins[True], self.node.client, self.node.name,
            self.node.manager.chips, self.node.base_dir,
            os.path.join(self.node.watcher_dir,
                         os.path.basename(consts.TC_UTIL_CONFIG)),
            self.sizes["budget"] / GIB, interval_s=PUBLISH_S)
        self.resp: dict = {}
        self.tenants: dict = {}
        self.go = {pod: str(self.root / f"{pod}.go") for pod in PODS}
        self.oc = None

    def _allocate(self, pod: str, cap: int):
        from vtpu_manager_torch import bench_allocate as ba
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import device_id
        slot, gate = PODS[pod]
        self.node.client.add_pod(ba.committed_pod(pod, self.chip, 0, cap))
        (resp,) = self.plugins[gate].allocate(api.AllocateRequest(
            [api.ContainerAllocateRequest([device_id(self.chip.uuid, slot)])]
        )).container_responses
        self.resp[pod] = resp
        return resp

    def _start(self, pod: str, cap: int, *args: str):
        from vtpu_manager_torch import bench_allocate as ba
        env = ba.container_env(self._allocate(pod, cap))
        env["VTPU_LOGGER_LEVEL"] = "2"
        self.tenants[pod] = self.pool.take(pod, [
            "-m", "vtpu_manager_torch.bench_overcommit", "--tenant",
            *args, "--go-file", self.go[pod]], env)
        return self.tenants[pod]

    def ledger(self) -> dict:
        from vtpu_manager_torch.config.vmem import VmemLedger
        led = VmemLedger(os.path.join(self.node.vmem_dir, os.path.basename(
            consts.VMEM_NODE_CONFIG)))
        try:
            return {"resident": led.device_total(self.chip.index),
                    "spilled": led.node_spilled_total()}
        finally:
            led.close()

    # -- ratio ------------------------------------------------------------

    def check_ratio(self) -> dict:
        from vtpu_manager_torch.overcommit import ratio
        t0 = time.monotonic()
        for pod in ("pod-s1", "pod-s2"):
            self._start(pod, SAMPLE_CAP, "sample")
            Path(self.go[pod]).touch()
        samples = {pod: self.tenants[pod].line("SAMPLE", 120)
                   for pod in ("pod-s1", "pod-s2")}
        for pod in ("pod-s1", "pod-s2"):
            self.tenants[pod].proc.wait(timeout=60)
        # no sample comes after the tenants' exit: an annotation published
        # from then on was computed from the samples the ledger holds now
        gone = time.time()
        key = ratio.CLASS_KEYS[""]
        deadline = time.monotonic() + 30
        oc = None
        while time.monotonic() < deadline:
            raw = self.node.client.get_node(self.node.name)["metadata"][
                "annotations"].get(consts.node_overcommit_annotation())
            oc = ratio.parse_overcommit(raw)
            if oc is not None and oc.ts > gone + 2 * PUBLISH_S:
                break
            time.sleep(0.1)
        self.oc = oc
        if oc is None:
            return {"ok": False, "error": "no overcommit annotation"}
        # the samples the policy held at the annotation's stamp
        held = self.plugins[True].overcommit_policy.ledger \
            .hbm_fraction_samples(oc.ts).get(key, [])
        want = policy_ratio(held, key)
        verdicts = {"above_one": oc.ratios[key] > 1.0,
                    # the stamp is rounded to the ms: one hundredth
                    "formula": abs(oc.ratios[key] - want) <= 0.0101,
                    "two_tenants": len(held) == 2,
                    "rings": all(s["ring_records"] > 0
                                 for s in samples.values())}
        return {"ok": all(verdicts.values()), "verdicts": verdicts,
                "annotation": oc.encode(), "ratio": oc.ratios[key],
                "formula": want, "samples": held, "tenants": samples,
                "seconds_to_publish": time.monotonic() - t0}

    # -- overflow ---------------------------------------------------------

    def check_overflow(self) -> dict:
        torch = self.torch
        if self.oc is None:
            return {"ok": False, "error": "no ratio"}
        from vtpu_manager_torch.overcommit import ratio
        physical = self.chip.memory
        hold, ovf, budget = (self.sizes[k] for k in ("hold", "overflow",
                                                     "budget"))
        t_hold = self._start("pod-hold", hold, "hold", "--bytes", str(hold))
        policy = self.plugins[True].overcommit_policy
        ratios = [ratio.ratio_for_class(policy.compute(), "")]
        t_spill = self._start("pod-spill", SPILL_CAP, "spill", "--bytes",
                              str(RESIDENT), "--overflow", str(ovf))
        ratios.append(ratio.ratio_for_class(policy.compute(), ""))
        t_off = self._start("pod-off", SPILL_CAP, "off", "--bytes", str(ovf),
                            "--grant", str(OFF_GRANT))
        cfg = self.resp["pod-spill"]
        out: dict = {"physical": physical, "card_free": self.card_free,
                     "hold": hold, "overflow": ovf, "budget": budget,
                     "allocate_ratios": ratios}
        for t in (t_hold, t_spill, t_off):
            t.line("READY", 120)
        Path(self.go["pod-hold"]).touch()
        out["hold_pod"] = t_hold.line("HELD", 120)
        Path(self.go["pod-spill"]).touch()
        out["staged"] = t_spill.line("STAGED", 120)
        free0, _ = torch.cuda.mem_get_info()
        Path(self.go["pod-spill"] + ".1").touch()
        out["spill"] = t_spill.line("SPILLED", 300)
        free1, _ = torch.cuda.mem_get_info()
        out["ledger_held"] = self.ledger()
        out["exporter"], out["ring"] = self._spill_series("pod-spill")
        Path(self.go["pod-spill"] + ".2").touch()
        out["refused"] = t_spill.line("REFUSED", 120)
        Path(self.go["pod-off"]).touch()
        out["off"] = t_off.line("OFF", 120)
        Path(self.go["pod-spill"] + ".3").touch()
        out["freed"] = t_spill.line("FREED", 120)
        out["ledger_freed"] = self.ledger()
        Path(self.go["pod-off"] + ".2").touch()
        Path(self.go["pod-hold"] + ".2").touch()
        for t in (t_hold, t_spill, t_off):
            t.proc.wait(timeout=60)
        out["card_free_drop"] = free0 - free1
        from vtpu_manager_torch.config import vtpu_config as vc
        from vtpu_manager_torch import bench_allocate as ba
        dev = vc.read_config(ba.host_path(cfg, consts.CONTAINER_CONFIG)) \
            .devices[0]
        s, r, o = out["spill"], out["refused"], out["off"]
        verdicts = {
            # the ratio the policy gave as Allocate ran, read just before
            # and just after it
            "virtual_from_ratio": int(physical * min(ratios))
            <= dev.virtual_hbm_bytes <= int(physical * max(ratios))
            and min(ratios) > 1.0,
            "budget_stamped": dev.spill_budget_bytes == budget,
            "resident_granted": s["resident_ok"],
            "overflow_on_host": s["where"] == "host",
            "ledger_spilled": out["ledger_held"]["spilled"] == ovf
            and s["spilled"] == ovf,
            "card_memory_untouched": out["card_free_drop"] < GIB,
            "pattern": s["pattern_ok"],
            "attn_block": s["attn_err"] <= TOL and s["attn_launches"] >= 1,
            "ring_spill_block": out["ring"]["spilled_bytes"] == ovf
            and out["ring"]["spill_events"] == 1,
            "exporter_series": out["exporter"]["vtpu_node_spilled_bytes"]
            == ovf and out["exporter"]["vtpu_node_spill_events_total"] == 1
            and out["exporter"]["vtpu_node_spill_pool_bytes"] == 0,
            "pool_empty": out["exporter"]["pool"] == [0, 0],
            "refused_torch": r["torch_oom"]
            and r["torch_rejected"] == r["torch_oom_rejected"] >= 1,
            "refused_driver": r["driver_rc"] == 2 and r["driver_rejected"]
            == 1 and r["driver_oom_rejected"] == 1,
            "gate_off_refused": o["big_oom"] and o["spills"] == 0
            and o["rejected"] == 0,
            "co_tenant_granted": o["grant_ok"],
            "freed": out["freed"]["spilled"] == 0
            and out["ledger_freed"]["spilled"] == 0,
        }
        out["verdicts"] = verdicts
        out["ok"] = all(verdicts.values())
        out["virtual_hbm_bytes"] = dev.virtual_hbm_bytes
        out["attn_block_launches"] = s["attn_launches"]
        return out

    def _spill_series(self, pod: str) -> tuple[dict, dict]:
        """The collector's spill series with HBMOvercommit, and the spill
        block summed over the pod's ring."""
        from vtpu_manager_torch import bench_allocate as ba
        from vtpu_manager_torch.metrics.collector import NodeCollector
        from vtpu_manager_torch.overcommit.spill import pool_totals
        from vtpu_manager_torch.telemetry import stepring
        pool_dir = self.plugins[True].spill_pool_host_dir()
        text = NodeCollector(
            self.node.name, self.node.manager.chips,
            base_dir=self.node.base_dir,
            tc_path=os.path.join(self.node.watcher_dir, os.path.basename(
                consts.TC_UTIL_CONFIG)),
            vmem_path=os.path.join(self.node.vmem_dir, os.path.basename(
                consts.VMEM_NODE_CONFIG)),
            pod_resources_socket=str(self.root / "no-kubelet.sock"),
            kubelet_checkpoint=str(self.root / "no-checkpoint"),
            overcommit_enabled=True, spill_dir=pool_dir).render()
        series = {line.split("{", 1)[0]: float(line.rsplit(" ", 1)[1])
                  for line in text.splitlines()
                  if line.startswith("vtpu_node_spill")
                  or line.startswith("vtpu_node_fill")}
        series["pool"] = list(pool_totals(pool_dir))
        ring_path = ba.host_path(self.resp[pod], os.path.join(
            consts.MANAGER_BASE_DIR, consts.TELEMETRY_SUBDIR,
            consts.STEP_RING_NAME))
        reader = stepring.StepRingReader(ring_path)
        try:
            records, _, _ = reader.poll(0)
        finally:
            reader.close()
        ring = {"records": len(records),
                "spilled_bytes": records[-1].spilled_bytes if records else 0,
                "spill_events": sum(r.spill_events for r in records),
                "fill_events": sum(r.fill_events for r in records),
                "spill_fill_time_ns": sum(r.spill_fill_time_ns
                                          for r in records)}
        return series, ring

    def close(self) -> None:
        for pod in PODS:
            for suffix in ("", ".2", ".3"):
                Path(self.go[pod] + suffix).touch()
        for t in self.tenants.values():
            try:
                t.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass          # stop() kills it
            t.stop()
        self.pool.close()
        self.publisher.stop()
        self.node.close()


# --- the tenants (the pods' processes) ---------------------------------------

def _counters() -> dict:
    from vtpu_manager_torch import bench_quota as bq
    out = bq.shim_counters()
    lib = ctypes.CDLL(None)
    fn = lib.vtpu_spilled_bytes
    fn.restype, fn.argtypes = ctypes.c_int64, [ctypes.c_int]
    out["spilled"] = int(fn(0))
    return out


def _wait(path: str) -> None:
    from vtpu_manager_torch.bench_quota import _wait_file
    _wait_file(path, timeout_s=600.0, poll_s=0.01)


def _where(ptr: int) -> str:
    """Where the physical memory mapped at `ptr` lies, as the driver reads
    it back (cuMemRetainAllocationHandle, then
    cuMemGetAllocationPropertiesFromHandle): "host", "device", or "none"
    when no mapping of the overflow tier's kind is there."""
    lib = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_ulonglong(0)
    if lib.cuMemRetainAllocationHandle(ctypes.byref(handle),
                                       ctypes.c_void_p(ptr)) != 0:
        return "none"
    prop = (ctypes.c_ubyte * 32)()      # CUmemAllocationProp
    rc = lib.cuMemGetAllocationPropertiesFromHandle(ctypes.byref(prop),
                                                    handle)
    lib.cuMemRelease(handle)
    if rc != 0:
        return "none"
    location = int.from_bytes(bytes(prop[8:12]), "little")
    return "host" if location in HOST_LOCATIONS else f"device ({location})"


def _sample(args) -> None:
    import torch
    print("READY", flush=True)
    _wait(args.go_file)
    touch = torch.ones(SAMPLE_TOUCH // 4, device="cuda")
    a = torch.randn(1024, 1024, device="cuda")
    t0 = time.monotonic()
    steps = 0
    while time.monotonic() - t0 < SAMPLE_S:
        (a @ a).sum()
        touch.mul_(1.0)
        torch.cuda.synchronize()
        steps += 1
    lib = ctypes.CDLL(None)
    lib.vtpu_step_records_total.restype = ctypes.c_uint64
    lib.vtpu_peak_bytes.restype = ctypes.c_int64
    lib.vtpu_peak_bytes.argtypes = [ctypes.c_int]
    print("SAMPLE " + json.dumps({
        "steps": steps, "ring_records": int(lib.vtpu_step_records_total()),
        "peak_bytes": int(lib.vtpu_peak_bytes(0))}), flush=True)


def _hold(args) -> None:
    import torch
    torch.zeros(1, device="cuda")
    print("READY", flush=True)
    _wait(args.go_file)
    buf = torch.empty(args.bytes, dtype=torch.uint8, device="cuda")
    print("HELD " + json.dumps({"bytes": buf.numel(), **_counters()}),
          flush=True)
    _wait(args.go_file + ".2")


def _pattern(torch, scratch, i: int, n: int):
    """Chunk i's pattern, in `scratch` (int32, on the card)."""
    out = scratch[:n]
    torch.arange(n, out=out)
    out.mul_(2654435761 % 2**31).add_(i)
    return out


def _spill(args) -> None:
    import torch

    from vtpu_manager_torch.util.torchplatform import exact_fp32
    from vtpu_manager_torch.workloads import block_attention as ba
    from vtpu_manager_torch.workloads import ring_attention as ra
    exact_fp32()
    torch.zeros(1, device="cuda")
    print("READY", flush=True)
    _wait(args.go_file)
    out: dict = {}
    resident = torch.empty(args.bytes, dtype=torch.uint8, device="cuda")
    out["resident_ok"] = _counters()["spilled"] == 0
    n = CHUNK // 4
    scratch = resident[:CHUNK].view(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(ATTN_SHAPE, generator=gen, device="cuda")
    zero = torch.zeros(ATTN_SHAPE[2], ATTN_SHAPE[2], device="cuda")
    # the step's temporaries, once on the card, so that the caching
    # allocator holds them before the overflow (the card's free memory is
    # read on both sides of it)
    kv_card = torch.randn((2, *ATTN_SHAPE), generator=gen, device="cuda")
    o, m_, l_ = ba.attention_block(q, kv_card[0], kv_card[1], zero)
    ba.combine_blocks([ra.block_partials(q, kv_card[0], kv_card[1], zero)])
    ba.combine_blocks([(o, m_, l_)])
    torch.equal(scratch, scratch)
    del kv_card, o, m_, l_
    torch.cuda.synchronize()
    print("STAGED " + json.dumps(_counters()), flush=True)
    _wait(args.go_file + ".1")
    before = _counters()
    ovf = torch.empty(args.overflow, dtype=torch.uint8, device="cuda")
    after = _counters()
    out["spilled"] = after["spilled"]
    out["spills"] = after["vtpu_spills_total"] - before["vtpu_spills_total"]
    out["where"] = _where(ovf.data_ptr())
    words = ovf.view(torch.int32)
    chunks = math.ceil(words.numel() / n)
    # a GiB written into the overflow, against a GiB on the card
    gib_chunks = GIB // CHUNK
    card = resident[CHUNK:CHUNK + GIB].view(torch.int32)
    pat = _pattern(torch, scratch, 0, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(gib_chunks):
        card[i * n:(i + 1) * n].copy_(pat)
    torch.cuda.synchronize()
    out["card_gib_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(chunks):
        m = min(n, words.numel() - i * n)
        words[i * n:i * n + m].copy_(_pattern(torch, scratch, i, m))
        if i == gib_chunks - 1:
            torch.cuda.synchronize()
            out["overflow_gib_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    out["overflow_write_s"] = time.perf_counter() - t0
    ok = True
    t0 = time.perf_counter()
    for i in range(chunks):
        m = min(n, words.numel() - i * n)
        ok &= bool(torch.equal(words[i * n:i * n + m],
                               _pattern(torch, scratch, i, m)))
    out["overflow_read_s"] = time.perf_counter() - t0
    out["pattern_ok"] = ok
    # the step: attn_block with K and V in the overflow
    kv = ovf[:2 * q.numel() * 4].view(torch.float32).view(2, *ATTN_SHAPE)
    kv.copy_(torch.randn((2, *ATTN_SHAPE), generator=gen, device="cuda"))
    k, v = kv[0], kv[1]
    ba.reset_launches()
    for _ in range(3):
        o, m_, l_ = ba.attention_block(q, k, v, zero)
        torch.cuda.synchronize()
    ro, rm, rl = ra.block_partials(q, k, v, zero)
    err = (ba.combine_blocks([(o, m_, l_)])
           - ba.combine_blocks([(ro, rm, rl)])).abs().max().item()
    out["attn_err"] = err
    out["attn_launches"] = ba.LAUNCHES["attn_block"]
    out["kv_where"] = _where(kv.data_ptr())
    out.update({k_: v_ for k_, v_ in _counters().items()
                if "spill" in k_ or k_ == "vtpu_step_records_total"})
    print("SPILLED " + json.dumps(out), flush=True)
    _wait(args.go_file + ".2")
    # past the budget: through torch, then one driver call
    c0 = _counters()
    try:
        torch.empty(args.overflow, dtype=torch.uint8, device="cuda")
        oom = False
    except torch.cuda.OutOfMemoryError:
        oom = True
    c1 = _counters()
    ptr = ctypes.c_uint64(0)
    rc = ctypes.CDLL("libcuda.so.1").cuMemAlloc_v2(
        ctypes.byref(ptr), ctypes.c_size_t(args.overflow))
    c2 = _counters()
    print("REFUSED " + json.dumps({
        "torch_oom": oom,
        "torch_rejected": c1["vtpu_spill_rejected_total"]
        - c0["vtpu_spill_rejected_total"],
        "torch_oom_rejected": c1["vtpu_oom_rejected_total"]
        - c0["vtpu_oom_rejected_total"],
        "driver_rc": rc,
        "driver_rejected": c2["vtpu_spill_rejected_total"]
        - c1["vtpu_spill_rejected_total"],
        "driver_oom_rejected": c2["vtpu_oom_rejected_total"]
        - c1["vtpu_oom_rejected_total"]}), flush=True)
    _wait(args.go_file + ".3")
    del ovf, words, kv, k, v
    torch.cuda.empty_cache()
    print("FREED " + json.dumps(_counters()), flush=True)


# the card-only tests' tenant: its config's physical memory small, so that
# the overflow tier engages on a card that is free
PROBE_PHYSICAL = GIB
PROBE_VIRTUAL = 2 * GIB
PROBE_BUDGET = 512 * MIB
PROBE_OVERFLOW = 256 * MIB


def run_probe(shim: str, root: str) -> dict:
    """One tenant under `shim` on a node in `root` whose config gives the
    card PROBE_PHYSICAL of physical memory, PROBE_VIRTUAL of virtual
    capacity and a PROBE_BUDGET spill budget, with the pool armed: its
    `PROBE {json}` record (`_probe`)."""
    from vtpu_manager_torch import bench_quota as bq
    world = bq.World(root)
    env = world.env(shim, "pod-probe", cap=4 * GIB,
                    real_memory=PROBE_PHYSICAL,
                    virtual_memory=PROBE_VIRTUAL, spill_budget=PROBE_BUDGET)
    env[consts.ENV_SPILL_POOL_DIR] = os.path.join(root, "spill")
    t = bq.Tenant("probe", ["-m", "vtpu_manager_torch.bench_overcommit",
                            "--tenant", "probe"], env, root)
    try:
        return t.line("PROBE", 300)
    finally:
        t.proc.wait(timeout=60)
        t.stop()


def _probe(args) -> None:
    import torch
    out: dict = {}
    # physical memory but 64 MiB, which the step's small tensors take
    base = torch.empty(PROBE_PHYSICAL - 64 * MIB, dtype=torch.uint8,
                       device="cuda")
    base.fill_(1)
    c0 = _counters()
    ovf = torch.empty(PROBE_OVERFLOW, dtype=torch.uint8, device="cuda")
    c1 = _counters()
    out["where"] = _where(ovf.data_ptr())
    out["spilled"] = c1["spilled"]
    out["spills"] = c1["vtpu_spills_total"] - c0["vtpu_spills_total"]
    words = ovf.view(torch.int32)
    torch.arange(words.numel(), out=words)
    out["pattern_ok"] = bool(torch.equal(
        words[::1024], torch.arange(0, words.numel(), 1024,
                                    dtype=torch.int32, device="cuda")))
    torch.cuda.synchronize()
    try:
        torch.empty(PROBE_BUDGET, dtype=torch.uint8, device="cuda")
        out["refused"] = False
    except torch.cuda.OutOfMemoryError:
        out["refused"] = True
    c2 = _counters()
    out["rejected"] = c2["vtpu_spill_rejected_total"] \
        - c1["vtpu_spill_rejected_total"]
    out["oom_rejected"] = c2["vtpu_oom_rejected_total"] \
        - c1["vtpu_oom_rejected_total"]
    del ovf, words
    torch.cuda.empty_cache()
    out["spilled_after_free"] = _counters()["spilled"]
    print("PROBE " + json.dumps(out), flush=True)


def _off(args) -> None:
    import torch
    torch.zeros(1, device="cuda")
    print("READY", flush=True)
    _wait(args.go_file)
    try:
        torch.empty(args.bytes, dtype=torch.uint8, device="cuda")
        big_oom = False
    except torch.cuda.OutOfMemoryError:
        big_oom = True
    torch.cuda.empty_cache()
    try:
        grant = torch.empty(args.grant, dtype=torch.uint8, device="cuda")
        grant.fill_(7)
        grant_ok = int(grant[-1].item()) == 7
    except torch.cuda.OutOfMemoryError:
        grant_ok = False
    c = _counters()
    print("OFF " + json.dumps({
        "big_oom": big_oom, "grant_ok": grant_ok,
        "spills": c["vtpu_spills_total"],
        "rejected": c["vtpu_spill_rejected_total"],
        "oom_rejected": c["vtpu_oom_rejected_total"]}), flush=True)
    _wait(args.go_file + ".2")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenant",
                    choices=("sample", "hold", "spill", "off", "probe"))
    ap.add_argument("--go-file")
    ap.add_argument("--bytes", type=int, default=0)
    ap.add_argument("--overflow", type=int, default=0)
    ap.add_argument("--grant", type=int, default=0)
    ap.add_argument("--pooled", metavar="TICKET")
    args = ap.parse_args(argv)
    if args.pooled:
        from vtpu_manager_torch.bench_quota import run_pooled
        run_pooled(args.pooled, main)
        return
    if args.tenant:
        {"sample": _sample, "hold": _hold, "spill": _spill, "off": _off,
         "probe": _probe}[args.tenant](args)
        return
    import tempfile

    import torch

    from vtpu_manager_torch import build
    shim = str(build.build_for_card()["shim"])
    with tempfile.TemporaryDirectory(prefix="vtpu-overcommit-") as root:
        phase = Phase(torch, shim, root)
        failed = False
        try:
            for name in CHECKS:
                rec = getattr(phase, f"check_{name}")()
                failed |= not rec["ok"]
                print("OVERCOMMIT " + json.dumps({"check": name, **rec},
                                                 default=str), flush=True)
        finally:
            phase.close()
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
