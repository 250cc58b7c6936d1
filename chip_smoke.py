#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one card, end to end.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

0. card: the card's name and power limit (nvidia-smi) and torch's name;
1. build: the block-attention kernel and the mma.sync probe (nvcc,
   sm_90a) and the interposer (g++), side by side, from the sources in
   this checkout;
2. kernel: `attention_block` against its plain version with TF32 off:
   at the capture's shape (8, 16, 512, 128) fp32 a zero bias, a causal
   bias, a fully masked row, q scaled by 8 (large, peaked scores), two K/V
   blocks merged by `combine_blocks` against exact attention, and bf16
   inputs; then ragged Sq x Sk = 100 x 70 at d = 72. Tolerance 1e-4
   absolute on the normalised output and on m (the sums run in another
   order). Then the kernel's, the plain version's and
   scaled_dot_product_attention's times, the name of the CUDA kernel
   that scaled_dot_product_attention ran (torch.profiler), and the rate of
   mma.sync TF32 alone on this card (csrc/mma_peak.cu);
3. main path, with the launch counts set to 0 before it and read after:
   the trainer at the default config, batch 8 (card logits against the
   same weights on the CPU, then 3 SGD steps whose loss must fall), the
   attention probe `attention_bench.measure()`, `mfu_measure`, and the
   card's busy share of the unthrottled quota step;
4. enforcement, each run a tenant subprocess with the interposer
   preloaded (from processes started ahead with their imports done,
   `bench_quota.TenantPool`, each still timed alone): the 64 MiB cap (capped view, 256 MiB refused with
   torch.cuda.OutOfMemoryError), the quota sweep at 100/50/25 (each share
   within 15 points of its quota), one kernel launch seen by the
   interposer's counter, and the interposer's cost to an unthrottled
   tenant (two pairs without and with it). Then every launch path and
   allocation entry: tenants that replay the quota step and one
   attention-kernel launch from a CUDA graph at q50 and q25, each paired
   with an eager tenant of the same step at quota 100 (shares within 15
   points, q50 above q25, every replay counted, nothing charged during the
   capture, one cooperative launch counted), and under the 64 MiB cap
   256 MiB asked through cuMemAllocManaged, cuMemAllocPitch_v2 and
   cuMemAllocFromPoolAsync (ctypes on libcuda.so.1), each refused with
   CUDA_ERROR_OUT_OF_MEMORY, and 32 MiB granted, freed and granted again;
5. co_tenancy (`vtpu_manager_torch/bench_cotenancy.py`): several tenants
   on the card at once, each reading its limits from its own vtpu.config,
   under the node watcher fed by NVML: discovery, the config file's cap,
   siblings / co-tenant / physical pressure / reap across processes,
   50 + 25, 50 + 50 and 60 / 25 / 10 together, the feed, balance mode,
   and 5 s runs at q50 and q25 (charged against the tenant's kernel time
   read by torch.profiler over 100 steps at its quota after the
   unprofiled charged stretch, each beside a control with the
   isolated-sample discount off); no tenant may be judged blind. The
   compute checks' tenants come from worker processes started ahead with
   their imports done (`bench_quota.TenantPool`; new ones start once a
   batch's timed steps are over). One `COTENANCY {json}` line per check;
6. allocate (`vtpu_manager_torch/bench_allocate.py`): the port's device
   plugin hands slices of the card to tenants. Its device manager over
   NVML registers the node (split 4); pods the scheduler committed (50 %
   and 16 GiB, 25 % and 8 GiB with the step ring, two unmetered) are
   allocated through `VnumPlugin.allocate` and `pre_start_container`
   (which writes a deleted config file again); tenants started from
   nothing but the responses (this phase stands in for the container
   runtime's mounts) run the quota step, hold their caps, launch the
   attention kernel under the interposer, and write one step record per
   step into the rings the plugin mounted. One `ALLOCATE {json}` line per
   check;
7. dra (`vtpu_manager_torch/bench_dra.py`): the port's DRA kubelet plugin
   hands slices of the card to tenants. Its ResourceSlice names the card
   NVML sees; claims the DRA scheduler allocated (50 % and 16 GiB over two
   slots, 25 % and 8 GiB, one over its slot, and one of two requests) are
   prepared through `DraDriver.node_prepare`; tenants started from
   nothing but the CDI specs it wrote (this phase stands in for the
   container runtime) hold their shares and caps, a claim's two processes
   share its cap (and, with the JAX package's environment, do not), and
   a restarted driver keeps its claims. One `DRA {json}` line per check;
8. cluster (`vtpu_manager_torch/bench_cluster.py`): the same path with a
   stub API server over TLS and a fake NRI runtime in place of what the
   `dra` phase plays itself. The kubelet plugin's driver, with the
   in-cluster client pointed at the stub, publishes its ResourceSlice (PUT,
   then POST) and fetches the claims it prepares; the port's NRI plugin
   registers with the runtime, which has it adjust a claim's container,
   refuse a container whose environment names a claim its pod does not
   own, and leave a non-tenant container untouched; tenants started from
   the CDI environment and the NRI adjustment hold 50 % and 25 % with exact
   caps; the device plugin's Allocate over the in-cluster client answers
   as over the fake client. One `CLUSTER {json}` line per check;
9. monitor (`vtpu_manager_torch/bench_monitor.py`): the port's node
   exporter (`cmd/device_monitor.py`, a subprocess on 127.0.0.1 with a
   bearer token and UtilizationLedger) reports each tenant's slice. The
   device plugin allocates 50 % / 16 GiB (one attention-kernel launch per
   step) and 25 % / 8 GiB, both with the step ring, and an idle pod of
   50 % / 8 GiB that sleeps between steps (about 10 % of the card),
   beside a kubelet checkpoint naming them and an orphan config dir it
   does not name; while the tenants run, scrapes must show the card's
   memory and 4 slots, the two tenants' limits, memory in use equal to
   the ledger, attributed shares above 0 in quota order and each within 8
   points of the share of the card its steps took, 125 % of the cores
   assigned, the orphan flagged and no feed in error. The utilization
   ledger (`utilization/`): each /utilization row's allocation is its
   config's, each tenant's used core % lies within 8 points of the share
   its steps took from the exporter's feed and again from a fold of the
   rings alone (U1), the idle pod's reclaimable core is above the busy
   pods' and what its row gives, the headroom annotation goes through a
   TLS stub API server and decodes to the ledger's rollup, vtpu_smi
   prints one row per tenant and the vtrace splice finds the idle pod;
   /utilization answers 401 without the token. After they exit, each
   pod's step count equals its ring's records, the throttle-wait
   fractions are above 0 in quota order, the node pressure is the rings'
   own, and the ledger's series equal the document's rows, each memory
   high-water its ring's peak. The pressure annotation goes through the
   in-cluster client to a TLS stub API server and decodes to what was
   published; the reporters list 100 core devices and one per 256 MiB;
   /healthz and /traces answer, and an exporter with the gate off answers
   /utilization 404 with no utilization series. Each tenant's share
   of the card lies within 5 points of its quota, and what the interposer
   charged it per step within 5 % of the step's card time alone at the
   tenant's duty (R9). F4's pair (a tenant beside a process outside the
   interposer, R11; F4) is not run here: `python -m
   vtpu_manager_torch.bench_monitor --f4` runs it and judges the charge
   against the tenant's own card time inside the pair. One `MONITOR
   {json}` line per check;
10. compile_cache (`vtpu_manager_torch/bench_compilecache.py`): the
   device plugin with the CompileCache gate allocates pods of 25 % (gate
   on: the cache mount, env and config field; gate off: none), and three
   replicas started together from their responses reach the first step of
   a `torch.compile`d step (the 8192 bf16 quota step, an Inductor tail,
   one `vtpu::attn_block` call) in four scenarios: `off` (each compiles:
   3 compiles), `cold` (the store: 1 compile, 2 waits, no torn entry),
   `warm` (3 hits, no compile) and `env` (Inductor's own cache on the
   mount). Then `peer` on a second node B on the card (a device plugin
   with CompileCache and ClusterCompileCache, an empty store, one fake API
   client with the first node A, whose `cold` replicas left their entry's
   `fps/` marker): A's advertiser publishes its warm key with the address
   of A's exporter (gate on, serving `/cache/entry` on loopback), B's
   writes `peers.json`, and B's three replicas fetch: 1 peer fetch and 2
   waits, no Inductor compile, one entry on B and nothing quarantined or
   torn, `vtpu_compile_cache_peer_fetches_total` 1 on B's exporter; its
   time to first step is reported beside `cold`'s and `warm`'s. Every
   replica's outputs within 1e-4 of one that compiled alone, `warm`
   faster to its first step than `off`, the exporter's counters equal to
   the replicas', the kernel launched in every replica and counted by the
   interposer. One `COMPILE_CACHE {json}` line per check;
11. tracing (`vtpu_manager_torch/bench_trace.py`): a pod's
   allocation-path timeline. The device plugin, with the Tracing gate at
   sampling rate 0.5 and CompileCache, allocates a sampled pod S and an
   unsampled pod U (25 % / 8 GiB, contexts minted as the webhook would);
   S's response carries its trace id and the node trace dir, U's only its
   verdict; tenants started from the responses run the compiled step
   through the store (S a cold compile); the DRA driver prepares a claim
   reserved for each; with tracing off a third pod gets no trace env. The
   port's exporter serves S's timeline on /traces (every stage from
   Allocate to the first step, in causal order, no drop), not U's;
   its `vtpu_trace_*` counts equal the spools and the vtrace CLI gives the
   same timeline. Reported beside the card's name and power limit: the
   time from Allocate to the first step's outputs, and Allocate's time
   with tracing off and on. One `TRACING {json}` line per check;
12. resilience (`vtpu_manager_torch/bench_resilience.py`): the node
   survives its own faults and attributes a CLIENT-mode tenant. With the
   failpoint registry armed as FaultInjection arms it, the device
   plugin's Allocate crashes on a torn `vtpu.config`
   (`plugin.config_write=partial-write(count=1)`) and its retry writes it
   whole, and a tenant started from the retried response holds its cap;
   the DRA driver's Prepare crashes on a torn CDI spec
   (`dra.cdi_write=partial-write(count=1)`), the claim is not
   checkpointed, and a restarted DeviceState prepares it whole; the
   plugin's `/metrics` counts the two fires as the registry does, and
   nothing with the registry off. A pod allocated under `compat_mode:
   client` runs two processes (the quota step and one `vtpu::attn_block`
   launch per step each), started outside the repo with a PYTHONPATH that
   lacks it, as from an image without the package; each interposer starts
   the stdlib-only registrar installed beside it in the driver dir, which
   registers over the node registry's socket (a stand-in cgroup, the card
   machine having no kubelet); `pids.config` holds both pids, each
   interposer reads it, the two processes share the one 8 GiB cap, the
   pod's timeline holds the registry's side of each registration, and a
   spoofed pod uid is refused. One `RESILIENCE {json}` line per check;
13. quota_lease (`vtpu_manager_torch/bench_quota_lease.py`): the quota
   market's tenant side and the node's tools. A pod at hard 25 % / 8 GiB
   runs the quota step and one `vtpu::attn_block` launch per step while
   its config is rewritten as the quota market writes it (lease +75, +25,
   then 0: effective 100, 50, then a revoke to 25): each paced stage's
   share (the step's card time, the effective-100 stage's charge per
   step, over the stage's ms per step) within 15 points of its effective
   quota, the effective-100 stage no more than 15 % of its time in the
   throttle wait, from the steps that begin one 2 ms quantum and one
   step after each rename, and every rewrite adopted; then a migration freeze for
   about 1 s: no step begins inside it but the parked one, none ends in
   it, the interposer's freeze wait covers it and its throttle wait does
   not grow by it. `vtpu_busy --duty 100` in a hard-50 pod takes a share
   within 15 points of 50; the host-offload demo over a 1 GiB model in
   pinned host memory, under a 512 MiB cap, finishes, agrees with the
   CPU within 3e-2, and the most the cap granted at once stays under it;
   `vtpu_inspect` shows the lease tenant's current epoch and lease. Then
   the node's quota market (`market`): once those pods are gone, the
   device plugin's market and victim-cost publisher (QuotaMarket, a pass
   every 5 s) and the exporter (UtilizationLedger and QuotaMarket) on a
   TLS stub API server, over a throughput pod at hard 60 % taking about
   12 % of the card and a latency-critical pod at hard 40 % running the
   lease tenant's step back to back: after every pass the card's
   effective quotas sum to at most 100, every config rewrite carries the
   ledger's epoch and deltas, the lease summary decodes to the ledger's
   active leases; the grants raise the borrower's share (each lease
   stage within 15 points of its effective quota, read against the lease
   check's yardstick); the lender's returning demand revokes within two
   passes (`lender-demand`) and the borrower's share is back at 40 within
   15 points; the borrower's interposer adopted every rewrite; the
   victim-cost annotation marks it a borrower while leased and not after;
   /utilization carries the lease block and its borrowed column; both
   pods' timelines hold `quota.grant` and `quota.revoke`. The lease
   tenant's and the borrower's `attn_block` launches are added to the
   kernel record's. One `QUOTA_LEASE {json}` line per check;
14. observation (`vtpu_manager_torch/bench_observation.py`): the device
   plugin starts with `VTPU_OBS_CALIBRATE=1` and calibrates the
   interposer's after-idle discount on the idle card
   (`manager/obs_calibrate.py`, a throwaway process, while the phase's
   tenants start and wait without touching the card); the table is in the
   node annotation, the feed's calibration block, each Allocate response
   and the exporter's `vtpu_node_obs_excess_max_us`, and a tenant's
   interposer adopts it. A q50 tenant that never calls `step_telemetry()`
   (the 8192 bf16 quota step, one `torch.ops.vtpu.attn_block` launch and
   `float(loss)` per step) gets a ring from its interposer: one record per
   step, the median within 10 % of its own step, the throttle waits adding
   up to the interposer's counter, `compiled` on the first steps only, the
   exporter folding it, and the tenant's share within 15 points of 50. A
   tenant that arms the Python writer after its first steps leaves one
   stream in its ring with an unbroken index. Its tenants' `attn_block`
   launches are added to the kernel record's. One `OBSERVATION {json}`
   line per check. The other phases start their plugins with
   `VTPU_OBS_CALIBRATE=0`, as they were accepted;
15. distributed (`vtpu_manager_torch/graft_entry.py`): the multi-device
   dry run on `torch.distributed`, every rank under the interposer with
   CommTelemetry armed as the device plugin's Allocate arms it (the step
   ring's env and `VTPU_COMM_TELEMETRY=true`). World 1 over NCCL:
   `graft_entry.dryrun_multichip(1)` at the trainer's default config on
   its default device (the sharded step's loss finite and within 5e-2 of
   one process's, the ring within 3e-5 of exact attention, the pipeline
   and the MoE layer within 1e-5 of their references), its rank armed, the
   comm block of its ring read after; beside it the same rank
   (`graft_entry.dryrun_rank`) under torch.profiler in a rank process of
   its own: the collectives its interposer counted equal the NCCL kernels
   the profiler lists. World 2 over gloo on this one card (NCCL
   refuses two ranks on one device): two rank processes as one pod's two
   containers (q100, one 16 GiB cap), started with the phase and held at a
   go file while world 1 runs. Each runs the causal ring with the
   block-attention kernel as its block function at the attention probe's
   shape per rank (8, 16, 512, 128), 1024 tokens in all: 2 kernel
   launches per rank, each one launch to the rank's interposer, the output
   within 1e-4 of the plain ring and of exact attention. Across that call
   the rank's interposer counts at least the bytes the rank staged
   through the host for gloo (its n - 1 hops of the K/V shard stack, each
   to the host and back), and no more
   than `COMM_SLACK_BYTES` above them, comm time above 0 and within the
   call's wall, no collective, and the comm block of the records its ring
   gained sums to those deltas. Then the pipeline and MoE checks over both
   ranks and the sharded step at (data 2, model 1) and (data 1, model 2)
   against one process. The port's collector with CommTelemetry renders
   `vtpu_tenant_comm_*` for both ranks' rings, and none with the gate
   off. Its kernel launches are added to the kernel record's.
   `DISTRIBUTED` lines, one `DISTRIBUTED comm {json}` per rank;
16. overcommit (`vtpu_manager_torch/bench_overcommit.py`): a tenant past
   the card's physical memory spills to host memory under the node's
   budget. The device plugin runs with HBMOvercommit and a spill budget;
   two StepTelemetry tenants of one class, each allocated 16 GiB and
   touching 1 GiB, give its policy the rings' memory high-waters, and the
   node's overcommit annotation decodes to a ratio above 1, the one the
   policy's formula gives. A hold pod takes the card's free memory but
   8 GiB; a spill pod allocated at that ratio takes 2 GiB within
   physical, then an overflow the ledger's physical check refuses: the
   interposer serves it from pinned host memory mapped for the card (the
   driver reads back a host location for the memory mapped there), the
   ledger's `spilled` is exactly its bytes, the card's free memory drops
   by less than a GiB while the tenant writes a pattern over all of it
   (read back equal), `attn_block` with K and V in the overflow agrees
   with its plain version within 1e-4, the ring's spill block and the
   exporter's spill series agree with the ledger and the empty pool; the
   next overflow is refused past the budget (torch.cuda.OutOfMemoryError,
   and one driver call: `vtpu_spill_rejected_total` up by 1); a pod
   allocated with the gate off is refused the same bytes and granted
   2 GiB within its cap beside the touched overflow; after the free,
   `spilled` is 0. One `OVERCOMMIT {json}` line per check; its
   `attn_block` launches are added to the kernel record's.

The last three lines are the nvidia-smi line, the kernels JSON and the
result JSON.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import subprocess
import sys
import time
import traceback

TOL_NORMALISED = 1e-4
SHARE_BAND = 15.0
PROBE_SHAPE = (8, 16, 512, 128)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
TF32_FLOPS = 494.7e12            # H100 SXM, dense TF32 on the tensor cores
TF32_SPLIT_TERMS = 3             # the kernel's products, each as 3 TF32 mma


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, n: int = 20, warmup: int = 3) -> float:
    """Mean ms per call by CUDA events around n back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def kernel_names(torch, fn) -> list[str]:
    """The CUDA kernels one call of fn launched, by torch.profiler's
    device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type.name == "CUDA"})


def mma_peak_tflops(torch, path) -> float:
    """TFLOP/s of csrc/mma_peak.cu: mma.sync TF32 alone, two blocks of 8
    warps per SM."""
    fn = ctypes.CDLL(str(path)).mma_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2000
    out = torch.empty(blocks * 256, device="cuda")

    def run():
        err = fn(out.data_ptr(), blocks, iters,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mma_peak launch failed: cudaError_t {err}")

    ms = cuda_ms(torch, run, n=5, warmup=1)
    return blocks * 8 * 16 * iters * 2048 / (ms * 1e-3) / 1e12


def kernel_phase(torch, mma_peak_path) -> dict:
    from vtpu_manager_torch.util.torchplatform import exact_fp32
    from vtpu_manager_torch.workloads import block_attention as ba
    from vtpu_manager_torch.workloads import ring_attention as ra

    exact_fp32()
    b, h, s, d = PROBE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(PROBE_SHAPE, generator=gen, device="cuda")
               for _ in range(3))
    zero = torch.zeros((s, s), device="cuda")
    causal = ra._block_bias(0, 0, s, True, device="cuda")
    masked_row = zero.clone()
    masked_row[7] = float("-inf")

    errs = {}

    def check(name, q_, k_, v_, bias):
        o, m, l = ba.attention_block(q_, k_, v_, bias)
        ro, rm, rl = ra.block_partials(q_.float(), k_.float(), v_.float(),
                                       bias)
        out = ba.combine_blocks([(o, m, l)])
        ref = ba.combine_blocks([(ro, rm, rl)])
        err = (out - ref).abs().max().item()
        same_m = torch.equal(torch.isneginf(m), torch.isneginf(rm)) and \
            torch.allclose(m.nan_to_num(neginf=0.0),
                           rm.nan_to_num(neginf=0.0), atol=1e-4, rtol=0)
        same_l = torch.allclose(l, rl, rtol=1e-4, atol=1e-6)
        errs[name] = err
        log(f"kernel case {name}: max_abs_err={err:.3e} m_ok={same_m} "
            f"l_ok={same_l}")
        if not (err <= TOL_NORMALISED and same_m and same_l):
            raise AssertionError(f"kernel case {name} disagrees: err={err}")
        return o, m, l

    check("zero_bias", q, k, v, zero)
    check("causal_bias", q, k, v, causal)
    o, m, l = check("masked_row", q, k, v, masked_row)
    row_ok = (torch.isneginf(m[:, :, 7]).all() and (l[:, :, 7] == 0).all()
              and (o[:, :, 7] == 0).all())
    if not row_ok:
        raise AssertionError("fully masked row is not m=-inf, l=0, o=0")
    # scores 8x larger: one TF32 pass would miss by 1e-2 here. (q and k
    # both x8 put even the fp32 plain version 1.5e-4 off exact attention.)
    check("q_scaled_x8", 8 * q, k, v, zero)
    check("bf16_inputs", q.bfloat16(), k.bfloat16(), v.bfloat16(), zero)
    rq, rk, rv = (torch.randn((b, h, n, 72), generator=gen, device="cuda")
                  for n in (100, 70, 70))
    rows = torch.arange(100, device="cuda")[:, None]
    cols = torch.arange(70, device="cuda")[None, :]
    check("ragged_100x70_d72", rq, rk, rv,
          torch.where(rows >= cols, 0.0, float("-inf")))

    k2, v2 = (torch.randn((b, h, 2 * s, d), generator=gen, device="cuda")
              for _ in range(2))
    parts = [ba.attention_block(q, k2[:, :, i * s:(i + 1) * s].contiguous(),
                                v2[:, :, i * s:(i + 1) * s].contiguous(), zero)
             for i in range(2)]
    err = (ba.combine_blocks(parts)
           - ra.reference_attention(q, k2, v2, causal=False)).abs().max().item()
    errs["two_blocks"] = err
    log(f"kernel case two_blocks: max_abs_err={err:.3e}")
    if err > TOL_NORMALISED:
        raise AssertionError(f"two merged blocks disagree: err={err}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(torch, lambda: ba.attention_block(q, k, v, zero))
    plain_ms = cuda_ms(torch, lambda: ra.block_partials(q, k, v, zero))
    library_ms = cuda_ms(torch, lambda: sdpa(q, k, v, attn_mask=zero))
    log("scaled_dot_product_attention ran: "
        f"{kernel_names(torch, lambda: sdpa(q, k, v, attn_mask=zero))}")
    elem = q.element_size()
    bytes_moved = (4 * q.numel() * elem + zero.numel() * 4
                   + 2 * b * h * s * 4)          # q, k, v, o; bias; m, l
    flops = 4.0 * b * h * s * s * d
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TF32_FLOPS * 1e3
    log(f"kernel times: ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bytes={bytes_moved} flops={flops:.4g}")
    mma_tflops = mma_peak_tflops(torch, mma_peak_path)
    t_mma = TF32_SPLIT_TERMS * flops / (mma_tflops * 1e12) * 1e3
    log(f"kernel bound: card floor {max(t_bytes, t_ops):.4f} ms "
        f"(bytes {t_bytes:.4f}, TF32 operations {t_ops:.4f}); split-TF32 "
        f"design floor {TF32_SPLIT_TERMS * t_ops:.4f} ms; kernel/library "
        f"{ms / library_ms:.3f}")
    log(f"mma.sync tf32 alone: {mma_tflops:.1f} TFLOP/s; the three "
        f"products at that rate {t_mma:.4f} ms, the kernel at "
        f"{t_mma / ms:.3f} of it")
    return {"name": "attn_block", "route": "cuda",
            "source": "vtpu_manager_torch/csrc/attn_block.cu",
            "replaces": "vtpu_manager/workloads/pallas_attention.py:28",
            "launches": 0, "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms}


def main_path(torch) -> dict:
    from vtpu_manager_torch.bench_steps import mfu_measure, step_device_share
    from vtpu_manager_torch.workloads import attention_bench
    from vtpu_manager_torch.workloads import trainer

    cfg = trainer.model_config()
    model = trainer.init_params(cfg, seed=0, device="cuda")
    cpu_model = trainer.init_params(cfg, seed=0, device="cpu")
    batch = trainer.make_batch(cfg, batch_size=8, seed=1, device="cuda")
    cpu_batch = {n: t.cpu() for n, t in batch.items()}
    with torch.no_grad():
        logits = trainer.forward(model, batch["tokens"])
        cpu_logits = trainer.forward(cpu_model, cpu_batch["tokens"])
        loss_err = abs(float(trainer.loss_fn(model, batch))
                       - float(trainer.loss_fn(cpu_model, cpu_batch)))
    logit_err = (logits.float().cpu() - cpu_logits.float()).abs().max().item()
    log(f"trainer: logits {tuple(logits.shape)} {logits.dtype}, card vs cpu "
        f"max_abs_err={logit_err:.3e} loss_err={loss_err:.3e}")
    # bf16 keeps 8 bits: 4 ulps at |logit| < 8 is 0.125; the loss as
    # tests/test_workloads.py:70 holds it
    if not torch.isfinite(logits).all() or logit_err > 0.125 or \
            loss_err > 5e-2:
        raise AssertionError(f"trainer disagrees with the CPU: logits "
                             f"{logit_err}, loss {loss_err}")
    losses = []
    for _ in range(3):
        model, loss = trainer.sgd_train_step(model, batch)
        losses.append(float(loss))
    log(f"trainer: sgd losses {losses}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")

    probe = attention_bench.measure()
    log(f"attention probe: {json.dumps(probe)}")
    mfu = mfu_measure(n=8192, inner=100, reads=3)
    log(f"mfu (unthrottled, no interposer): {json.dumps(mfu)}")
    step = step_device_share(dim=8192, warmup=10, steps=30)
    log(f"quota step (unthrottled, no interposer): {json.dumps(step)}")
    return {"trainer_losses": losses, "trainer_logit_err": logit_err,
            "trainer_loss_err": loss_err,
            "probe": probe, "mfu": mfu, "quota_step": step}


def enforcement(shim: str) -> dict:
    import tempfile

    from vtpu_manager_torch import bench_quota as bq

    # every tenant of the phase from a process started ahead, its imports
    # done before the first one runs (each still times its steps alone)
    with tempfile.TemporaryDirectory(prefix="vtpu-enforcement-") as logs:
        pools = {shim: bq.TenantPool(logs, shim, ENFORCEMENT_TENANTS),
                 "": bq.TenantPool(logs, "", ENFORCEMENT_BARE_TENANTS)}
        try:
            for pool in pools.values():
                pool.wait_loaded()
            return _enforcement(bq, shim, pools)
        finally:
            for pool in pools.values():
                pool.close()


# the enforcement phase's tenants: the cap check, the sweep's six, two
# overhead pairs (two of them without the interposer), the four graph
# tenants and the entry check
ENFORCEMENT_TENANTS = 14
ENFORCEMENT_BARE_TENANTS = 2


def _enforcement(bq, shim: str, pools: dict) -> dict:
    hbm = bq.run_hbm_check(shim, pools=pools)
    log(f"cap check: {json.dumps(hbm)}")
    if hbm.get("error") != 0:
        raise AssertionError(f"64 MiB cap not enforced exactly: {hbm}")

    def run(quota, preload=True):
        out = bq.run_worker(shim if preload else None, quota, pools=pools)
        if out is None:                 # stop at the first broken tenant
            raise AssertionError(f"tenant at quota {quota} failed")
        return out

    times, shares, records = bq.paired_quota_sweep(run)
    mae = bq.tracking_mae(shares)
    for quota in bq.QUOTAS:
        log(f"quota={quota}% ms/step={times.get(quota)} "
            f"share={shares.get(quota)}")
    log(f"quota tracking MAE={mae}")
    # the interposer's cost to an unthrottled tenant: off/on pairs
    pairs = [(run(100, preload=False), run(100)) for _ in range(2)]
    off = min(p[0]["ms_per_step"] for p in pairs)
    on = min(p[1]["ms_per_step"] for p in pairs)
    overhead_pct = 100.0 * (on / off - 1.0)
    log(f"interposer overhead at quota 100: off={off} on={on} ms/step "
        f"({overhead_pct:+.2f}%)")
    log(f"no-interposer records: {json.dumps([p[0] for p in pairs])}")
    records += [p[1] for p in pairs]
    for r in records:
        log(f"tenant record: {json.dumps(r)}")
    bad = [q for q in bq.QUOTAS
           if q not in shares or abs(shares[q] - q) > SHARE_BAND]
    if bad:
        raise AssertionError(f"shares outside +-{SHARE_BAND}: {shares}")
    if not all(r["vtpu_launches_total"] > 0 for r in records):
        raise AssertionError("a tenant's launches bypassed the interposer")
    if any(r["vtpu_fail_open_total"] for r in records):
        raise AssertionError("the rate limiter failed open in a tenant")
    kernel_runs = [r for r in records if "kernel_launches_delta" in r]
    if not kernel_runs or not all(
            r["kernel_shim_launches_delta"] >= 1
            and r["kernel_launches_delta"] == 1 for r in kernel_runs):
        raise AssertionError(f"the interposer did not see the kernel: "
                             f"{kernel_runs}")
    # every launch path: CUDA-graph replays and a cooperative launch
    graph = bq.graph_sweep(shim, pools=pools)
    verdicts = bq.graph_sweep_ok(graph, SHARE_BAND)
    for r in graph["records"]:
        log(f"graph tenant record: {json.dumps(r)}")
    log(f"graph sweep: ms/step={graph['ms_per_step']} "
        f"shares={graph['shares']} verdicts={verdicts}")
    # every allocation entry under the cap
    entries = bq.run_entry_check(shim, pools=pools)
    entries_ok = bq.entry_check_ok(entries)
    log(f"allocation entries under the 64 MiB cap: ok={entries_ok} "
        f"{json.dumps(entries)}")
    if not verdicts["ok"]:
        raise AssertionError(f"graph or cooperative launches escape the "
                             f"meter: {verdicts}")
    if not entries_ok:
        raise AssertionError(f"an allocation entry escapes the cap: "
                             f"{entries}")
    return {"hbm": hbm, "ms_per_step": times, "shares": shares,
            "mae": mae, "overhead_pct": overhead_pct,
            "kernel_under_interposer": kernel_runs[0],
            "graph": {"ms_per_step": graph["ms_per_step"],
                      "shares": graph["shares"], "verdicts": verdicts},
            "entries": entries["entries"]}


def co_tenancy(torch, shim: str) -> dict:
    import tempfile

    from vtpu_manager_torch import bench_cotenancy as bc

    results = {}

    def check(name, fn):
        t0 = time.perf_counter()
        try:
            rec = fn()
        except Exception:          # every check runs; any failure fails all
            rec = {"ok": False, "error": traceback.format_exc()}
        log("COTENANCY " + json.dumps(
            {"check": name, "seconds": time.perf_counter() - t0, **rec},
            default=str))
        results[name] = {"ok": rec["ok"]}
        return rec

    rec, chip = bc.check_discovery(torch)
    check("discovery", lambda: rec)
    if chip is None:
        raise AssertionError("NVML does not see torch's card")
    with tempfile.TemporaryDirectory(prefix="vtpu-node-") as root:
        phase = bc.Phase(shim, root, chip)
        try:
            check("config_file", phase.check_config_file)
            check("memory", phase.check_memory)
            feed = {}

            def compute_50_25():
                compute, seen = phase.check_50_25_with_feed()
                feed.update(seen)
                return compute

            check("compute_50_25", compute_50_25)
            check("compute_50_50", phase.check_50_50)
            check("compute_60_25_10", phase.check_60_25_10)
            check("feed", lambda: feed or {"ok": False,
                                           "error": "no 50 + 25 run"})
            check("balance", phase.check_balance)
            check("long_runs", phase.check_long_runs)
        finally:
            phase.close()
    failed = [name for name, r in results.items() if not r["ok"]]
    if failed:
        raise AssertionError(f"co-tenancy checks failed: {failed}")
    return results


def run_checks(tag: str, phase_cls, torch, shim: str,
               names: tuple[str, ...]) -> dict:
    """Runs phase_cls(...).check_<name>() for each name on a private node
    directory, one `<TAG> {json}` line each; every check runs, and any
    failure fails the phase."""
    import tempfile

    results = {}
    with tempfile.TemporaryDirectory(prefix="vtpu-node-") as root:
        phase = phase_cls(torch, shim, root)
        try:
            for name in names:
                t0 = time.perf_counter()
                try:
                    rec = getattr(phase, f"check_{name}")()
                except Exception:  # every check runs; any failure fails all
                    rec = {"ok": False, "error": traceback.format_exc()}
                log(f"{tag.upper()} " + json.dumps(
                    {"check": name, "seconds": time.perf_counter() - t0,
                     **rec}, default=str))
                results[name] = rec
        finally:
            phase.close()
    failed = [name for name, r in results.items() if not r["ok"]]
    if failed:
        raise AssertionError(f"{tag} checks failed: {failed}")
    return results


def allocate(torch, shim: str) -> dict:
    from vtpu_manager_torch import bench_allocate as ba

    results = run_checks("allocate", ba.Phase, torch, shim,
                         ("registry", "allocate", "tenants", "step_ring"))
    tenants, rings = results["tenants"], results["step_ring"]
    return {"shares": {p: tenants[p]["share"] for p in ("pod-a", "pod-b")},
            "ms_per_step": {p: tenants[p]["ms_per_step"] for p in ba.PODS},
            "ring_hook_ms": tenants["ring_hook_ms"],
            "ring_median_rel": {p: rings[p]["median_rel"]
                                for p in ("pod-a", "pod-b", "pod-d")},
            "throttle_wait_ns": {p: rings[p]["throttle_wait_ns"]
                                 for p in ("pod-a", "pod-b", "pod-d")}}


def dra(torch, shim: str) -> dict:
    from vtpu_manager_torch import bench_dra as bd

    results = run_checks("dra", bd.Phase, torch, shim,
                         ("slice", "prepare", "tenants", "siblings",
                          "multi_request", "restart"))
    tenants, sibs = results["tenants"], results["siblings"]
    return {"shares": {n: tenants[n]["share"] for n in ("claim-a", "claim-b")},
            "ms_per_step": {n: tenants[n]["ms_per_step"]
                            for n in ("solo", "claim-a", "claim-b")},
            "siblings": {t: sibs[t]["verdicts"] for t in (
                "first", "second", "control_first", "control_second")}}


def cluster(torch, shim: str) -> dict:
    from vtpu_manager_torch import bench_cluster as bcl

    results = run_checks("cluster", bcl.Phase, torch, shim,
                         ("slice", "prepare", "nri", "tenants", "allocate"))
    tenants = results["tenants"]
    return {"shares": {n: tenants[n]["share"] for n in bcl.CLAIMS},
            "ms_per_step": {n: tenants[n]["ms_per_step"]
                            for n in ("solo", *bcl.CLAIMS)},
            "slice_calls": results["slice"]["calls"],
            "nri": {k: results["nri"][k] for k in ("spoofed", "plain")}}


def monitor(torch, shim: str) -> dict:
    from vtpu_manager_torch import bench_monitor as bm

    results = run_checks("monitor", functools.partial(bm.Phase, f4=False),
                         torch, shim, ("setup", "running", "utilization",
                                       "after", "publish"))
    running, after = results["running"], results["after"]
    util = results["utilization"]
    return {"mean_share": {p: running["pods"][p]["mean_share"]
                           for p in bm.PODS},
            "taken_share": {p: running["pods"][p]["taken_share"]
                            for p in bm.PODS},
            "taken_at_duty": {p: running["pods"][p]["taken_at_duty"]
                              for p in bm.PODS},
            "charge_rel_err": {p: running["pods"][p]["charge_rel_err"]
                               for p in bm.PODS},
            # the idle pod's charge over its step at duty (reported: C1)
            "idle_charge_rel": running["idle_charge"]["charge_rel"],
            # the same charge against the step back to back, first and again
            "charge_rel_b2b": {p: [running["pods"][p]["charge_rel_b2b"],
                                   running["pods"][p]["charge_rel_again"]]
                               for p in bm.PODS},
            "memory_used": {p: running["pods"][p]["memory_used"]
                            for p in bm.PODS},
            "steps": {p: after["pods"][p]["count"] for p in bm.PODS},
            "wait_fraction": {p: after["pods"][p]["wait_fraction"]
                              for p in bm.PODS},
            "pressure": [after["pressure_frac"], after["pressure_headroom"]],
            # each pod's used core % from the feed and from the rings
            # alone, beside the share its steps took
            "utilization": {p: {k: util["pods"][p][k] for k in (
                "taken_share", "taken_at_duty", "used_feed", "used_rings",
                "source_feed", "reclaimable_core_pct")} for p in bm.ALL_PODS},
            "scrape_s": results["publish"]["scrape_s"]}


def compile_cache(torch, shim: str) -> dict:
    from vtpu_manager_torch import bench_compilecache as bcc

    results = run_checks("compile_cache", bcc.Phase, torch, shim, bcc.CHECKS)
    rows = [r for s in (*bcc.SCENARIOS, bcc.PEER) for r in results[s]["rows"]]
    launches = sum(r["step_launches"] for r in rows)
    if launches == 0:
        raise AssertionError("the compiled step never launched attn_block")
    peer = results[bcc.PEER]
    log("COMPILE_CACHE report " + json.dumps(
        {"ttfs_mean_s": peer["ttfs_vs"], "store_s": peer["store_s"],
         "entry_bytes": peer["entry_bytes"], "outcomes": peer["outcomes"],
         "peer_fetches": peer["exporter"]["peer_fetches_total"]}))
    return {"scenarios": {s: {k: results[s][k] for k in (
                "compiles", "outcomes", "ttfs_mean_s", "ttfs_max_s")}
                          for s in (*bcc.SCENARIOS, bcc.PEER)},
            "attn_block_launches": launches,
            "max_abs_err": max(results["shared"]["max_abs_err"].values()),
            "counters": results["shared"]["counters"]}


def tracing(torch, shim: str, card: str) -> dict:
    from vtpu_manager_torch import bench_trace as bt

    results = run_checks("tracing", bt.Phase, torch, shim, bt.CHECKS)
    tenants, exporter = results["tenants"], results["exporter"]
    timed = results["allocate_time"]
    launches = sum(tenants[k]["step_launches"] for k in ("s", "u"))
    if launches == 0:
        raise AssertionError("the traced tenants never launched attn_block")
    report = {"card": card,
              "allocate_to_first_step_s": exporter["to_first_step_s"],
              "allocate_ms": {"off": timed["median_off_ms"],
                              "on": timed["median_on_ms"]},
              "stage_ms": exporter["stage_ms"]}
    log("TRACING report " + json.dumps(report))
    return {**report, "attn_block_launches": launches,
            "ttfs_s": {k: tenants[k]["ttfs_s"] for k in ("s", "u")}}


def resilience(torch, shim: str) -> dict:
    from vtpu_manager_torch import bench_resilience as br

    results = run_checks("resilience", br.Phase, torch, shim, br.CHECKS)
    client = results["client_mode"]
    launches = sum(r["attn_block_launches"] for r in client["steps"].values())
    if launches == 0:
        raise AssertionError("the CLIENT-mode tenant never launched "
                             "attn_block")
    return {"fires": results["metrics"]["scraped"],
            "torn_bytes": {"config": results["torn_config"]["torn_bytes"],
                           "cdi": results["torn_cdi"]["torn_bytes"]},
            "pids": client["pids"], "attn_block_launches": launches,
            "ms_per_step": {k: r["ms_per_step"]
                            for k, r in client["steps"].items()}}


def quota_lease(torch, shim: str) -> dict:
    from vtpu_manager_torch import bench_quota_lease as bl

    results = run_checks("quota_lease", bl.Phase, torch, shim, bl.CHECKS)
    lease, freeze, tools, market = (results[c] for c in bl.CHECKS)
    log("QUOTA_LEASE market report " + json.dumps(
        {"card_stages": [(s["effective"], s["share"]) for s in
                         market["stages"]], **market["report"],
         "surge_to_revoke_s": market["surge_to_revoke_s"],
         "adoption_ms": market["adoption_ms"], "grants": market["grants"],
         "ledger": market["ledger"]}))
    return {"shares": {s["effective"]: s["share"] for s in lease["stages"]},
            "wait_shares": {s["effective"]: s.get("wait_share")
                            for s in lease["stages"]},
            "reloads": [lease["reloads"], lease["rewrites"]],
            "freeze_s": [freeze["freeze_wait_s"], freeze["held_s"]],
            "busy_share": tools["busy"]["effective_pct"],
            "offload": {k: tools["offload"][k] for k in (
                "interposer_peak_bytes", "cap_bytes", "model_bytes",
                "max_abs_err")},
            "market_shares": [(s["effective"], s["share"])
                              for s in market["stages"]],
            "market_revoke_passes": market["revoke_passes"],
            "attn_block_launches": (lease["attn_block_launches"]
                                    + market["attn_block_launches"])}


def observation(torch, shim: str) -> dict:
    from vtpu_manager_torch import bench_observation as bo

    results = run_checks("observation", bo.Phase, torch, shim, bo.CHECKS)
    cal, unmod, late = (results[c] for c in bo.CHECKS)
    return {"table": cal["table"], "calibration_s": cal["calibration_s"],
            "tenants_ready_s": cal["tenants_ready_s"],
            "node_ready_s": cal["node_ready_s"],
            "records": {"unmodified": unmod["records"],
                        "late": [late["shim_records"],
                                 late["python_records"]]},
            "median_ms": [unmod["median_record_ms"], unmod["median_wall_ms"]],
            "wait_ns": [unmod["wait_sum_ns"], unmod["wait_counter_ns"]],
            "share": unmod["share"],
            "attn_block_launches": unmod["attn_block_launches"]
            + late["attn_block_launches"]}


# what a gloo rank's ring call may move between host and card beyond what
# it staged for gloo: the error's scalar readbacks, a few bytes each
COMM_SLACK_BYTES = 4096


def overcommit(torch, shim: str) -> dict:
    from vtpu_manager_torch import bench_overcommit as bo

    results = run_checks("overcommit", bo.Phase, torch, shim, bo.CHECKS)
    ratio, ovf = (results[c] for c in bo.CHECKS)
    return {"ratio": ratio["ratio"], "overflow": ovf["overflow"],
            "budget": ovf["budget"], "spilled": ovf["ledger_held"],
            "card_free_drop": ovf["card_free_drop"],
            "gib_ms": {"card": ovf["spill"]["card_gib_ms"],
                       "overflow": ovf["spill"]["overflow_gib_ms"]},
            "attn_err": ovf["spill"]["attn_err"],
            "attn_block_launches": ovf["attn_block_launches"]}


def _comm_totals():
    """The interposer's three comm totals (time ns, bytes, collectives) of
    this process, or None without an armed interposer."""
    from vtpu_manager_torch.bench_quota import shim_counters
    from vtpu_manager_torch.util import consts

    c = shim_counters()
    if os.environ.get(consts.ENV_COMM_TELEMETRY) != "true" or \
            "vtpu_collectives_total" not in c:
        return None
    return (c["vtpu_comm_time_ns_total"], c["vtpu_comm_bytes_total"],
            c["vtpu_collectives_total"])


def staged_bytes(shape, n: int) -> int:
    """What one rank of `check_ring` over gloo stages through the host
    (`collectives.shift`): n - 1 hops of its K/V shard stack, each copied
    to the host and back onto the card, fp32."""
    b, h, s, d = shape
    return (n - 1) * 2 * (2 * b * h * (s // n) * d * 4)


def _comm_entries() -> str:
    """The copy entries the interposer of this process saw while armed."""
    try:
        fn = ctypes.CDLL(None).vtpu_comm_entries
    except AttributeError:
        return ""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int]
    buf = ctypes.create_string_buffer(1024)
    fn(buf, 1024)
    return buf.value.decode()


def nccl_comm_rank(rank, cfg: dict | None = None) -> dict:
    """World 1 over NCCL under the armed interposer (a `workloads/ranks.py`
    job): the dry run's rank under torch.profiler, and the collectives the
    interposer counted beside the NCCL kernels the profiler lists for the
    same calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vtpu_manager_torch import graft_entry as ge

    before = _comm_totals()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = ge.dryrun_rank(rank, cfg=cfg)
        torch.cuda.synchronize()
    after = _comm_totals()
    nccl = {e.key: e.count for e in prof.key_averages()
            if e.device_type.name == "CUDA" and "nccl" in e.key.lower()}
    return {**out, "comm": {
        "collectives": None if before is None else after[2] - before[2],
        "time_ns": None if before is None else after[0] - before[0],
        "bytes": None if before is None else after[1] - before[1],
        "nccl_kernels": sum(nccl.values()), "nccl_names": sorted(nccl),
        "entries": _comm_entries()}}


def shared_card_rank(rank, shape=(8, 16, 1024, 128), tol: float = 1e-4
                     ) -> dict:
    """One of several ranks sharing the card over gloo (a
    `workloads/ranks.py` job, which the rank processes import from the
    repo's root): the causal ring with the block-attention kernel as its
    block function on full q, k, v of `shape` (the attention probe's shard
    per rank at two ranks), held within `tol` of the plain ring and of
    `reference_attention` (the kernel's tolerance, absolute); the kernel's
    launches as its wrapper counts them and, under the interposer, as the
    interposer counts each one; then the pipeline and MoE checks over
    every rank, and the sharded step at (data n, model 1) and (data 1,
    model n) against one process."""
    import torch
    import torch.distributed as dist

    from vtpu_manager_torch import graft_entry as ge
    from vtpu_manager_torch.bench_quota import shim_counters
    from vtpu_manager_torch.telemetry.stepring import StepRingReader
    from vtpu_manager_torch.util.torchplatform import exact_fp32
    from vtpu_manager_torch.workloads import block_attention as ba, trainer

    exact_fp32()
    dev, n = rank.device, rank.world
    # each rank process writes a ring of its own (the interposer arms its
    # writer at the first launch, after this)
    ring_path = os.environ.get("VTPU_STEP_RING_PATH", "").format(
        rank=rank.rank)
    if ring_path:
        os.environ["VTPU_STEP_RING_PATH"] = ring_path
    world = dist.group.WORLD
    kernel = ba.make_block_fn()
    shim_deltas = []

    def counted(*args):
        before = shim_counters().get("vtpu_launches_total")
        out = kernel(*args)
        if before is not None:
            shim_deltas.append(shim_counters()["vtpu_launches_total"]
                               - before)
        return out

    def close_step() -> int:
        """A launch and a synchronisation: the interposer closes the step
        and its ring record takes what the comm window held. The ring's
        head after."""
        if dev.type == "cuda":
            torch.zeros(1, device=dev).add_(1)
            torch.cuda.synchronize(dev)
        if not os.path.exists(ring_path):
            return 0
        reader = StepRingReader(ring_path)
        try:
            return reader.poll(0)[1]
        finally:
            reader.close()

    shape = tuple(shape)
    ba.reset_launches()
    head0 = close_step()
    comm0 = _comm_totals()
    t0 = time.perf_counter()
    ref_err, out = ge.check_ring(world, shape, dev, tol, 0.0,
                                 block_fn=counted)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ring_s = time.perf_counter() - t0
    head1 = close_step()
    comm1 = _comm_totals()
    comm = {"staged": staged_bytes(shape, n), "ring_s": ring_s,
            "entries": _comm_entries()}
    if comm0 is not None:
        comm.update(time_ns=comm1[0] - comm0[0], bytes=comm1[1] - comm0[1],
                    collectives=comm1[2] - comm0[2])
    if os.path.exists(ring_path):
        reader = StepRingReader(ring_path)
        try:
            records = reader.poll(head0)[0]
        finally:
            reader.close()
        comm.update(ring_records=head1 - head0, ring_sum=[
            sum(r.comm_time_ns for r in records),
            sum(r.bytes_transferred for r in records),
            sum(r.collective_count for r in records)])
    launches = ba.LAUNCHES["attn_block"]
    plain_err, plain = ge.check_ring(world, shape, dev, tol, 0.0)
    plain_diff = float((out - plain).abs().max())
    if plain_diff > tol:
        raise AssertionError(f"kernel ring off the plain ring: {plain_diff}")
    steps = {}
    for data, model in ((n, 1), (1, n)):
        mesh = trainer.make_mesh(dev.type, data=data, model=model)
        steps[f"{data}x{model}"] = ge.check_step(
            mesh, trainer.model_config(), dev)
    return {"ring_err_ref": ref_err * tol, "ring_plain_err_ref":
            plain_err * tol, "ring_diff_plain": plain_diff,
            "ring_s": ring_s, "attn_block_launches": launches,
            "shim_launch_deltas": shim_deltas,
            "pipeline_err": ge.check_pipeline(world, dev),
            "moe_err": ge.check_moe(world, dev), "steps": steps,
            "comm": comm, "device": str(dev)}


def comm_env(world, shim: str, pod: str, base: str, **config) -> dict:
    """A rank's environment as the device plugin's Allocate writes it for
    a pod with StepTelemetry and CommTelemetry: the step ring (under
    `base`, per container, `{rank}` filled in by the rank) and
    `VTPU_COMM_TELEMETRY=true`."""
    from vtpu_manager_torch.util import consts

    env = world.env(shim, pod, **config)
    env.update({consts.ENV_STEP_TELEMETRY: "true",
                consts.ENV_STEP_RING_PATH: os.path.join(
                    base, pod + "_rank{rank}", consts.TELEMETRY_SUBDIR,
                    consts.STEP_RING_NAME),
                consts.ENV_COMM_TELEMETRY: "true"})
    return env


def comm_exported(base: str, pod: str, ranks: int) -> dict:
    """The port's collector over the ranks' rings with CommTelemetry on and
    off: per rank, the comm families it renders."""
    from vtpu_manager_torch.metrics.collector import NodeCollector
    from vtpu_manager_torch.tpu.discovery import FakeBackend

    out = {}
    for gate in (True, False):
        text = NodeCollector(
            "n1", FakeBackend(1).discover().chips, base_dir=base,
            tc_path=os.path.join(base, "no-tc"),
            vmem_path=os.path.join(base, "no-vmem"),
            pod_resources_socket=os.path.join(base, "no.sock"),
            kubelet_checkpoint=os.path.join(base, "no.ckpt"),
            comm_enabled=gate).render()
        out["on" if gate else "off"] = {
            f"rank{r}": sorted({line.split("{", 1)[0] for line in
                                text.splitlines()
                                if line.startswith("vtpu_tenant_comm")
                                and f'container="rank{r}"' in line})
            for r in range(ranks)}
        out["off_any"] = "vtpu_tenant_comm" in text
    return out


def check_comm(two: list[dict], world1: dict, exported: dict) -> list[str]:
    """What the comm accounting must show (phase 14); the failures."""
    bad = []
    for i, r in enumerate(two):
        c = r["comm"]
        staged = c["staged"]
        if c.get("bytes") is None:
            bad.append(f"rank {i}: no armed interposer")
            continue
        if not staged <= c["bytes"] <= staged + COMM_SLACK_BYTES:
            bad.append(f"rank {i}: {c['bytes']} bytes counted against "
                       f"{staged} staged (slack {COMM_SLACK_BYTES})")
        if not 0 < c["time_ns"] <= c["ring_s"] * 1e9:
            bad.append(f"rank {i}: comm time {c['time_ns']} ns against the "
                       f"call's {c['ring_s']} s")
        if c["collectives"] != 0:
            bad.append(f"rank {i}: {c['collectives']} collectives over gloo")
        if c.get("ring_sum") != [c["time_ns"], c["bytes"], c["collectives"]]:
            bad.append(f"rank {i}: the ring's comm block {c.get('ring_sum')}"
                       f" is not the interposer's delta")
        if exported["on"][f"rank{i}"] != [
                "vtpu_tenant_comm_bytes_bucket",
                "vtpu_tenant_comm_bytes_count", "vtpu_tenant_comm_bytes_sum",
                "vtpu_tenant_comm_time_fraction",
                "vtpu_tenant_comm_time_seconds_bucket",
                "vtpu_tenant_comm_time_seconds_count",
                "vtpu_tenant_comm_time_seconds_sum"]:
            bad.append(f"rank {i}: the exporter rendered "
                       f"{exported['on'][f'rank{i}']}")
    if exported["off_any"]:
        bad.append("the exporter rendered comm series with the gate off")
    c = world1["comm"]
    if c["collectives"] is None or c["collectives"] != c["nccl_kernels"]:
        bad.append(f"world 1: {c['collectives']} collectives counted "
                   f"against {c['nccl_kernels']} NCCL kernels")
    return bad


def ring_sums(path: str) -> dict:
    """The records of a step ring and the sums of their comm blocks."""
    from vtpu_manager_torch.telemetry.stepring import StepRingReader

    reader = StepRingReader(path)
    try:
        records = reader.poll(0)[0]
    finally:
        reader.close()
    return {"records": len(records),
            "time_ns": sum(r.comm_time_ns for r in records),
            "bytes": sum(r.bytes_transferred for r in records),
            "collectives": sum(r.collective_count for r in records)}


def distributed(torch, shim: str, smi: str = "") -> dict:
    """World 1 over NCCL: `dryrun_multichip(1)` at the trainer's default
    config, its rank under the interposer, and beside it the same rank
    under torch.profiler (`nccl_comm_rank`). World 2 over gloo on
    this one card (NCCL refuses two ranks on one device): two rank
    processes under the interposer as one pod's two containers (its
    identity, q100, one 16 GiB cap), started before world 1 runs and held
    at a go file until it is done. Every rank with CommTelemetry armed."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from vtpu_manager_torch import bench_quota as bq, graft_entry
    from vtpu_manager_torch.util import consts
    from vtpu_manager_torch.workloads import ranks, trainer

    props = torch.cuda.get_device_properties(0)
    with tempfile.TemporaryDirectory(prefix="vtpu-node-") as root:
        world = bq.World(root)
        base = os.path.join(root, "mgr")
        for r in range(2):
            os.makedirs(os.path.join(base, f"pod-dist_rank{r}", "telemetry"))
        for pod in ("pod-nccl", "pod-entry"):
            os.makedirs(os.path.join(base, f"{pod}_rank0", "telemetry"))
        entry_env = comm_env(world, shim, "pod-entry", base,
                             real_memory=int(props.total_memory))
        entry_ring = entry_env[consts.ENV_STEP_RING_PATH].format(rank=0)
        entry_env[consts.ENV_STEP_RING_PATH] = entry_ring
        env = comm_env(world, shim, "pod-dist", base, cap=16 << 30,
                       real_memory=int(props.total_memory))
        go = world.go_file("distributed")
        t0 = time.perf_counter()
        with ranks.Ranks("chip_smoke:shared_card_rank",
                         2, device="cuda", backend="gloo", env=env,
                         go_file=go) as pair:
            # the entry point and the profiled rank side by side: each
            # its own process and NCCL group on the card
            with ThreadPoolExecutor(1) as pool:
                entry = pool.submit(
                    graft_entry.dryrun_multichip, 1,
                    cfg=trainer.model_config(), timeout=300,
                    env=entry_env)
                one = ranks.launch(
                    "chip_smoke:nccl_comm_rank", 1, device="cuda",
                    args={"cfg": trainer.model_config()},
                    env=comm_env(world, shim, "pod-nccl", base,
                                 real_memory=int(props.total_memory)),
                    timeout=300)
                entry = entry.result()
            entry_comm = ring_sums(entry_ring)
            t1 = time.perf_counter()
            Path(go).touch()
            two = pair.results(timeout=300)
        t2 = time.perf_counter()
        exported = comm_exported(base, "pod-dist", 2)
    for rank, r in enumerate(two):
        log(f"DISTRIBUTED rank {rank} " + json.dumps(r))
    bad = [i for i, r in enumerate(two)
           if r["attn_block_launches"] != 2
           or r["shim_launch_deltas"] != [1, 1]]
    if bad:
        raise AssertionError(f"ranks {bad}: the kernel ring did not launch "
                             f"attn_block twice, each seen by the "
                             f"interposer: {two}")
    for rank, r in enumerate(two):
        log("DISTRIBUTED comm " + json.dumps(
            {"world": 2, "rank": rank, "card": smi, **r["comm"],
             "slack_bytes": COMM_SLACK_BYTES,
             "exported": exported["on"][f"rank{rank}"]}))
    log("DISTRIBUTED comm " + json.dumps(
        {"world": 1, "rank": 0, "card": smi, **one[0]["comm"],
         "entry_ring": entry_comm}))
    failed = check_comm(two, one[0], exported)
    if entry_comm["records"] == 0:
        failed.append("world 1: dryrun_multichip's armed rank wrote no ring"
                      " record")
    if failed:
        raise AssertionError("comm accounting: " + "; ".join(failed))
    report = {"world1": entry[0], "world1_s": t1 - t0,
              "world2_s": t2 - t1,
              "ring_diff_plain": max(r["ring_diff_plain"] for r in two),
              "ring_err_ref": max(r["ring_err_ref"] for r in two),
              "ring_s": [r["ring_s"] for r in two],
              "steps": [r["steps"] for r in two],
              "attn_block_launches": sum(r["attn_block_launches"]
                                         for r in two)}
    log("DISTRIBUTED report " + json.dumps(report))
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from vtpu_manager_torch import build
        from vtpu_manager_torch.workloads import block_attention as ba
    except ImportError as e:
        print(f"chip_smoke: run from the repo root ({e})", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind!r}"
        f" count {torch.cuda.device_count()}")

    failures = []
    summary: dict = {"card": smi}
    record = None

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:          # every phase runs; any failure fails all
            failures.append(name)
            log(f"PHASE {name} FAILED\n{traceback.format_exc()}")
            # the reason on stderr too, where a reader of the exit sees it
            print(f"chip_smoke: phase {name}: "
                  f"{traceback.format_exc(limit=0).strip()[-2000:]}",
                  file=sys.stderr)
            return None
        log(f"PHASE {name} ok in {time.perf_counter() - t0:.1f}s")
        return out

    paths = phase("build", build.build_for_card)
    if paths is None:
        return 1
    log(f"build: {paths['seconds']:.1f}s kernel={paths['attn_block']} "
        f"shim={paths['shim']}")
    with open(f"{paths['attn_block']}.log") as f:
        ptxas = [ln.strip() for ln in f if "ptxas" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"ptxas: {ln}")
    record = phase("kernel", kernel_phase, torch, paths["mma_peak"])
    ba.reset_launches()
    summary["main"] = phase("main_path", main_path, torch)
    if record is not None:
        record["launches"] = ba.LAUNCHES["attn_block"]
        if record["launches"] == 0:
            failures.append("launches")
            log("the main path never launched attn_block")
    summary["enforcement"] = phase("enforcement", enforcement,
                                   str(paths["shim"]))
    summary["co_tenancy"] = phase("co_tenancy", co_tenancy, torch,
                                  str(paths["shim"]))
    summary["allocate"] = phase("allocate", allocate, torch,
                                str(paths["shim"]))
    summary["dra"] = phase("dra", dra, torch, str(paths["shim"]))
    summary["cluster"] = phase("cluster", cluster, torch, str(paths["shim"]))
    summary["monitor"] = phase("monitor", monitor, torch, str(paths["shim"]))
    summary["compile_cache"] = phase("compile_cache", compile_cache, torch,
                                     str(paths["shim"]))
    summary["tracing"] = phase("tracing", tracing, torch, str(paths["shim"]),
                               smi)
    summary["resilience"] = phase("resilience", resilience, torch,
                                  str(paths["shim"]))
    summary["quota_lease"] = phase("quota_lease", quota_lease, torch,
                                   str(paths["shim"]))
    summary["observation"] = phase("observation", observation, torch,
                                   str(paths["shim"]))
    summary["distributed"] = phase("distributed", distributed, torch,
                                   str(paths["shim"]), smi)
    summary["overcommit"] = phase("overcommit", overcommit, torch,
                                  str(paths["shim"]))
    if record is not None:
        # the lease tenant, the observation phase's tenants, the
        # distributed phase's ranks and the spill pod launch the kernel on
        # their paths
        for name in ("quota_lease", "observation", "distributed",
                     "overcommit"):
            if summary[name] is not None:
                record["launches"] += summary[name]["attn_block_launches"]
    log("SUMMARY " + json.dumps(summary, default=str))
    if failures or record is None:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
