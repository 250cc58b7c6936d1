"""The tenant step loops the quota and MFU measurements time.

Ports `bench.py:342 quota_step_measure` and `bench.py:406 mfu_measure`:
the same loops, each step or block ending in one scalar readback, which
waits for the card. The quota loop writes one record per step into the
step ring when the device plugin armed it (`bench.py:362-381`); with the
gate off that costs one `is not None` per step. MFU divides by the card's own peak, looked up by the
name the card reports; an unknown card gets no MFU rather than another
card's peak.
"""

from __future__ import annotations

import sys
import time

import torch

from vtpu_manager_torch.runtime.client import step_telemetry
from vtpu_manager_torch.util.torchplatform import device_name, resolve_device

# Dense bf16 tensor-core peaks, FLOP/s (NVIDIA data sheets; SXM parts at
# their 700 W limit). Keyed by a substring of torch.cuda.get_device_name().
BF16_PEAK_FLOPS = {
    "H100 80GB HBM3": 989e12,      # H100 SXM
    "H100 SXM": 989e12,
    "H200": 989e12,
    "H100 PCIe": 756e12,
}


def bf16_peak_flops(name: str) -> float | None:
    for key, peak in BF16_PEAK_FLOPS.items():
        if key in name:
            return peak
    return None


def _quota_step(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    y = torch.tanh(x @ x) * 1e-3
    y = y / (1.0 + y.abs().max())
    return y, y[0, 0].float()


def _quota_input(dim: int, dev: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randn((dim, dim), generator=gen, device=dev,
                       dtype=torch.bfloat16)


def quota_step_measure(dim: int, warmup: int, steps: int,
                       device: str | torch.device | None = None,
                       before_timed=None) -> float:
    """The quota worker's sync loop: a compact bf16 matmul-dominated step
    with a scalar "loss" readback per step. Returns ms/step over the timed
    section, which `before_timed()` (when given) is called just before.
    Quota tracking is a duty-cycle property, not a model one."""
    dev = resolve_device(device)
    x = _quota_input(dim, dev)
    # one record per step, warm-up included, the first one `compiled`
    tel = step_telemetry()
    for i in range(warmup):
        s0 = time.monotonic_ns() if tel is not None else 0
        x, loss = _quota_step(x)
        _ = float(loss)
        if tel is not None:
            tel.record(time.monotonic_ns() - s0, compiled=(i == 0))
    if before_timed is not None:
        before_timed()
    t0 = time.perf_counter()
    for _ in range(steps):
        s0 = time.monotonic_ns() if tel is not None else 0
        x, loss = _quota_step(x)
        _ = float(loss)
        if tel is not None:
            tel.record(time.monotonic_ns() - s0)
    return 1000 * (time.perf_counter() - t0) / steps


ATTN_SHAPE = (8, 16, 512, 128)   # the attention probe's shape


def graph_step_measure(dim: int, warmup: int, steps: int, graph: bool,
                       capture_mode: str = "global", before_timed=None,
                       around_capture=None) -> float:
    """The quota step and one block-attention kernel launch, each step
    ending in the scalar readback. With `graph` the step is captured once
    in a torch.cuda.CUDAGraph (after an eager warm-up on a side stream, as
    capture needs; `capture_mode` is torch's capture_error_mode) and every
    step is one replay; without, it runs eagerly.
    `around_capture(when)` is called with "before" and "after" inside the
    capture, around the captured step (it must make no CUDA call). Returns
    ms/step over the timed section, which `before_timed()` is called just
    before."""
    from vtpu_manager_torch.workloads import block_attention as ba
    dev = torch.device("cuda")
    x = _quota_input(dim, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(ATTN_SHAPE, generator=gen, device=dev)
               for _ in range(3))
    bias = torch.zeros((ATTN_SHAPE[2], ATTN_SHAPE[2]), device=dev)

    def step() -> torch.Tensor:
        y, loss = _quota_step(x)
        x.copy_(y)
        ba.attention_block(q, k, v, bias)
        return loss

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    run = step
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode=capture_mode):
            # inside the capture: torch's own launches before it begins
            # (its RNG state's fills) run, and are no part of it
            if around_capture is not None:
                around_capture("before")
            static_loss = step()
            if around_capture is not None:
                around_capture("after")

        def run() -> torch.Tensor:
            g.replay()
            return static_loss
    for _ in range(warmup):
        _ = float(run())
    if before_timed is not None:
        before_timed()
    t0 = time.perf_counter()
    for _ in range(steps):
        _ = float(run())
    return 1000 * (time.perf_counter() - t0) / steps


def step_device_share(dim: int, warmup: int, steps: int,
                      device: str | torch.device | None = None) -> dict:
    """How much of the unthrottled quota step the card spends busy: CUDA
    events before and after each step's launches give its device span
    (an upper bound on busy time), the host clock its wall. The limiter
    meters device time, so a quota q should give the share t100/tq of
    about q / busy_share."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("device spans are measured on the card")
    x = _quota_input(dim, dev)
    for _ in range(warmup):
        x, loss = _quota_step(x)
        _ = float(loss)
    spans = []
    t0 = time.perf_counter()
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x, loss = _quota_step(x)
        end.record()
        _ = float(loss)
        spans.append((start, end))
    wall_ms = 1000 * (time.perf_counter() - t0)
    busy_ms = sum(s.elapsed_time(e) for s, e in spans)
    return {"ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "busy_share": busy_ms / wall_ms}


def kernel_ms(fn) -> float:
    """Device time of the kernels `fn()` launches, in ms, summed from
    torch.profiler's device events (copies and memsets left out: the
    interposer meters kernel launches)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.key.startswith(("Memcpy",
                                                              "Memset")):
            continue
        total_us += getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)
    return total_us / 1000


def kernel_reading(prof, steps: int) -> dict:
    """The device time per step of the kernels in a torch.profiler run
    over `steps` steps (copies, memsets and the interposer's own
    slice-clock kernels, `vtpu_*`, which run beside the tenant's, left
    out), two ways: per kernel
    name, its median duration times its launches per step rounded to a
    whole number (`median_ms`), which holds where the profiler drops or
    repeats some of a profile's events; and every kernel event's time
    summed over the steps (`sum_ms`, `kernel_ms`'s reading). `kernels`:
    per name (its first 60 characters, `#n` added where two names begin
    alike), the events the profile holds
    (against `steps` times the launches per step), and their median, mean
    and longest duration in ms, which tell a dropped or repeated event
    from a slow run."""
    durs: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type.name != "CUDA" or e.name.startswith(
                ("Memcpy", "Memset", "vtpu_")):
            continue
        durs.setdefault(e.name, []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    robust = sum(sorted(d)[len(d) // 2] * round(len(d) / steps)
                 for d in durs.values())
    kernels = {}
    for name, d in sorted(durs.items()):
        key, n = name[:60], 1
        while key in kernels:
            key, n = f"{name[:60]}#{n}", n + 1
        kernels[key] = [len(d), sorted(d)[len(d) // 2], sum(d) / len(d),
                        max(d)]
    return {"median_ms": robust,
            "sum_ms": sum(sum(d) for d in durs.values()) / steps,
            "kernels": kernels}


def kernel_ms_per_step(fn, steps: int) -> dict:
    """`kernel_reading` of the kernels `fn()` launches over `steps`
    steps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_reading(prof, steps)


def step_device_times(dim: int, steps: int, pause_s: float,
                      device: str | torch.device | None = None) -> dict:
    """Two views of one quota step's device time on the card:

    - isolated: single steps, each after `pause_s` of idle, with CUDA
      events before and after the step's launches (as
      `step_device_share` takes them) and the profiler's kernel time of
      the same steps. Under the interposer the pause refills the bucket,
      so each step runs unthrottled inside a throttled tenant;
    - loop: `steps` steps back to back as the tenant's loop runs them
      (throttled, under the interposer), the profiler's kernel time per
      step (`kernel_reading`: each kernel's median times its launches per
      step, and beside it the events' sum, which moved between runs of
      the same step on the H100 while the charge and the isolated kernel
      time held: ROADMAP F5; and each kernel's events)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("device spans are measured on the card")
    x = _quota_input(dim, dev)
    x, loss = _quota_step(x)
    _ = float(loss)
    spans = []

    def isolated():
        nonlocal x
        for _ in range(5):
            time.sleep(pause_s)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            x, loss = _quota_step(x)
            end.record()
            _ = float(loss)
            spans.append(start.elapsed_time(end))

    def loop():
        nonlocal x
        for _ in range(steps):
            x, loss = _quota_step(x)
            _ = float(loss)

    isolated_kernel = kernel_ms(isolated) / len(spans)
    reading = kernel_ms_per_step(loop, steps)
    return {"isolated_ms": spans, "isolated_kernel_ms": isolated_kernel,
            "loop_kernel_ms": reading["median_ms"],
            "loop_kernel_ms_sum": reading["sum_ms"],
            "loop_kernels": reading["kernels"]}


def mfu_measure(n: int, inner: int, reads: int,
                device: str | torch.device | None = None) -> dict:
    """`inner` bf16 n x n matmuls per block, one scalar readback per block,
    analytic FLOPs (2 n^3 per matmul) over the host clock."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, n), generator=gen, device=dev, dtype=torch.bfloat16)

    def block(x):
        for _ in range(inner):
            y = x @ x
            # cheap elementwise renorm keeps the carry bounded
            x = (y / (1.0 + y.abs().max())).to(x.dtype)
        return x, x[0, 0].float()

    x, loss = block(x)
    _ = float(loss)
    t0 = time.perf_counter()
    for _ in range(reads):
        x, loss = block(x)
        _ = float(loss)
    dt = time.perf_counter() - t0
    flops = 2.0 * (n ** 3) * inner * reads
    name = device_name(dev)
    peak = bf16_peak_flops(name)
    if peak is None:
        print(f"mfu: no bf16 peak known for {name!r}; mfu_pct is null",
              file=sys.stderr)
    return {"tflops": flops / dt / 1e12,
            "mfu_pct": None if peak is None else 100.0 * flops / dt / peak,
            "wall_s": dt, "device": name}
