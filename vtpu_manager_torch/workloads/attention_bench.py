"""Block-attention kernel vs its plain version: the capture's hot-op probe.

Ports `vtpu_manager/workloads/pallas_bench.py` (`measure:17`, `main:70`).
Each timed block runs `inner` attention calls, renormalising the carry
between them, and ends in one scalar readback, which waits for the card;
the time per call is the host clock over `reads` such blocks. Importable
so the CPU tests execute the same logic at tiny shapes.
"""

from __future__ import annotations

import time

import torch

from vtpu_manager_torch.util.torchplatform import device_name, resolve_device
from vtpu_manager_torch.workloads import block_attention as ba
from vtpu_manager_torch.workloads.ring_attention import reference_attention


def measure(b: int = 8, h: int = 16, s: int = 512, d: int = 128,
            inner: int = 20, reads: int = 3,
            device: str | torch.device | None = None) -> dict:
    """Per-call ms of the kernel path (attention_block + combine_blocks)
    and of plain exact attention, on the same fp32 inputs."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (b, h, s, d)
    q = torch.randn(shape, generator=gen, device=dev)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    bias = torch.zeros((s, s), dtype=torch.float32, device=dev)

    def kernel_one(x):
        return ba.combine_blocks([ba.attention_block(x, k, v, bias)])

    def plain_one(x):
        return reference_attention(x, k, v, causal=False)

    def bench_fn(fn) -> float:
        def block(x):
            for _ in range(inner):
                y = fn(x)
                x = y / (1.0 + y.abs().max())
            return x, x[0, 0, 0, 0]

        x, loss = block(q.clone())
        _ = float(loss)                  # build, warm-up
        t0 = time.perf_counter()
        for _ in range(reads):
            x, loss = block(x)
            _ = float(loss)
        return (time.perf_counter() - t0) * 1000 / (reads * inner)

    return {"ms_kernel": bench_fn(kernel_one),
            "ms_plain": bench_fn(plain_one),
            "b": b, "h": h, "s": s, "d": d, "inner": inner,
            "device": device_name(dev)}


def main() -> None:
    """Capture entry: the card at the capture's shape; the line echoes the
    shape so its label cannot drift from what ran."""
    out = measure()
    print(f"ATTN ms_kernel={out['ms_kernel']:.3f} "
          f"ms_plain={out['ms_plain']:.3f} "
          f"b={out['b']} h={out['h']} s={out['s']} d={out['d']} "
          f"inner={out['inner']} device={out['device']!r}")


if __name__ == "__main__":
    main()
