#!/usr/bin/env python3
"""Living under a memory cap with host offload: layer-streamed inference.

The port's `examples/host_offload_demo.py`. Every layer's weights live in
pinned host memory (`torch.Tensor.pin_memory`, which the CUDA runtime
takes with cuMemHostAlloc); each step copies one layer to the card,
applies it and drops the copy, so the card holds one layer and the
activations, not the model. Host memory is never charged to the cap (the
reference's rule for host memory spaces: the interposer hooks no host
allocation), so a tenant can hold a model larger than its cap as long as
what is resident fits.

    python -m vtpu_manager_torch.tools.host_offload_demo [--layers 8]
        [--width 8192] [--batch 64] [--check] [--device cpu]

With `--check` the same layers run on the CPU from the same bf16 weights
and input, in float32 with each layer's output rounded to bf16 as the
card's is, and the largest difference is reported. The last line is
`HOST_OFFLOAD {json}`: the shapes, the model's bytes, the card's peak
(torch's allocator and, under the interposer, the most its cap granted at
once), the output's mean magnitude and the difference.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys


def make_layers(torch, layers: int, width: int, batch: int, seed: int):
    """bf16 weights scaled to keep the activations in tanh's range, and
    the input, made on the CPU from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    weights = [(torch.randn((width, width), generator=gen)
                / width ** 0.5).to(torch.bfloat16) for _ in range(layers)]
    x = torch.randn((batch, width), generator=gen).to(torch.bfloat16)
    return weights, x


def offload(weights, dev) -> list:
    """The weights in pinned host memory (plain host memory on the CPU)."""
    return [w.pin_memory() if dev.type == "cuda" else w for w in weights]


def streamed_forward(torch, weights_host, x, dev):
    """Applies the layers one at a time, each copied to `dev` just before
    use and dropped after: the card holds one layer and the activation."""
    x = x.to(dev)
    for w in weights_host:
        w_dev = w.to(dev, non_blocking=True)
        x = torch.tanh(x @ w_dev)
        del w_dev
    return x


def reference_forward(torch, weights, x):
    """The layers on the CPU in float32, each output rounded to bf16."""
    x = x.float()
    for w in weights:
        x = torch.tanh(x @ w.float()).to(torch.bfloat16).float()
    return x


def interposer_peak_bytes() -> int | None:
    """The most the interposer's cap granted this process at once on
    device 0, when it is preloaded."""
    path = os.environ.get("LD_PRELOAD", "").split(":")[0]
    if not path:
        return None
    fn = getattr(ctypes.CDLL(path), "vtpu_peak_bytes", None)
    if fn is None:
        return None
    fn.restype, fn.argtypes = ctypes.c_int64, [ctypes.c_int]
    return int(fn(0))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--width", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="also run the layers on the CPU and compare")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    import torch

    from vtpu_manager_torch.util.torchplatform import (device_name,
                                                        resolve_device)
    dev = resolve_device(args.device)
    weights, x = make_layers(torch, args.layers, args.width, args.batch,
                             args.seed)
    host = offload(weights, dev)
    layer_bytes = args.width * args.width * 2
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    y = streamed_forward(torch, host, x, dev).cpu()
    rec = {"device": device_name(dev), "layers": args.layers,
           "width": args.width, "batch": args.batch,
           "pinned": all(w.is_pinned() for w in host) if dev.type == "cuda"
           else False,
           "model_bytes": args.layers * layer_bytes,
           "layer_bytes": layer_bytes,
           "peak_allocated_bytes": (torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else None),
           "interposer_peak_bytes": interposer_peak_bytes(),
           "shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
           "mean_abs": float(y.float().abs().mean())}
    if args.check:
        ref = reference_forward(torch, weights, x)
        rec["max_abs_err"] = float((y.float() - ref).abs().max())
    print(f"model: {args.layers} layers x {layer_bytes / 2**20:.0f} MiB held "
          f"in {'pinned host' if rec['pinned'] else 'host'} memory; forward "
          f"{'ok' if rec['finite'] else 'NOT FINITE'}", flush=True)
    print("HOST_OFFLOAD " + json.dumps(rec), flush=True)
    return 0 if rec["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
