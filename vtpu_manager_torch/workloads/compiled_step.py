"""A tenant's `torch.compile`d step, and its first step through the node
compile cache.

The port of the worker of `scripts/bench_compilecache.py:47-85`. The JAX
worker lowers and compiles a jitted step and stores its StableHLO text;
here the step is compiled by Inductor, and what the store carries is
`torch.compiler.save_cache_artifacts()`: the compiled graph, its
autograd wrapper and, on the card, the Triton kernels' binaries, which
`torch.compiler.load_cache_artifacts()` puts back into a fresh process's
own caches so that its `torch.compile` finds everything compiled.

The step is the quota step at full width, a bf16 `dim`² matrix product
(left to cuBLAS) with a fused elementwise tail that Inductor emits as its
own kernels, and one call of the block-attention kernel through its
custom operator (`torch.ops.vtpu.attn_block`) at (8, 16, 512, 128) fp32,
whose output is normalised in the same graph.

`first_step(inputs, cache, key)` compiles and runs the step once: with no
cache it compiles alone (`uncached`); with one it goes through
`cache.get_or_compile(key, ...)`. On a miss this process compiles, and
the artifacts it saved become the entry; on a hit, or after waiting for
another tenant's compile, or after fetching a warm peer's entry (the
cluster tier's outcome `fetch`), it loads the entry before its first call.
With the cluster tier the tenant's `VTPU_PROGRAM_FINGERPRINT` goes with
the key, so the `fps/` marker lands and the node can advertise the entry.
A traced tenant's store call is its `shim.compile` span, outside the
compiled region.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import time

import torch

from vtpu_manager_torch import trace
from vtpu_manager_torch.clustercache import ClusterCompileCache
from vtpu_manager_torch.compilecache import keys
from vtpu_manager_torch.util import consts
from vtpu_manager_torch.workloads.block_attention import attn_block_op

DIM = 8192                        # the quota step's width
ATTN_SHAPE = (8, 16, 512, 128)    # the attention probe's shape


def step(x: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The quota step (`bench_steps._quota_step`) and one attention block,
    normalised: (y bf16 [dim, dim], attention fp32 [B, H, S, D])."""
    y = torch.tanh(x @ x) * 1e-3
    y = y / (1.0 + y.abs().max())
    o, _, l = attn_block_op(q, k, v, bias)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return y, o / l[..., None]


def make_inputs(dim: int = DIM, attn_shape: tuple = ATTN_SHAPE,
                device: str | torch.device = "cuda", seed: int = 0
                ) -> tuple[torch.Tensor, ...]:
    """(x, q, k, v, bias), the same on every tenant that uses the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((dim, dim), generator=gen, device=device,
                    dtype=torch.bfloat16)
    q, k, v = (torch.randn(attn_shape, generator=gen, device=device)
               for _ in range(3))
    bias = torch.zeros((attn_shape[2], attn_shape[2]), device=device)
    return x, q, k, v, bias


def program_fingerprint(inputs: tuple[torch.Tensor, ...]) -> str:
    """What makes two tenants' compiles the same compile: the step's
    source and its inputs' shapes and types."""
    h = hashlib.sha256(inspect.getsource(step).encode())
    for t in inputs:
        h.update(f"{tuple(t.shape)}:{t.dtype}:{t.device.type};".encode())
    return keys.sanitize_fingerprint(
        f"compiled-step-{inputs[0].shape[0]}-{h.hexdigest()[:16]}")


def card_topology(devices) -> str:
    """The topology string of the entry key: the devices the interposer
    enforces (`keys.topology_fingerprint`) and the card the kernels were
    compiled for, its compute capability and name."""
    card = None
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        card = f"sm_{major}{minor}:{torch.cuda.get_device_name(0)}"
    return keys.topology_fingerprint(devices, card=card)


def entry_key(inputs: tuple[torch.Tensor, ...], devices=()) -> str:
    return keys.entry_key(program_fingerprint(inputs), card_topology(devices),
                          *keys.runtime_versions())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_step(inputs: tuple[torch.Tensor, ...], cache=None,
               key: str | None = None
               ) -> tuple[tuple[torch.Tensor, torch.Tensor], str, float]:
    """(outputs, outcome, seconds): the first step of a fresh
    `torch.compile(step)`, and the time from here until its outputs are on
    hand. Outcome `uncached` without a cache, else `get_or_compile`'s."""
    device = inputs[0].device
    t0 = time.monotonic()
    compiled = torch.compile(step)
    if cache is None:
        out = compiled(*inputs)
        _sync(device)
        return out, "uncached", time.monotonic() - t0
    ran = {}

    def compile_fn() -> bytes:
        ran["out"] = compiled(*inputs)
        _sync(device)
        saved = torch.compiler.save_cache_artifacts()
        if saved is None:
            raise RuntimeError("torch.compile saved no cache artifacts; "
                               "there is nothing to share")
        return saved[0]

    extra = {}
    if isinstance(cache, ClusterCompileCache):
        extra["fingerprint"] = os.environ.get(consts.ENV_PROGRAM_FINGERPRINT,
                                              "")
    payload, outcome = cache.get_or_compile(key, compile_fn,
                                            ctx=trace.context_from_env(),
                                            **extra)
    if "out" not in ran:
        torch.compiler.load_cache_artifacts(payload)
        ran["out"] = compiled(*inputs)
        _sync(device)
    return ran["out"], outcome, time.monotonic() - t0


def compile_counters() -> dict[str, int]:
    """What this process's compiles did: Inductor's graph cache's hits and
    misses (a miss is a compile), from Dynamo's counters."""
    from torch._dynamo.utils import counters
    ind = counters["inductor"]
    return {"fxgraph_cache_hit": int(ind.get("fxgraph_cache_hit", 0)),
            "fxgraph_cache_miss": int(ind.get("fxgraph_cache_miss", 0))}
