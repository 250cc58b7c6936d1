"""Pipeline parallelism: layer stages over the ranks of a process group.

Ports `vtpu_manager/workloads/pipeline.py` whole (`stage_params:27`,
`stage_fn:37`, `reference_forward:43`, `param_shardings:51`,
`make_pipeline_forward:56`, `_pipeline_shard:68`). Each rank holds one
stage's weights; microbatches enter stage 0 one per tick and activations
hop stage to stage, the GPipe schedule of the JAX code:

- n_micro + n_stages - 1 ticks (the bubble);
- stage 0 takes microbatch t, and bubble ticks feed zeros that are never
  collected; the other stages take what the previous stage sent;
- the last stage collects microbatch t - (n_stages - 1) at tick t; its own
  hop wraps to stage 0, where fresh input overwrites it.

Each tick's `ppermute` is a matched send to stage s + 1 and receive from
s - 1 in one `batch_isend_irecv` (`collectives.shift`), and the final
`psum` of the masked outputs an `all_reduce`, so every rank returns the
whole output.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from vtpu_manager_torch.util.torchplatform import resolve_device
from vtpu_manager_torch.workloads.collectives import all_reduce, block, shift


def stage_params(n_stages: int, width: int, seed: int = 0,
                 device: str | torch.device | None = None) -> dict:
    """Stacked per-stage MLP block weights, leading axis = stage,
    N(0, 1) * width^-0.5 as the JAX init (torch's generator, not JAX's)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    scale = width ** -0.5
    dev = resolve_device(device)
    return {name: (torch.randn((n_stages, width, width), generator=gen)
                   * scale).to(dev) for name in ("w1", "w2")}


def stage_params_from_numpy(tree: dict,
                            device: str | torch.device | None = None) -> dict:
    """The JAX `stage_params` tree, as numpy arrays, as the port's."""
    dev = resolve_device(device)
    out = {name: torch.from_numpy(np.array(tree[name], dtype=np.float32))
           .to(dev) for name in ("w1", "w2")}
    if out["w1"].shape != out["w2"].shape or out["w1"].dim() != 3:
        raise ValueError(f"w1 {tuple(out['w1'].shape)} and w2 "
                         f"{tuple(out['w2'].shape)} are not [stages, w, w]")
    return out


def stage_fn(params_slice: dict, x: torch.Tensor) -> torch.Tensor:
    """One stage's compute: a residual MLP block."""
    h = torch.tanh(x @ params_slice["w1"])
    return x + h @ params_slice["w2"]


def reference_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequential forward on one device: stages applied in order."""
    for s in range(params["w1"].shape[0]):
        x = stage_fn({name: p[s] for name, p in params.items()}, x)
    return x


def param_shardings() -> dict:
    """Both weights split on the stage axis over the group: rank s holds
    stage s's slice (the JAX P(axis))."""
    return {"w1": Shard(0), "w2": Shard(0)}


def local_stage(params: dict, group) -> dict:
    """This rank's slice of full stacked weights, by `param_shardings`:
    [1, w, w] each, as shard_map hands the JAX body its block."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    if params["w1"].shape[0] != n:
        raise ValueError(f"{params['w1'].shape[0]} stages for {n} ranks")
    return {name: block(params[name], spec, me, n)
            for name, spec in param_shardings().items()}


def make_pipeline_forward(group):
    """Forward over x [n_micro, micro_batch, width], replicated on every
    rank, with this rank's stage weights (`local_stage`); every rank
    returns the whole [n_micro, micro_batch, width] output."""
    n_stages = dist.get_world_size(group)

    def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
        return _pipeline_shard(params, x, n_stages=n_stages, group=group)
    return forward


def _pipeline_shard(params: dict, x: torch.Tensor, *, n_stages: int,
                    group) -> torch.Tensor:
    """One rank's part of the schedule. params' stage axis is this rank's
    one stage."""
    my_stage = dist.get_rank(group)
    local = {name: p[0] for name, p in params.items()}
    n_micro = x.shape[0]
    inflight = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        feed = x[t] if t < n_micro else torch.zeros_like(inflight)
        cur = feed if my_stage == 0 else inflight
        out = stage_fn(local, cur)
        done_idx = t - (n_stages - 1)
        if my_stage == n_stages - 1 and done_idx >= 0:
            outputs[done_idx] = out
        inflight = shift(out, group)
    # the outputs live on the last stage; share them
    return all_reduce(outputs, group)
