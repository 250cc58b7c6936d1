"""Expert parallelism: a top-1 MoE layer with experts over a process group.

Ports `vtpu_manager/workloads/moe.py` whole (`moe_params:31`,
`_routing:42`, `expert_mlp:60`, `reference_moe:64`,
`reference_moe_per_shard:73`, `param_shardings:86`, `make_moe_forward:94`,
`_moe_shard:107`, `_run_local_experts:129`). Tokens go to experts by a
dense capacity-slotted one-hot dispatch onto [experts, capacity] slots; an
all-to-all moves each expert's slots to the rank that holds the expert, the
local experts run, and a second all-to-all brings the results home for the
gate-weighted combine. Capacity is per (expert x token shard), and overflow
tokens are dropped (combine weight zero), as in the JAX code.

Each of the JAX code's two `all_to_all(split_axis=0, concat_axis=0,
tiled=False)` is one `all_to_all_single` on a contiguous [n, E/n, C, w]
tensor (`collectives.all_to_all`). The routing keeps the JAX dtypes: the
one-hots and the exclusive cumsum in float32 (exact for counts below 2^24),
the slot index cast to int32, and a slot index at or past the capacity one-
hot to zeros, as `jax.nn.one_hot` makes it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from vtpu_manager_torch.util.torchplatform import resolve_device
from vtpu_manager_torch.workloads.collectives import all_to_all, block


def moe_params(n_experts: int, width: int, hidden: int, seed: int = 0,
               device: str | torch.device | None = None) -> dict:
    """Router [width, E] and stacked expert weights, N(0, 1) * width^-0.5
    as the JAX init (torch's generator, not JAX's)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    scale = width ** -0.5
    dev = resolve_device(device)
    shapes = {"router": (width, n_experts),
              "w1": (n_experts, width, hidden),
              "w2": (n_experts, hidden, width)}
    return {name: (torch.randn(shape, generator=gen) * scale).to(dev)
            for name, shape in shapes.items()}


def moe_params_from_numpy(tree: dict,
                          device: str | torch.device | None = None) -> dict:
    """The JAX `moe_params` tree, as numpy arrays, as the port's."""
    dev = resolve_device(device)
    out = {name: torch.from_numpy(np.array(tree[name], dtype=np.float32))
           .to(dev) for name in ("router", "w1", "w2")}
    e = out["router"].shape[1]
    if out["w1"].shape[0] != e or out["w2"].shape[0] != e:
        raise ValueError(f"router has {e} experts, w1 {out['w1'].shape[0]}, "
                         f"w2 {out['w2'].shape[0]}")
    return out


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot whose rows are all zero where index is outside
    [0, n), as `jax.nn.one_hot` (torch's refuses such an index)."""
    return (index[:, None] == torch.arange(n, device=index.device)
            ).to(torch.float32)


def _routing(x: torch.Tensor, router: torch.Tensor, capacity: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routing with capacity slots. x [T, width] -> dispatch
    [T, E, C] one-hot and combine [T, E, C] gate-weighted."""
    logits = x @ router                                   # [T, E]
    gates = torch.softmax(logits, dim=-1)
    expert = torch.argmax(gates, dim=-1)                  # first maximum
    gate = gates.gather(-1, expert[:, None])[:, 0]
    onehot = _one_hot(expert, router.shape[1])            # [T, E]
    # position of each token in its expert's queue (exclusive cumsum)
    pos = torch.cumsum(onehot, dim=0) * onehot - onehot   # [T, E]
    kept = (pos < capacity).to(torch.float32) * onehot    # overflow dropped
    slot = _one_hot(pos.sum(dim=-1).to(torch.int32), capacity)   # [T, C]
    dispatch = kept[:, :, None] * slot[:, None, :]        # [T, E, C]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine


def expert_mlp(w1: torch.Tensor, w2: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """tanh(x w1) w2; with a leading expert axis on all three, each expert
    on its own slots (the JAX vmap)."""
    return torch.tanh(x @ w1) @ w2


def reference_moe(params: dict, x: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """Dense single-device reference: every expert runs on the full
    dispatch tensor; combine zeros out drops."""
    dispatch, combine = _routing(x, params["router"], capacity)
    slots = torch.einsum("tec,tw->ecw", dispatch, x)      # [E, C, width]
    out = expert_mlp(params["w1"], params["w2"], slots)
    return torch.einsum("tec,ecw->tw", combine, out)


def reference_moe_per_shard(params: dict, x: torch.Tensor, capacity: int,
                            n_shards: int) -> torch.Tensor:
    """The sharded path's contract: the dense reference applied per token
    shard (capacity is per shard) and concatenated."""
    t_per = x.shape[0] // n_shards
    return torch.cat([reference_moe(params, x[i * t_per:(i + 1) * t_per],
                                    capacity) for i in range(n_shards)])


def param_shardings() -> dict:
    """The router replicated, the experts split over the group: rank i
    holds experts [i E/n, (i + 1) E/n) (the JAX P() and P(axis))."""
    return {"router": Replicate(), "w1": Shard(0), "w2": Shard(0)}


def local_experts(params: dict, group) -> dict:
    """This rank's part of full weights, by `param_shardings`."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    return {name: block(params[name], spec, me, n)
            for name, spec in param_shardings().items()}


def make_moe_forward(group, capacity: int):
    """Forward over this rank's tokens x [T/n, width] with its experts
    (`local_experts`); returns its tokens' outputs [T/n, width]."""
    n_shards = dist.get_world_size(group)

    def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
        return _moe_shard(params, x, capacity=capacity, group=group,
                          n_shards=n_shards)
    return forward


def _moe_shard(params: dict, x: torch.Tensor, *, capacity: int, group,
               n_shards: int) -> torch.Tensor:
    """Routing on the local tokens against all experts, then the slot
    blocks traded so each rank runs only its experts."""
    dispatch, combine = _routing(x, params["router"], capacity)  # [t, E, C]
    slots = torch.einsum("tec,tw->ecw", dispatch, x)      # [E, C, w] local
    e_per = slots.shape[0] // n_shards
    # split the expert axis into [n, E/n] and trade: afterwards this rank
    # holds its experts' slots from every token shard
    slots = all_to_all(slots.reshape(n_shards, e_per, capacity,
                                     slots.shape[-1]), group)
    out = _run_local_experts(params, slots, e_per)
    # the results back to the token shards they came from
    out = all_to_all(out, group)
    out = out.reshape(e_per * n_shards, capacity, out.shape[-1])
    return torch.einsum("tec,ecw->tw", combine, out)


def _run_local_experts(params: dict, slots: torch.Tensor,
                       e_per: int) -> torch.Tensor:
    """slots [n, E/n, C, w] -> the same shape through the local experts
    (local expert i takes slots[:, i])."""
    n_shards, _, cap, width = slots.shape
    batched = slots.transpose(0, 1).reshape(e_per, n_shards * cap, width)
    out = expert_mlp(params["w1"], params["w2"], batched)
    return out.reshape(e_per, n_shards, cap, width).transpose(0, 1)
