"""The collectives of the distributed workloads, over a process group.

The JAX workloads move data with `lax.ppermute`, `lax.all_to_all` and
`lax.psum` over a mesh axis; here a mesh axis is a process group, and each
of those becomes one call:

- `shift`: every rank sends to the next rank of the group and receives
  from the previous one (`ppermute` with `(i, (i + 1) % n)`), as one
  `batch_isend_irecv`, so no rank blocks on an unmatched send. `Shift` is
  the same with a gradient: its backward sends the incoming gradient one
  hop back;
- `all_to_all`: `all_to_all_single` over a contiguous [n, ...] tensor;
- `all_reduce` and `AllReduce`: a sum, the second with a gradient.

Gloo's point-to-point calls carry host tensors only: given a card tensor,
gloo hands the card pointer to its socket (`writev`: Bad address) and the
ranks abort, while its collectives copy card tensors through the host
themselves. So where the group's backend is gloo and a tensor lives on the
card (ranks sharing one card), `shift` stages it through pinned host
buffers: the compute stays on the card, and only the transfer goes
through the host. NCCL takes card tensors as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def block(t: torch.Tensor, placement, index: int,
          count: int) -> torch.Tensor:
    """The `index`-th of `count` ranks' part of a full tensor by one
    placement: a Shard's equal slice of its dim, all of it otherwise."""
    # DTensor's package takes a second to import: only where it is used,
    # never by a tenant that imports the kernel's wrapper
    from torch.distributed.tensor import Shard

    if not isinstance(placement, Shard):
        return t
    if t.shape[placement.dim] % count:
        raise ValueError(f"dim {placement.dim} of {tuple(t.shape)} does not "
                         f"split over {count} ranks")
    size = t.shape[placement.dim] // count
    return t.narrow(placement.dim, index * size, size)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _peer(group, index: int) -> int:
    """The global rank of the group's `index`-th member (P2P calls take
    global ranks)."""
    return dist.get_global_rank(group, index % dist.get_world_size(group))


def shift(t: torch.Tensor, group, hops: int = 1) -> torch.Tensor:
    """What rank i - hops of the group held; rank i's `t` goes to rank
    i + hops. One hop is a ring's rotation, -1 the rotation back. A group
    of one rank keeps its tensor (the ring's own hop)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    me = dist.get_rank(group)
    staged = t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO
    send = _to_host(t) if staged else t.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(group, me + hops), group),
           dist.P2POp(dist.irecv, recv, _peer(group, me - hops), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device) if staged else recv


class Shift(torch.autograd.Function):
    """`shift` with a gradient: the backward sends the incoming gradient
    one hop back, from rank i + hops to rank i (point-to-point calls carry
    none)."""

    @staticmethod
    def forward(ctx, t, group, hops):
        ctx.group, ctx.hops = group, hops
        return shift(t, group, hops)

    @staticmethod
    def backward(ctx, grad):
        return shift(grad.contiguous(), ctx.group, -ctx.hops), None, None


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] -> [n, ...]: block j goes to rank j, and block j of the
    result is what rank j sent here (`lax.all_to_all` with split_axis=0,
    concat_axis=0, tiled=False)."""
    if t.shape[0] != dist.get_world_size(group):
        raise ValueError(f"leading dim {t.shape[0]} is not the group's "
                         f"size {dist.get_world_size(group)}")
    send = t.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, as a new tensor."""
    buf = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=group)
    return buf


class AllReduce(torch.autograd.Function):
    """`all_reduce` with a gradient, as `torch.distributed.nn.functional.
    all_reduce` has it (which torch 2.13 deprecates): the backward sums the
    incoming gradients over the group too. Through it, autograd gives each
    rank the gradient of the sum of the ranks' losses."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None
