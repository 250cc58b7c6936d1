"""Ring attention: sequence-parallel exact attention over a process group.

Ports `vtpu_manager/workloads/ring_attention.py` whole: `block_partials:26`,
`merge_partials:41`, `_block_bias:52`, `ring_attention_sharded:67`,
`make_ring_attention:112`, `reference_attention:139`. Layout as in the JAX
package: [batch, heads, seq, head_dim], the sequence sharded over the
group's ranks in rank order.

Each rank holds its query block and passes its K/V block around the ring:
n - 1 rounds of compute-then-rotate, then the last block with no dead
rotation, the partials combined by the online-softmax merge. The mesh axis
of the JAX code is a process group here, and `ppermute` one
`batch_isend_irecv` (`collectives.Shift`). Point-to-point calls carry no
gradient, so the rotation's backward sends the gradient one hop back, and
gradients flow through the ring as through JAX's.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from vtpu_manager_torch.util.torchplatform import resolve_device
from vtpu_manager_torch.workloads.collectives import Shift

NEG_INF = float("-inf")


def block_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash partials for one K/V block: unnormalized o, running max m,
    sum l. q:[B,H,Sq,D] k,v:[B,H,Sk,D] bias:[Sq,Sk] additive (0/-inf).
    The plain version of the block-attention kernel."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    scores = scores + bias[None, None, :, :]
    m = scores.amax(dim=-1)
    # guard fully-masked blocks: exp(-inf - -inf) -> exp(0) must not happen
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isneginf(scores), torch.zeros_like(p), p)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, m, p.sum(dim=-1)


def merge_partials(o1, m1, l1, o2, m2, l2):
    """Combine two flash partials (the online-softmax merge)."""
    m_new = torch.maximum(m1, m2)
    zero = torch.zeros_like(m_new)
    m_safe = torch.where(torch.isneginf(m_new), zero, m_new)
    a1 = torch.where(torch.isneginf(m1), zero, torch.exp(m1 - m_safe))
    a2 = torch.where(torch.isneginf(m2), zero, torch.exp(m2 - m_safe))
    return (o1 * a1[..., None] + o2 * a2[..., None], m_new,
            l1 * a1 + l2 * a2)


def _block_bias(q_idx: int, k_idx: int, seq_shard: int, causal: bool,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Additive bias for a (query-block, key-block) pair. Causal: key block
    after query block is fully masked; same block gets the triangle. On the
    card unless `device` says otherwise."""
    device = resolve_device(device)
    if not causal or k_idx < q_idx:
        return torch.zeros((seq_shard, seq_shard), dtype=torch.float32,
                           device=device)
    if k_idx > q_idx:
        return torch.full((seq_shard, seq_shard), NEG_INF,
                          dtype=torch.float32, device=device)
    rows = torch.arange(seq_shard, device=device)[:, None]
    cols = torch.arange(seq_shard, device=device)[None, :]
    return torch.where(rows >= cols, 0.0, NEG_INF).to(torch.float32)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Single-device exact attention for numerics checks."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = q.shape[2]
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           group, causal: bool = True,
                           block_fn=None) -> torch.Tensor:
    """One rank's part: q, k, v are this rank's sequence shards
    [B, H, S_local, D]; returns its shard of the output. `block_fn`
    computes one block's flash partials (default `block_partials`; the
    kernel, `block_attention.attention_block`, is the drop-in)."""
    if block_fn is None:
        block_fn = block_partials
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    seq_shard = q.shape[2]
    qf = q.float()
    o = torch.zeros_like(qf)
    m = torch.full_like(qf[..., 0], NEG_INF)
    l = torch.zeros_like(qf[..., 0])
    kv = torch.stack((k, v))
    for step in range(n):
        if step:
            # rotate K/V one hop around the ring: n - 1 rotations, none
            # after the last block (its transfer would be discarded)
            kv = Shift.apply(kv, group, 1)
        k_idx = (me - step) % n            # whose K/V this rank holds now
        bias = _block_bias(me, k_idx, seq_shard, causal, device=q.device)
        o2, m2, l2 = block_fn(qf, kv[0].float(), kv[1].float(), bias)
        o, m, l = merge_partials(o, m, l, o2, m2, l2)
    l = torch.where(l == 0.0, torch.ones_like(l), l)   # masked rows stay 0
    return (o / l[..., None]).to(q.dtype)


def make_ring_attention(group, causal: bool = True, use_pallas: bool = False):
    """Ring attention over `group` (the JAX mesh axis): a function of this
    rank's q, k, v shards that returns its output shard. `use_pallas`
    swaps the per-block compute for the block-attention kernel (on CPU
    tensors its plain version, as the wrapper's rule says)."""
    block_fn = None
    if use_pallas:
        from vtpu_manager_torch.workloads.block_attention import make_block_fn
        block_fn = make_block_fn()
    return functools.partial(ring_attention_sharded, group=group,
                             causal=causal, block_fn=block_fn)


def sequence_shard(t: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Rank `index`'s block of a [B, H, S, D] tensor's sequence, as the
    JAX spec P(None, None, axis, None) lays it out."""
    if t.shape[2] % count:
        raise ValueError(f"sequence {t.shape[2]} does not split into {count}")
    s = t.shape[2] // count
    return t[:, :, index * s:(index + 1) * s].contiguous()
