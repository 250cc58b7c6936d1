"""Ring attention's single-device parts: flash partials and their merge.

Ports `vtpu_manager/workloads/ring_attention.py` (`block_partials:26`,
`merge_partials:41`, `_block_bias:52`, `reference_attention:139`). The K/V
ring over ranks (`ring_attention_sharded:67`, `make_ring_attention:112`)
comes with the distributed slice. Layout as in the JAX package:
[batch, heads, seq, head_dim].
"""

from __future__ import annotations

import torch

from vtpu_manager_torch.util.torchplatform import resolve_device

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
