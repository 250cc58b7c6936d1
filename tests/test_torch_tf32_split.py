"""The accuracy argument behind the block-attention kernel's split TF32.

`csrc/attn_block.cu` takes both of its products on the tensor cores in
TF32, which keeps 10 mantissa bits. Here the rounding is emulated in torch
on the CPU (round to nearest, ties away, at 10 bits: what
`cvt.rna.tf32.f32` does) on numpy-seeded inputs at (1, 2, 512, 128):

- one TF32 pass misses the 1e-4 the kernel is held to (on the card, by
  chip_smoke.py and tests/test_torch_gpu.py);
- the kernel's three-term split, big.small + small.big + big.big with
  big = rna(x) and small = x - big (exact in fp32; the mma reads its top
  19 bits, i.e. truncates it to TF32), meets it against the plain
  version `block_partials` and against the JAX package's Pallas kernel in
  interpret mode.

The emulated products are exact (a TF32 x TF32 product fits in fp32) and
summed in fp32, as the tensor cores accumulate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu_manager.workloads import pallas_attention as jpa
from vtpu_manager_torch.util.torchplatform import cap_cpu_threads
from vtpu_manager_torch.workloads import block_attention as ba
from vtpu_manager_torch.workloads import ring_attention as ra

TOL = 1e-4
SHAPE = (1, 2, 512, 128)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    cap_cpu_threads()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), round to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 by dropping the low 13 bits, as the mma reads fp32."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32(x)
    return big, truncate(x - big)


def product(a: torch.Tensor, b: torch.Tensor, split_terms: bool):
    """a @ b as the kernel's mma instructions take it."""
    if not split_terms:
        return tf32(a) @ tf32(b)
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return a_big @ b_small + a_small @ b_big + a_big @ b_big


def emulated_partials(q, k, v, bias, split_terms):
    """block_partials with its two products in (split) TF32."""
    scores = product(q, k.transpose(-1, -2), split_terms)
    scores = scores * q.shape[-1] ** -0.5 + bias
    m = scores.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isneginf(scores), torch.zeros_like(p), p)
    return product(p, v, split_terms), m, p.sum(dim=-1)


def _inputs(seed, shape=SHAPE, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(3))
    rows = torch.arange(shape[2])[:, None]
    cols = torch.arange(shape[2])[None, :]
    bias = torch.where(rows >= cols, 0.0, float("-inf"))
    return q * q_scale, k, v, bias


def _errors(got, want):
    """(normalised output, m) max abs errors between two partial triples."""
    out = ba.combine_blocks([got])
    ref = ba.combine_blocks([want])
    m, rm = got[1], want[1]
    assert torch.equal(torch.isneginf(m), torch.isneginf(rm))
    return ((out - ref).abs().max().item(),
            (m.nan_to_num(neginf=0.0) - rm.nan_to_num(neginf=0.0))
            .abs().max().item())


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -11 - 2 ** -23, 3.0e-39, 0.0])
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10),
                         1.0, 0.0, 0.0])
    # ties go away from zero, below a tie rounds down, the low 13 bits clear
    assert torch.equal(tf32(x)[:4], want[:4])
    assert (tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    assert ((r - tf32(r)).abs() <= r.abs() * 2.0 ** -11).all()
    big, small = split(r)
    # big + small keeps x to 2^-21 relative (small's own truncation)
    assert ((big.double() + small.double() - r.double()).abs()
            <= r.abs().double() * 2.0 ** -21).all()


def test_single_pass_tf32_misses_the_tolerance():
    q, k, v, bias = _inputs(0)
    err_out, err_m = _errors(emulated_partials(q, k, v, bias, False),
                             ra.block_partials(q, k, v, bias))
    assert max(err_out, err_m) > 3 * TOL, (err_out, err_m)


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_split_tf32_meets_the_tolerance(q_scale):
    q, k, v, bias = _inputs(1, q_scale=q_scale)
    got = emulated_partials(q, k, v, bias, True)
    want = ra.block_partials(q, k, v, bias)
    err_out, err_m = _errors(got, want)
    assert err_out <= TOL and err_m <= TOL, (err_out, err_m)
    assert torch.allclose(got[2], want[2], rtol=1e-4, atol=1e-6)


def test_split_tf32_matches_pallas_interpret():
    q, k, v, bias = _inputs(2, shape=(1, 2, 64, 32))
    jo, jm, jl = jpa.attention_block(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, bias)), interpret=True)
    want = tuple(torch.from_numpy(np.array(t)) for t in (jo, jm, jl))
    got = emulated_partials(q, k, v, bias, True)
    err_out, err_m = _errors(got, want)
    assert err_out <= TOL and err_m <= TOL, (err_out, err_m)
    assert torch.allclose(got[2], want[2], rtol=1e-4, atol=1e-6)
