"""The port's CUDA kernel on the card, against its plain version.

Marked `gpu`: each test skips without an NVIDIA card (the kernel has no
CPU mode). This file imports no JAX, so it also runs where only the
port's dependencies are installed:

    python -m pytest tests/test_torch_gpu.py -m gpu

Tolerance 1e-4 absolute on the normalised output: the kernel sums in
another order than the plain version's matrix products, with TF32 off.
"""

import pytest
import torch

from vtpu_manager_torch.util.torchplatform import exact_fp32
from vtpu_manager_torch.workloads import block_attention as ba
from vtpu_manager_torch.workloads import ring_attention as ra

TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    exact_fp32()
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, b, h, sq, sk, d, dtype=torch.float32):
    q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d,dtype", [
    (2, 4, 100, 70, 64, torch.float32),     # ragged tiles both ways
    (1, 2, 33, 129, 128, torch.float32),
    (2, 2, 64, 64, 8, torch.bfloat16),
    (1, 1, 5, 3, 1, torch.float32),
])
def test_kernel_matches_plain(card, b, h, sq, sk, d, dtype):
    q, k, v = _inputs(card, b, h, sq, sk, d, dtype)
    rows = torch.arange(sq, device="cuda")[:, None]
    cols = torch.arange(sk, device="cuda")[None, :]
    bias = torch.where(rows >= cols, 0.0, float("-inf"))
    before = ba.LAUNCHES["attn_block"]
    o, m, l = ba.attention_block(q, k, v, bias)
    ro, rm, rl = ra.block_partials(q.float(), k.float(), v.float(), bias)
    torch.cuda.synchronize()
    assert ba.LAUNCHES["attn_block"] == before + 1
    out = ba.combine_blocks([(o, m, l)])
    ref = ba.combine_blocks([(ro, rm, rl)])
    assert (out - ref).abs().max().item() <= TOL
    assert torch.equal(torch.isneginf(m), torch.isneginf(rm))


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _inputs(card, 1, 1, 8, 8, 8)
    bias = torch.zeros((8, 8), device="cuda")
    with pytest.raises(ValueError):
        ba.attention_block(q.transpose(2, 3), k, v, bias)    # a strided view
    with pytest.raises(ValueError):
        ba.attention_block(q.half(), k.half(), v.half(), bias)
    wide = _inputs(card, 1, 1, 8, 8, 256)
    with pytest.raises(ValueError):
        ba.attention_block(*wide, bias)


@pytest.mark.gpu
def test_step_device_share_is_a_share(card):
    from vtpu_manager_torch.bench_steps import step_device_share
    out = step_device_share(dim=512, warmup=2, steps=5)
    assert 0 < out["device_ms_per_step"] <= out["ms_per_step"] * 1.05
    assert 0 < out["busy_share"] <= 1.05
