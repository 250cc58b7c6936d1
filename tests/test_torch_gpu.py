"""The port's CUDA kernel on the card, against its plain version.

Marked `gpu`: each test skips without an NVIDIA card (the kernel has no
CPU mode). This file imports no JAX, so it also runs where only the
port's dependencies are installed:

    python -m pytest tests/test_torch_gpu.py -m gpu

Tolerance 1e-4 absolute on the normalised output and on m: the kernel
sums in another order than the plain version's matrix products, with TF32
off, and takes its products as split TF32 (three tensor-core products
each, about fp32 accuracy; tests/test_torch_tf32_split.py has the
argument).
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


def _causal(sq, sk):
    rows = torch.arange(sq, device="cuda")[:, None]
    cols = torch.arange(sk, device="cuda")[None, :]
    return torch.where(rows >= cols, 0.0, float("-inf"))


def _assert_matches_plain(q, k, v, bias):
    before = ba.LAUNCHES["attn_block"]
    o, m, l = ba.attention_block(q, k, v, bias)
    ro, rm, rl = ra.block_partials(q.float(), k.float(), v.float(), bias)
    torch.cuda.synchronize()
    assert ba.LAUNCHES["attn_block"] == before + 1
    out = ba.combine_blocks([(o, m, l)])
    ref = ba.combine_blocks([(ro, rm, rl)])
    assert (out - ref).abs().max().item() <= TOL
    assert torch.equal(torch.isneginf(m), torch.isneginf(rm))
    assert torch.allclose(m.nan_to_num(neginf=0.0), rm.nan_to_num(neginf=0.0),
                          atol=TOL, rtol=0)
    assert torch.allclose(l, rl, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,sq,sk,d,dtype", [
    (2, 4, 100, 70, 64, torch.float32),     # ragged tiles both ways
    (1, 2, 33, 129, 128, torch.float32),
    (2, 2, 64, 64, 8, torch.bfloat16),
    (1, 1, 5, 3, 1, torch.float32),
    (2, 4, 100, 70, 72, torch.bfloat16),
    (1, 2, 40, 130, 33, torch.bfloat16),    # odd d: plain bf16 copies
])
def test_kernel_matches_plain(card, b, h, sq, sk, d, dtype):
    q, k, v = _inputs(card, b, h, sq, sk, d, dtype)
    _assert_matches_plain(q, k, v, _causal(sq, sk))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 8, 72, 128])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_kernel_head_dims_and_large_scores(card, d, q_scale):
    # ragged 100 x 70; q x 8 gives large, peaked scores, where one TF32
    # pass would miss the tolerance a hundred times over
    q, k, v = _inputs(card, 2, 4, 100, 70, d)
    _assert_matches_plain(q * q_scale, k, v, _causal(100, 70))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_rows_off_16_byte_alignment(card, dtype):
    # one element into a buffer: the kernel copies narrower, not elsewhere
    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device="cuda")
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    q, k, v = map(shifted, _inputs(card, 1, 2, 70, 130, 64, dtype))
    assert q.data_ptr() % 16 != 0
    _assert_matches_plain(q, k, v, _causal(70, 130))


@pytest.mark.gpu
def test_one_call_is_one_kernel_launch(card):
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _inputs(card, 2, 4, 100, 70, 64)
    bias = _causal(100, 70)
    ba.attention_block(q, k, v, bias)               # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ba.attention_block(q, k, v, bias)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    assert [(e.count, "AttnBlockKernel" in e.key) for e in kernels] == \
        [(1, True)], [e.key for e in kernels]


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
