"""Port's block attention and ring-attention parts vs the JAX package.

The same numpy inputs go through the JAX functions (the Pallas kernel in
interpret mode, as tests/test_pallas_attention.py runs it) and through the
port, whose `attention_block` takes its plain version for CPU tensors.
Tolerance 2e-5, as tests/test_pallas_attention.py holds the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu_manager.workloads import pallas_attention as jpa
from vtpu_manager.workloads import ring_attention as jra
from vtpu_manager_torch.util.torchplatform import cap_cpu_threads
from vtpu_manager_torch.workloads import attention_bench
from vtpu_manager_torch.workloads import block_attention as ba
from vtpu_manager_torch.workloads import ring_attention as ra

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    cap_cpu_threads()


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    return q, k, v


def _bias(kind, sq, sk):
    if kind == "zero":
        return np.zeros((sq, sk), np.float32)
    if kind == "causal":
        rows = np.arange(sq)[:, None]
        cols = np.arange(sk)[None, :]
        return np.where(rows >= cols, 0.0, -np.inf).astype(np.float32)
    if kind == "masked_row":
        bias = np.zeros((sq, sk), np.float32)
        bias[3] = -np.inf
        return bias
    raise ValueError(kind)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


CASES = [
    # (seed, b, h, sq, sk, d, bias): test_pallas_attention.py:16-63 shapes
    (0, 2, 2, 16, 16, 8, "zero"),
    (2, 1, 1, 16, 16, 8, "causal"),
    (3, 1, 2, 16, 16, 8, "masked_row"),
    (4, 2, 1, 8, 24, 8, "zero"),
]


@pytest.mark.parametrize("seed,b,h,sq,sk,d,kind", CASES)
def test_attention_block_matches_pallas(seed, b, h, sq, sk, d, kind):
    q, k, v = _qkv(seed, b, h, sq, sk, d)
    bias = _bias(kind, sq, sk)
    jo, jm, jl = jpa.attention_block(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(bias),
                                     interpret=True)
    o, m, l = ba.attention_block(_t(q), _t(k), _t(v), _t(bias))
    _close(o, jo)
    _close(l, jl)
    assert np.array_equal(np.isneginf(m.numpy()), np.isneginf(np.asarray(jm)))
    _close(torch.nan_to_num(m, neginf=0.0), np.nan_to_num(jm, neginf=0.0))
    _close(ba.combine_blocks([(o, m, l)]), jpa.combine_blocks([(jo, jm, jl)]))


def test_fully_masked_row_is_zero():
    q, k, v = _qkv(5, 1, 1, 16, 16, 8)
    o, m, l = ba.attention_block(_t(q), _t(k), _t(v),
                                 _t(_bias("masked_row", 16, 16)))
    assert torch.isneginf(m[0, 0, 3])
    assert l[0, 0, 3] == 0 and torch.all(o[0, 0, 3] == 0)
    out = ba.combine_blocks([(o, m, l)])
    assert torch.all(out[0, 0, 3] == 0) and torch.isfinite(out).all()


def test_two_blocks_combine_like_full_attention():
    # the ring-step contract (test_pallas_attention.py:30)
    q, k, v = _qkv(1, 1, 2, 16, 32, 8)
    bias = _t(_bias("zero", 16, 16))
    parts = [ba.attention_block(_t(q), _t(k[:, :, s:s + 16]),
                                _t(v[:, :, s:s + 16]), bias)
             for s in (0, 16)]
    ref = jra.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False)
    _close(ba.combine_blocks(parts), ref)


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(7)
    o1, o2 = (rng.standard_normal((1, 2, 6, 4)).astype(np.float32)
              for _ in range(2))
    m1, m2 = (rng.standard_normal((1, 2, 6)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.random((1, 2, 6)).astype(np.float32) for _ in range(2))
    m1[0, 0, :2] = -np.inf          # one side masked
    m1[0, 1, 0] = m2[0, 1, 0] = -np.inf   # both sides masked
    want = jra.merge_partials(*map(jnp.asarray, (o1, m1, l1, o2, m2, l2)))
    got = ra.merge_partials(*map(_t, (o1, m1, l1, o2, m2, l2)))
    for g, w in zip(got, want):
        assert np.array_equal(np.isneginf(g.numpy()),
                              np.isneginf(np.asarray(w)))
        _close(torch.nan_to_num(g, neginf=0.0), np.nan_to_num(w, neginf=0.0))


@pytest.mark.parametrize("q_idx,k_idx", [(0, 0), (1, 0), (0, 1), (2, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_block_bias_matches_jax(q_idx, k_idx, causal):
    want = np.asarray(jra._block_bias(q_idx, k_idx, 8, causal))
    got = ra._block_bias(q_idx, k_idx, 8, causal).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v = _qkv(9, 2, 2, 16, 16, 8)
    want = jra.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    _close(ra.reference_attention(_t(q), _t(k), _t(v), causal=causal), want)


def test_block_partials_matches_jax():
    q, k, v = _qkv(11, 1, 2, 12, 20, 8)
    bias = np.zeros((12, 20), np.float32)
    bias[:, 15:] = -np.inf
    want = jra.block_partials(*map(jnp.asarray, (q, k, v, bias)))
    got = ra.block_partials(*map(_t, (q, k, v, bias)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bad", ["bias_shape", "kv_shape", "rank"])
def test_attention_block_rejects_bad_shapes(bad):
    q, k, v = map(_t, _qkv(0, 1, 1, 8, 8, 4))
    bias = torch.zeros((8, 8))
    if bad == "bias_shape":
        bias = torch.zeros((8, 9))
    elif bad == "kv_shape":
        v = v[:, :, :4]
    else:
        q = q[0]
    with pytest.raises(ValueError):
        ba.attention_block(q, k, v, bias)


def test_cpu_path_is_not_a_kernel_launch():
    q, k, v = map(_t, _qkv(0, 1, 1, 8, 8, 4))
    before = ba.LAUNCHES["attn_block"]
    ba.attention_block(q, k, v, torch.zeros((8, 8)))
    assert ba.LAUNCHES["attn_block"] == before


def test_measure_runs_on_cpu():
    out = attention_bench.measure(b=1, h=2, s=16, d=8, inner=2, reads=1,
                                  device="cpu")
    assert out["ms_kernel"] > 0 and out["ms_plain"] > 0
    assert out["device"] == "cpu"
