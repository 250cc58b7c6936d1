"""Port's ring attention over four gloo ranks vs the JAX ring on four
virtual CPU devices.

The cases mirror tests/test_ring_attention.py:29-66: causal, non-causal,
the sequence stays sharded, gradients through the ring, and the kernel's
block path (its plain version here, the Pallas kernel in interpret mode on
the JAX side). The same numpy inputs go to both; one launch of four rank
processes computes every case, each rank on its own sequence shard, and
writes its outputs for the tests to join. Tolerance 2e-5, the JAX test's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from vtpu_manager.workloads import pallas_attention as jpa
from vtpu_manager.workloads import ring_attention as jra
from vtpu_manager_torch.workloads import block_attention as ba
from vtpu_manager_torch.workloads import ranks
from vtpu_manager_torch.workloads import ring_attention as ra

TOL = 2e-5
N = 4
SHAPE = (2, 2, 32, 8)
GRAD_SHAPE = (2, 2, 16, 8)      # the JAX test's gradient case: s=16


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def ring_job(rank, path):
    """A `ranks` job: every case on this rank's shards of the inputs in
    the npz at `path`; the outputs go to out<rank>.npz beside it."""
    group = dist.group.WORLD
    me, n = rank.rank, rank.world
    with np.load(path) as f:
        inputs = {k: torch.from_numpy(f[k]) for k in f.files}

    def shards(prefix):
        return [ra.sequence_shard(inputs[f"{prefix}_{x}"], me, n)
                for x in "qkv"]

    out = {}
    for name, causal in (("causal", True), ("non_causal", False)):
        out[name] = ra.make_ring_attention(group, causal=causal)(
            *shards(name))
    ba.reset_launches()
    out["kernel_path"] = ra.make_ring_attention(group, causal=True,
                                                use_pallas=True)(
        *shards("kernel_path"))
    q, k, v = (t.requires_grad_() for t in shards("grad"))
    ring = ra.make_ring_attention(group, causal=True)
    ring(q, k, v).square().sum().backward()
    out.update(grad_q=q.grad, grad_k=k.grad, grad_v=v.grad)
    np.savez(os.path.join(os.path.dirname(path), f"out{me}.npz"),
             **{k: t.detach().numpy() for k, t in out.items()})
    return {"launches": ba.LAUNCHES["attn_block"]}


@pytest.fixture(scope="module")
def mesh():
    devices = jax.devices()
    if len(devices) < N:
        pytest.skip(f"needs >={N} virtual devices")
    return Mesh(np.asarray(devices[:N]), ("data",))


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for seed, name in enumerate(("causal", "non_causal", "kernel_path")):
        out.update(zip((f"{name}_{x}" for x in "qkv"), _qkv(seed, SHAPE)))
    out.update(zip(("grad_q", "grad_k", "grad_v"), _qkv(3, GRAD_SHAPE)))
    return out


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """Each output joined from the four ranks' shards, and each rank's
    record."""
    d = tmp_path_factory.mktemp("ring")
    path = str(d / "inputs.npz")
    np.savez(path, **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(__file__))
    records = ranks.launch("test_torch_ring_attention:ring_job", N,
                           device="cpu", env=env, args={"path": path},
                           timeout=240)
    shards = [np.load(d / f"out{r}.npz") for r in range(N)]
    joined = {k: np.concatenate([s[k] for s in shards], axis=2)
              for k in shards[0].files}
    joined["shard_shapes"] = [s["causal"].shape for s in shards]
    return joined, records


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "non_causal"])
def test_ring_matches_jax(mesh, inputs, port, causal):
    name = "causal" if causal else "non_causal"
    q, k, v = (inputs[f"{name}_{x}"] for x in "qkv")
    jax_out = jra.make_ring_attention(mesh, causal=causal)(q, k, v)
    _close(port[0][name], jax_out)
    _close(port[0][name], jra.reference_attention(q, k, v, causal=causal))


def test_sequence_stays_sharded(port):
    # each rank returns only its own quarter of the sequence
    assert port[0]["shard_shapes"] == [(2, 2, SHAPE[2] // N, 8)] * N


def test_gradients_flow_through_the_ring(mesh, inputs, port):
    q, k, v = (inputs[f"grad_{x}"] for x in "qkv")
    ring = jra.make_ring_attention(mesh, causal=True)

    def loss(q, k, v):
        return jnp.sum(jnp.square(ring(q, k, v)))

    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for x, want in zip("qkv", grads):
        got = port[0][f"grad_{x}"]
        assert np.isfinite(got).all() and np.abs(got).sum() > 0
        _close(got, want)


def test_kernel_block_path_matches(mesh, inputs, port):
    if not jpa.HAVE_PALLAS:
        pytest.skip("pallas unavailable")
    q, k, v = (inputs[f"kernel_path_{x}"] for x in "qkv")
    jax_out = jra.make_ring_attention(mesh, causal=True, use_pallas=True)(
        q, k, v)
    _close(port[0]["kernel_path"], jax_out)
    # CPU tensors take the kernel's plain version: no launch
    assert [r["launches"] for r in port[1]] == [0] * N
