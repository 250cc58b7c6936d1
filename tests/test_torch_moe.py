"""Port's expert-parallel MoE over four gloo ranks vs the JAX layer on four
virtual CPU devices.

The cases mirror tests/test_workloads.py:203-243: no drops, and capacity
drops equal to the reference's (per token-shard capacity). The JAX side
makes the weights and the tokens; `moe_params_from_numpy` carries them
across. Tolerance 1e-5, the JAX test's.

Top-1 routing takes the first maximum of a softmax on both sides. A near
tie could flip where the two softmaxes differ in the last bit; the inputs
here have no such tie: every token's two largest gates lie at least 1e-3
apart (`test_no_routing_tie_within_the_margin`), some hundreds of float32
ulps, so a difference in routing would be a real one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from vtpu_manager.workloads import moe as jmoe
from vtpu_manager_torch.workloads import moe
from vtpu_manager_torch.workloads import ranks

TOL = 1e-5
N = 4
TOKENS, EXPERTS = 32, 8
CAPACITIES = (8, 1)           # no drops; drops
MARGIN = 1e-3


def moe_job(rank, path):
    """A `ranks` job: this rank's tokens through the layer at each
    capacity, with the weights and tokens in the npz at `path`."""
    group = dist.group.WORLD
    with np.load(path) as f:
        params = moe.moe_params_from_numpy(
            {k: f[k] for k in ("router", "w1", "w2")}, device="cpu")
        x = torch.from_numpy(f["x"])
    t_per = x.shape[0] // rank.world
    mine = x[rank.rank * t_per:(rank.rank + 1) * t_per]
    local = moe.local_experts(params, group)
    return {str(cap): moe.make_moe_forward(group, capacity=cap)(
        local, mine).tolist() for cap in CAPACITIES}


@pytest.fixture(scope="module")
def case():
    devices = jax.devices()
    if len(devices) < N:
        pytest.skip(f"needs {N} devices")
    mesh = Mesh(devices[:N], ("expert",))
    params = jmoe.moe_params(jax.random.PRNGKey(0), EXPERTS, width=16,
                             hidden=32)
    x = jax.random.normal(jax.random.PRNGKey(1), (TOKENS, 16))
    return mesh, params, x


@pytest.fixture(scope="module")
def port(case, tmp_path_factory):
    _, params, x = case
    path = str(tmp_path_factory.mktemp("moe") / "inputs.npz")
    np.savez(path, x=np.asarray(x),
             **{k: np.asarray(v) for k, v in params.items()})
    env = dict(os.environ, PYTHONPATH=os.path.dirname(__file__))
    records = ranks.launch("test_torch_moe:moe_job", N, device="cpu",
                           env=env, args={"path": path}, timeout=240)
    return {cap: np.concatenate([np.asarray(r[str(cap)], np.float32)
                                 for r in records]) for cap in CAPACITIES}


def _torch_params(params):
    return moe.moe_params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")


def test_no_routing_tie_within_the_margin(case):
    _, params, x = case
    gates = np.asarray(jax.nn.softmax(x @ params["router"], axis=-1))
    top2 = np.sort(gates, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


@pytest.mark.parametrize("capacity", CAPACITIES, ids=["no_drops", "drops"])
def test_sharded_matches_jax_and_reference(case, port, capacity):
    mesh, params, x = case
    want = jmoe.make_moe_forward(mesh, capacity=capacity)(
        jax.device_put(params, jmoe.param_shardings(mesh)), x)
    ref = jmoe.reference_moe_per_shard(params, x, capacity, N)
    np.testing.assert_allclose(port[capacity], np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(port[capacity], ref, atol=TOL, rtol=TOL)


def test_capacity_drops_match_reference(case, port):
    """Overflow tokens are dropped in the same rows (combine weight 0) as
    the dense reference's, so drops really happened."""
    _, params, x = case
    ref = jmoe.reference_moe_per_shard(params, x, 1, N)
    dropped = np.abs(ref).sum(axis=1) == 0
    assert dropped.any()
    np.testing.assert_array_equal(np.abs(port[1]).sum(axis=1) == 0, dropped)


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_routing_matches_jax(case, capacity):
    """dispatch and combine, their dtypes and the capacity cut, as the
    JAX `_routing` makes them."""
    _, params, x = case
    jd, jc = jmoe._routing(x, params["router"], capacity)
    td, tc = moe._routing(torch.from_numpy(np.array(x)),
                          _torch_params(params)["router"], capacity)
    assert td.dtype == torch.float32 and jd.dtype == jnp.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL,
                               rtol=TOL)


def test_dense_reference_matches_jax(case):
    _, params, x = case
    got = moe.reference_moe_per_shard(_torch_params(params),
                                      torch.from_numpy(np.array(x)), 2, N)
    want = jmoe.reference_moe_per_shard(params, x, 2, N)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_mismatched_expert_counts_are_refused():
    with pytest.raises(ValueError):
        moe.moe_params_from_numpy(
            {"router": np.zeros((4, 3), np.float32),
             "w1": np.zeros((2, 4, 8), np.float32),
             "w2": np.zeros((2, 8, 4), np.float32)}, device="cpu")
