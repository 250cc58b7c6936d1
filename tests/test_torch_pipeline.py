"""Port's GPipe pipeline over four gloo ranks vs the JAX pipeline on four
virtual CPU devices.

The cases mirror tests/test_workloads.py:162-201: the pipeline matches the
sequential stages, and the schedule runs n_micro + n_stages - 1 ticks. The
JAX side makes the weights and the input; `stage_params_from_numpy`
carries them across. Tolerance 1e-5, the JAX test's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from vtpu_manager.workloads import pipeline as jpp
from vtpu_manager_torch.workloads import pipeline as pp
from vtpu_manager_torch.workloads import ranks

TOL = 1e-5
N = 4


def pipeline_job(rank, path):
    """A `ranks` job: the pipeline on the weights and inputs in the npz at
    `path`, counting this rank's ticks (one stage_fn call each)."""
    group = dist.group.WORLD
    with np.load(path) as f:
        params = pp.stage_params_from_numpy(
            {"w1": f["w1"], "w2": f["w2"]}, device="cpu")
        xs = {k: torch.from_numpy(f[k]) for k in ("x", "x_bubble")}
    ticks = []
    plain = pp.stage_fn

    def counted(local, x):
        ticks.append(1)
        return plain(local, x)

    pp.stage_fn = counted
    forward = pp.make_pipeline_forward(group)
    local = pp.local_stage(params, group)
    out = {}
    for name, x in xs.items():
        ticks.clear()
        out[name] = forward(local, x).tolist()
        out[f"{name}_ticks"] = len(ticks)
    return out


@pytest.fixture(scope="module")
def mesh():
    devices = jax.devices()
    if len(devices) < N:
        pytest.skip(f"needs {N} devices")
    return Mesh(devices[:N], ("stage",))


@pytest.fixture(scope="module")
def case():
    params = jpp.stage_params(jax.random.PRNGKey(0), n_stages=N, width=16)
    x = jax.random.normal(jax.random.PRNGKey(1), (6, 3, 16))
    x_bubble = jax.random.normal(jax.random.PRNGKey(2), (5, 2, 16))
    return params, x, x_bubble


@pytest.fixture(scope="module")
def port(case, tmp_path_factory):
    params, x, x_bubble = case
    path = str(tmp_path_factory.mktemp("pipeline") / "inputs.npz")
    np.savez(path, w1=np.asarray(params["w1"]), w2=np.asarray(params["w2"]),
             x=np.asarray(x), x_bubble=np.asarray(x_bubble))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(__file__))
    return ranks.launch("test_torch_pipeline:pipeline_job", N, device="cpu",
                        env=env, args={"path": path}, timeout=240)


def test_matches_sequential_reference(mesh, case, port):
    params, x, _ = case
    want = jpp.make_pipeline_forward(mesh)(
        jax.device_put(params, jpp.param_shardings(mesh)), x)
    ref = jax.vmap(lambda m: jpp.reference_forward(params, m))(x)
    for rank in port:          # every rank returns the whole output
        got = np.asarray(rank["x"], np.float32)
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=TOL)


def test_bubble_schedule_tick_count(mesh, case, port):
    """5 microbatches through 4 stages: 5 + 4 - 1 = 8 ticks on every rank,
    the length of the JAX scan."""
    params, _, x_bubble = case
    jaxpr = jax.make_jaxpr(
        lambda p, m: jpp.make_pipeline_forward(mesh)(p, m))(
            jax.device_put(params, jpp.param_shardings(mesh)),
            jnp.zeros(x_bubble.shape))
    assert "length=8" in str(jaxpr)
    assert [r["x_bubble_ticks"] for r in port] == [8] * N
    ref = jax.vmap(lambda m: jpp.reference_forward(params, m))(x_bubble)
    np.testing.assert_allclose(np.asarray(port[0]["x_bubble"], np.float32),
                               np.asarray(ref), atol=TOL, rtol=TOL)


def test_reference_forward_matches_jax(case):
    params, x, _ = case
    tp = pp.stage_params_from_numpy(jax.tree.map(np.asarray, params),
                                    device="cpu")
    got = pp.reference_forward(tp, torch.from_numpy(np.array(x[0])))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpp.reference_forward(params, x[0])),
                               atol=TOL, rtol=TOL)


def test_one_stage_is_the_stage_fn(case):
    params, x, _ = case
    tp = pp.stage_params_from_numpy(jax.tree.map(np.asarray, params),
                                    device="cpu")
    one = {k: v[0] for k, v in tp.items()}
    got = pp.stage_fn(one, torch.from_numpy(np.array(x[0])))
    want = jpp.stage_fn(jax.tree.map(lambda p: p[0], params), x[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_weights_of_the_wrong_shape_are_refused():
    with pytest.raises(ValueError):
        pp.stage_params_from_numpy({"w1": np.zeros((2, 4, 4), np.float32),
                                    "w2": np.zeros((3, 4, 4), np.float32)},
                                   device="cpu")
