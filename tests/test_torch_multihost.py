"""The port's multi-process data-parallel check on gloo ranks, against one
process and against the JAX step.

Mirrors tests/test_multihost.py:70-97: real processes of
`python -m vtpu_manager_torch.workloads.multihost`, each feeding its shard
of one global batch into the dp step; every rank must report the same loss
and updated embedding as a one-process control, and its ring shard must
match the dense reference. The JAX side makes the weights, which go to
every rank through `--params`; its single-process step is held to the
port's within the bf16 bound (5e-2). The ranks meet through a `file://`
store in the test's own directory, never a port.

Two ranks and the control agree to the printed digits: the batch rows
never meet before the loss, and the gradients are averaged in float32
(rel 1e-5, as the JAX test holds them). The updated weights, which every
rank writes (`--out`), are held element by element: the two ranks' the
same, and the pair's against the control's and against the JAX step's
within one bf16 ulp plus lr times four bf16 ulps of the leaf's largest
gradient (the bound of `test_torch_sharded_trainer.py`, which says why),
a bound the step's update passes in every leaf.
"""

import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vtpu_manager.workloads import trainer as jt
from vtpu_manager_torch.workloads import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180


def _start(world: int, store: str, params: str) -> list:
    env = dict(os.environ, PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, "-m", "vtpu_manager_torch.workloads.multihost",
         "--rank", str(rank), "--world", str(world), "--store", store,
         "--device", "cpu", "--params", params,
         "--out", f"{store}.new{rank}.npz"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]


def _collect(procs: list) -> list[tuple[float, float]]:
    """A dead rank leaves its peers blocked in a collective: the whole
    world is killed on any failure."""
    results = []
    try:
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, f"rank {rank} failed:\n{out[-2000:]}"
            m = re.search(rf"RANK {rank} loss=([\d.]+) leaf=(-?[\d.]+)", out)
            assert m, f"rank {rank} printed no result:\n{out[-1000:]}"
            assert f"RANK {rank} ring=OK" in out, out[-1000:]
            results.append((float(m.group(1)), float(m.group(2))))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    return results


@pytest.fixture(scope="module")
def jax_params():
    cfg = jt.model_config(**multihost.CONFIG)
    return cfg, jt.init_params(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def params_file(jax_params, tmp_path_factory):
    _, params = jax_params
    path = tmp_path_factory.mktemp("multihost") / "params.npz"
    flat = {k: v for k, v in params.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in params["layers"].items()})
    # bf16 values as float32 hold them exactly
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    return str(path)


def _run(world, tmp_path, params_file):
    return _start(world, str(tmp_path / f"store{world}"), params_file)


def _new_weights(world, tmp_path, rank) -> dict:
    with np.load(tmp_path / f"store{world}.new{rank}.npz") as f:
        return dict(f)


def _flat(tree: dict) -> dict:
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers.{k}": v for k, v in tree["layers"].items()})
    return out


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.abs(x.astype(np.float64))
    return 2.0 ** (np.floor(np.log2(np.maximum(
        a, np.finfo(np.float32).tiny))) - 7)


def test_two_process_dp_step_matches_single_process(tmp_path, params_file,
                                                    jax_params):
    pair = _run(2, tmp_path, params_file)
    control = _run(1, tmp_path, params_file)
    two = _collect(pair)
    one = _collect(control)
    # every rank saw the same globally reduced loss...
    assert two[0] == two[1], two
    # ...and it equals one process's: the gradient average crossed the
    # process boundary
    assert two[0] == pytest.approx(one[0], rel=1e-5), (two, one)
    # the JAX step on the same weights and batch
    cfg, params = jax_params
    seq = multihost.SEQ
    tokens = jnp.asarray(np.arange(multihost.GLOBAL_BATCH * seq,
                                   dtype=np.int32).reshape(-1, seq)
                         % cfg["vocab"])
    batch = {"tokens": tokens, "targets": jnp.roll(tokens, -1, axis=1)}
    new, loss = jt.sgd_train_step(params, batch, cfg)
    assert abs(two[0][0] - float(loss)) < 5e-2
    leaf = float(jnp.asarray(new["embed"], jnp.float32).sum())
    assert abs(two[0][1] - leaf) < 5e-2
    # the updated weights, element by element
    ranks_new = [_new_weights(2, tmp_path, r) for r in range(2)]
    control = _new_weights(1, tmp_path, 0)
    grads = _flat(jax.grad(jt.loss_fn)(
        jax.tree.map(lambda a: a.astype(jnp.float32), params), batch, cfg))
    old, new = _flat(params), _flat(new)
    for name, want in new.items():
        want = np.asarray(want, np.float32)
        got = ranks_new[0][name]
        np.testing.assert_array_equal(ranks_new[1][name], got, err_msg=name)
        bound = (_bf16_ulp(want)
                 + 1e-2 * 2.0 ** -6 * float(np.abs(grads[name]).max()))
        assert (np.abs(got - control[name]) <= bound).all(), name
        assert (np.abs(got - want) <= bound).all(), name
        # the step moved weights past the bound: a lost update shows
        moved = np.abs(want - np.asarray(old[name], np.float32)) > bound
        assert moved.mean() > 0.01, name


def test_four_process_world_multi_hop_ring(tmp_path, params_file):
    """World 4: the gradient average spans four processes and the ring's
    K/V blocks travel three hops (rank i's block visits i+1, i+2, i+3), a
    relay a two-process ring never takes. Under 30 s here, so not gated as
    the JAX test is."""
    t0 = time.monotonic()
    quad = _run(4, tmp_path, params_file)
    control = _run(1, tmp_path, params_file)
    four = _collect(quad)
    one = _collect(control)
    assert len(four) == 4
    assert len(set(four)) == 1, four          # every rank agrees exactly
    assert four[0] == pytest.approx(one[0], rel=1e-5), (four, one)
    assert time.monotonic() - t0 < TIMEOUT
