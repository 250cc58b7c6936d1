"""Port's dp x tp train step over four gloo ranks vs the JAX sharded step
on four virtual CPU devices.

The cases mirror tests/test_workloads.py:38-71: the sharded step runs, the
weights stay sharded as declared, and the loss matches one device within
the JAX test's bf16 bound (5e-2). The JAX side makes the weights and the
batch; `sharded_params_from_numpy` keeps each rank's slices by the JAX
sharding table.

The step does its collectives itself (`trainer.py`'s docstring), so the
test also holds its gradients to JAX's: with the weights in float32, every
rank's gradient slice, joined by the table, against `jax.grad` of one
device's loss. The two sides then share every rounding but the bf16 cast
of the attention probabilities, which a last-bit difference in a score can
move by one bf16 ulp (2^-8 relative): hence 2e-3 of each element plus 2e-3
of the leaf's largest gradient. The test shows that this bound refuses,
for every leaf, a doubled reduction and a missing one over "data" (one
data rank's own gradient, summed or averaged).

And it holds the update itself to JAX's: the 2 x 2 ranks' new slices,
joined, against the weights the JAX sharded step returns. In float32 the
update (new - old) is lr times the gradient, held by the gradients'
bound: a skipped update, a flipped sign or a wrong lr fails it. In bf16,
the trainer's dtype, within one bf16 ulp of each weight plus lr times
four bf16 ulps (2^-6) of the leaf's largest gradient: both sides round
p - lr g to bf16, and the bf16 backward pass sums partial gradients in
bf16, so an element's gradient may differ by a few ulps of the terms it
sums, which can be far larger than the element where they cancel. In
every leaf the step moves some weights past that bound, so a skipped
update or a flipped sign fails there too.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from vtpu_manager.workloads import trainer as jt
from vtpu_manager_torch.workloads import ranks
from vtpu_manager_torch.workloads import trainer as tt

N = 4
MESHES = ((2, 2), (4, 1), (1, 4))
GRAD_TOL = 2e-3
LR = 1e-2                   # both steps' default
CONFIG = dict(vocab=64, d_model=32, d_ff=64, n_layers=2, n_heads=2,
              seq_len=16)
NAMES = ("embed", "pos", "layers.wqkv", "layers.wo", "layers.w1",
         "layers.w2", "unembed")


def _tree(flat: dict) -> dict:
    tree = {"layers": {}}
    for key, a in flat.items():
        if key.startswith("layers."):
            tree["layers"][key.split(".", 1)[1]] = a
        else:
            tree[key] = a
    return tree


def _flat(tree: dict) -> dict:
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers.{k}": v for k, v in tree["layers"].items()})
    return out


def step_job(rank, path):
    """A `ranks` job: one bf16 step on each mesh, and the float32
    gradients on the 2 x 2 mesh, from the full weights and batch in the
    npz at `path`; the slices go to out<rank>.npz beside it."""
    cfg = tt.model_config(**CONFIG)
    with np.load(path) as f:
        flat = {k: f[k] for k in NAMES}
        batch = {k: torch.from_numpy(f[k]) for k in ("tokens", "targets")}
    out, save = {}, {}
    for data, model in MESHES:
        mesh = tt.make_mesh("cpu", data=data, model=model)
        params = tt.sharded_params_from_numpy(_tree(flat), cfg, mesh,
                                              device="cpu")
        params = params.to(torch.bfloat16)
        params, loss = tt.make_sharded_train_step(mesh)(
            params, tt.shard_batch(batch, mesh))
        out[f"{data}x{model}"] = {
            "loss": float(loss),
            "shapes": {n: list(p.shape) for n, p in params.named_parameters()}}
        if (data, model) == (2, 2):
            save.update({f"new.{n}": p.detach().float().numpy()
                         for n, p in params.named_parameters()})
            fp32 = tt.sharded_params_from_numpy(_tree(flat), cfg, mesh,
                                                device="cpu")
            loss32, grads = tt.sharded_loss_and_grads(
                fp32, tt.shard_batch(batch, mesh), mesh)
            out["loss32"] = float(loss32)
            save.update({f"grad.{n}": g.numpy() for n, g in grads.items()})
            fp32, _ = tt.make_sharded_train_step(mesh)(
                fp32, tt.shard_batch(batch, mesh))
            save.update({f"new32.{n}": p.detach().numpy()
                         for n, p in fp32.named_parameters()})
    np.savez(os.path.join(os.path.dirname(path), f"out{rank.rank}.npz"),
             **save)
    return out


def _join(slices: list[np.ndarray], name: str, data: int, model: int):
    """The full tensor from the ranks' slices (rank = d * model + m), by
    the port's table: data rank 0's model slices, joined on the split
    dim."""
    spec = tt.param_shardings()
    spec = spec["layers"][name.split(".")[1]] if "." in name else spec[name]
    if not isinstance(spec[1], Shard):
        return slices[0]
    return np.concatenate(slices[:model], axis=spec[1].dim)


@pytest.fixture(scope="module")
def cfg():
    return jt.model_config(**CONFIG)


@pytest.fixture(scope="module")
def jax_side(cfg):
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    batch = jt.make_batch(jax.random.PRNGKey(1), cfg, batch_size=4)
    return params, batch


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    params, batch = jax_side
    d = tmp_path_factory.mktemp("sharded")
    path = str(d / "inputs.npz")
    # bf16 values as float32 hold them exactly; the job casts them back
    np.savez(path, **{k: np.asarray(v, np.float32)
                      for k, v in _flat(params).items()},
             **{k: np.asarray(v).astype(np.int64) for k, v in batch.items()})
    env = dict(os.environ, PYTHONPATH=os.path.dirname(__file__))
    records = ranks.launch("test_torch_sharded_trainer:step_job", N,
                           device="cpu", env=env, args={"path": path},
                           timeout=300)
    slices = [dict(np.load(d / f"out{r}.npz")) for r in range(N)]
    return records, slices


def test_mesh_default_split_is_the_jax_one():
    # model 2 when the world is even and above 1, as trainer.py:166
    devices = jax.devices()
    if len(devices) < N:
        pytest.skip(f"needs >={N} virtual devices")
    assert dict(jt.make_mesh(devices[:N]).shape) == {"data": 2, "model": 2}
    records = ranks.launch("test_torch_sharded_trainer:mesh_job", N,
                           device="cpu",
                           env=dict(os.environ,
                                    PYTHONPATH=os.path.dirname(__file__)))
    assert [r["shape"] for r in records] == [[2, 2]] * N


def mesh_job(rank):
    mesh = tt.make_mesh("cpu")
    return {"shape": [mesh.size(0), mesh.size(1)]}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_step_runs_and_matches_one_device(cfg, jax_side, port, mesh):
    params, batch = jax_side
    ref_loss = float(jt.loss_fn(params, batch, cfg))
    losses = [r[f"{mesh[0]}x{mesh[1]}"]["loss"] for r in port[0]]
    assert len(set(losses)) == 1, losses        # every rank the same loss
    assert np.isfinite(losses[0])
    assert abs(losses[0] - ref_loss) < 5e-2     # bf16 tolerance


@pytest.fixture(scope="module")
def jax_steps(cfg, jax_side):
    """{dtype: (new weights, flat, as float32; loss)} of the JAX sharded
    step on a 2 x 2 mesh of virtual devices, from the bf16 weights and
    from them in float32."""
    params, batch = jax_side
    devices = jax.devices()
    if len(devices) < N:
        pytest.skip(f"needs >={N} virtual devices")
    mesh = jt.make_mesh(devices[:N])
    step = jt.make_sharded_train_step(mesh, cfg)
    out = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        # the step donates its weights: hand it copies
        new, loss = step(jax.device_put(
            jax.tree.map(lambda a: jnp.copy(a).astype(dtype), params),
            jt.param_shardings(mesh)),
            jax.device_put(batch, jt.batch_sharding(mesh)))
        out[dtype] = ({k: np.asarray(v, np.float32)
                       for k, v in _flat(new).items()}, float(loss))
    return out


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at each of x."""
    a = np.abs(x.astype(np.float64))
    tiny = np.finfo(np.float32).tiny
    return 2.0 ** (np.floor(np.log2(np.maximum(a, tiny))) - 7)


def test_sharded_loss_matches_the_jax_sharded_step(port, jax_steps):
    assert abs(port[0][0]["2x2"]["loss"] - jax_steps[jnp.bfloat16][1]) < 5e-2


def _update(jax_side, jax_steps, port, name, dtype, key):
    """(old, the JAX step's new weights, the port's, joined) of a leaf."""
    old = np.asarray(_flat(jax_side[0])[name], np.float32)
    got = _join([s[f"{key}.{name}"] for s in port[1]], name, 2, 2)
    return old, jax_steps[dtype][0][name], got


@pytest.mark.parametrize("name", NAMES)
def test_sharded_update_matches_the_jax_sharded_step(jax_side, port,
                                                     jax_steps, jax_grads,
                                                     name):
    old, want, got = _update(jax_side, jax_steps, port, name, jnp.bfloat16,
                             "new")
    largest = float(np.abs(jax_grads[1][name]).max())
    bound = bf16_ulp(want) + LR * 2.0 ** -6 * largest
    off = np.abs(got - want) > bound
    assert not off.any(), (name, int(off.sum()),
                           float(np.abs(got - want).max()))
    # the yardstick sees the update: weights it moved past the bound
    assert (np.abs(want - old) > bound).mean() > 0.01, name


@pytest.mark.parametrize("name", NAMES)
def test_fp32_update_is_lr_times_the_jax_gradient(jax_side, port, jax_steps,
                                                  name):
    old, want, got = _update(jax_side, jax_steps, port, name, jnp.float32,
                             "new32")
    assert _grad_close(got - old, want - old), (
        name, float(np.abs(want - old).max()),
        float(np.abs(got - want).max()))
    for wrong in (old, old - (want - old), old + 2 * (want - old)):
        assert not _grad_close(wrong - old, want - old), name


def _grad_close(got: np.ndarray, want: np.ndarray) -> bool:
    """Within GRAD_TOL of each element plus GRAD_TOL of the leaf's
    largest gradient."""
    atol = GRAD_TOL * float(np.abs(want).max())
    return bool(np.allclose(got, want, atol=atol, rtol=GRAD_TOL))


@pytest.fixture(scope="module")
def jax_grads(cfg, jax_side):
    """(loss, flat gradients) of one device's float32 loss, and the flat
    gradients of data rank 0's rows alone (the batch's first half)."""
    params, batch = jax_side
    fp32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    loss, grads = jax.value_and_grad(jt.loss_fn)(fp32, batch, cfg)
    half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    local = jax.grad(jt.loss_fn)(fp32, half, cfg)
    flat = lambda t: {k: np.asarray(v) for k, v in _flat(t).items()}
    return float(loss), flat(grads), flat(local)


def test_gradients_match_jax(port, jax_grads):
    loss, want, _ = jax_grads
    assert abs(port[0][0]["loss32"] - loss) < 1e-4
    for name in NAMES:
        got = _join([s[f"grad.{name}"] for s in port[1]], name, 2, 2)
        assert _grad_close(got, want[name]), (
            name, float(np.abs(want[name]).max()),
            float(np.abs(got - want[name]).max()))


@pytest.mark.parametrize("name", NAMES)
def test_gradient_bound_refuses_a_wrong_reduction(jax_grads, name):
    # a reduction done twice, and one missing over "data": one data rank's
    # own gradient, as the sum or as the mean of the two ranks
    _, want, local = jax_grads
    for wrong in (2 * want[name], local[name], local[name] / 2):
        assert not _grad_close(wrong, want[name]), name


def test_replicas_agree_after_the_step(port):
    # a slice is the same on the two data ranks that hold it, and the
    # replicated weights the same on all four
    slices = port[1]
    for name in NAMES:
        key = f"new.{name}"
        np.testing.assert_array_equal(slices[0][key], slices[2][key])
        np.testing.assert_array_equal(slices[1][key], slices[3][key])
    for name in ("embed", "pos"):
        for s in slices[1:]:
            np.testing.assert_array_equal(s[f"new.{name}"],
                                          slices[0][f"new.{name}"])


def test_local_shard_refuses_a_split_that_does_not_divide():
    class Mesh:
        def size(self, dim):
            return 3

        def get_local_rank(self, dim):
            return 0

    with pytest.raises(ValueError):
        tt.local_shard(torch.zeros(4, 4), (Shard(0),), Mesh())
