"""Port's trainer vs the JAX trainer, from the same weights.

The JAX side makes the weights and the batch once; `params_from_numpy`
carries them across bit for bit (bf16 viewed as uint16). With the weights
cast to fp32 the two sides share every rounding but the bf16 cast of the
attention probabilities, so logits agree to 2e-3; with bf16 weights the
matmuls round in different places, and they agree to 5e-2, the tolerance
tests/test_workloads.py:70 gives bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtpu_manager.workloads import trainer as jt
from vtpu_manager_torch import graft_entry
from vtpu_manager_torch.util.torchplatform import cap_cpu_threads
from vtpu_manager_torch.workloads import trainer as tt


@pytest.fixture(autouse=True, scope="module")
def _threads():
    cap_cpu_threads()


@pytest.fixture(scope="module")
def cfg():
    return jt.model_config(vocab=64, d_model=32, d_ff=64, n_layers=2,
                           n_heads=2, seq_len=16)


@pytest.fixture(scope="module")
def jax_side(cfg):
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    batch = jt.make_batch(jax.random.PRNGKey(1), cfg, batch_size=4)
    return params, batch


def _batch(batch):
    return {n: torch.from_numpy(np.asarray(a).astype(np.int64))
            for n, a in batch.items()}


def _fp32(params):
    return jax.tree.map(lambda a: a.astype(jnp.float32), params)


def _numpy(params):
    return jax.tree.map(np.asarray, params)


def _port_numpy(model):
    def arr(t):
        return t.detach().float().numpy()
    return {"embed": arr(model.embed), "pos": arr(model.pos),
            "layers": {n: arr(getattr(model.layers, n))
                       for n in ("wqkv", "wo", "w1", "w2")},
            "unembed": arr(model.unembed)}


def test_params_cross_bit_exact(cfg, jax_side):
    params, _ = jax_side
    model = tt.params_from_numpy(_numpy(params), cfg, device="cpu")
    assert model.layers.wqkv.dtype == torch.bfloat16
    assert tuple(model.layers.wqkv.shape) == (2, 32, 96)
    want = np.asarray(params["layers"]["wqkv"]).view(np.uint16)
    got = model.layers.wqkv.detach().view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_params_shape_mismatch_raises(cfg, jax_side):
    tree = _numpy(jax_side[0])
    tree["unembed"] = tree["unembed"][:, :10]
    with pytest.raises(ValueError):
        tt.params_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("dtype,tol", [("fp32", 2e-3), ("bf16", 5e-2)])
def test_forward_and_loss_match_jax(cfg, jax_side, dtype, tol):
    params, batch = jax_side
    if dtype == "fp32":
        params = _fp32(params)
    model = tt.params_from_numpy(_numpy(params), cfg, device="cpu")
    tb = _batch(batch)
    want = np.asarray(jt.forward(params, batch["tokens"], cfg),
                      dtype=np.float32)
    with torch.no_grad():
        got = tt.forward(model, tb["tokens"]).float().numpy()
        loss = float(tt.loss_fn(model, tb))
    assert got.shape == (4, cfg["seq_len"], cfg["vocab"])
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert abs(loss - float(jt.loss_fn(params, batch, cfg))) < tol


@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-5), ("bf16", 4e-3)])
def test_sgd_step_matches_jax(cfg, jax_side, dtype, tol):
    # bf16: one ulp of a weight near 0.5 is 2^-9 ~ 2e-3
    params, batch = jax_side
    if dtype == "fp32":
        params = _fp32(params)
    model = tt.params_from_numpy(_numpy(params), cfg, device="cpu")
    want, want_loss = jt.sgd_train_step(params, batch, cfg)
    model, loss = tt.sgd_train_step(model, _batch(batch))
    got = _port_numpy(model)
    for name in ("embed", "pos", "unembed"):
        np.testing.assert_allclose(got[name], np.asarray(
            want[name], np.float32), atol=tol, rtol=0)
    for name in ("wqkv", "wo", "w1", "w2"):
        np.testing.assert_allclose(got["layers"][name], np.asarray(
            want["layers"][name], np.float32), atol=tol, rtol=0)
    assert abs(float(loss) - float(want_loss)) < max(tol, 1e-4) * 10
    assert next(model.parameters()).dtype == (
        torch.float32 if dtype == "fp32" else torch.bfloat16)


def test_loss_decreases(cfg):
    # tests/test_workloads.py:25 — 8 steps at lr 0.05
    model = tt.init_params(cfg, seed=0, device="cpu")
    batch = tt.make_batch(cfg, batch_size=4, seed=1, device="cpu")
    step = functools.partial(tt.sgd_train_step, lr=0.05)
    losses = [float(step(model, batch)[1]) for _ in range(8)]
    assert losses[-1] < losses[0]


def test_make_batch_targets_roll(cfg):
    batch = tt.make_batch(cfg, batch_size=3, seed=4, device="cpu")
    assert batch["tokens"].shape == (3, cfg["seq_len"])
    assert int(batch["tokens"].max()) < cfg["vocab"]
    assert torch.equal(batch["targets"], torch.roll(batch["tokens"], -1, 1))


def test_init_params_is_seeded(cfg):
    a = tt.init_params(cfg, seed=3, device="cpu")
    b = tt.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))


def test_graft_entry_gives_finite_loss():
    fn, args = graft_entry.entry(device="cpu")
    with torch.no_grad():
        loss = fn(*args)
    assert torch.isfinite(loss)
    assert args[1]["tokens"].shape == (4, 32)


def test_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError):
        tt.make_batch(tt.model_config(), batch_size=1)
