"""Flagship tenant workload: a small transformer-LM trainer, on one device
or over a ("data", "model") mesh of ranks.

Ports `vtpu_manager/workloads/trainer.py` whole: the config, the
stacked-layer weights, the forward pass (the JAX `lax.scan` over the layer
axis becomes a loop), the loss, the plain-autograd SGD step and the batch
(`:25-119`), and the dp x tp step over a ("data", "model") mesh
(`:126-175`). The weights keep the JAX layout (`wqkv` [L, d, 3d],
attention [B, H, S, D]) so `params_from_numpy` carries a JAX parameter
tree across bit for bit. Three numeric details follow the JAX code: the
attention scale is the sqrt of a bf16 head dim, the probabilities are cast
to bf16 before the product with v, and gelu is the tanh approximation.

The sharded step keeps the JAX sharding table (`param_shardings`, written
in DTensor's placements over the `DeviceMesh`): `wqkv`, `w1` and `unembed`
split on their last dimension over "model", `wo` and `w2` on their middle
one, the embeddings replicated, the batch over "data". Each rank holds its
slices as plain tensors and the step does the collectives XLA inserts for
that table itself, each an `all_reduce` that carries a gradient
(`collectives.AllReduce`): a column-parallel product's slices gathered
(`wqkv`'s split is not aligned to heads, so every model rank attends over
all heads, as the sharded JAX program computes the same logical
attention), a row-parallel product's partial sums added, and the
gradients averaged over "data". DTensor's own sharding propagation is not
used: with the weights as DTensors, torch 2.11 (the card's) refuses a
reshape of a sharded activation in this step without a redistribution
("Attempted to flatten multiple dimensions, with dimension 1 being
sharded"), though torch 2.13 runs it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from vtpu_manager_torch.util.torchplatform import resolve_device
from vtpu_manager_torch.workloads.collectives import (AllReduce, all_reduce,
                                                      block)


def model_config(vocab: int = 256, d_model: int = 128, d_ff: int = 512,
                 n_layers: int = 2, n_heads: int = 4,
                 seq_len: int = 64) -> dict:
    if d_model % n_heads:
        raise ValueError("d_model must divide into n_heads")
    return dict(vocab=vocab, d_model=d_model, d_ff=d_ff, n_layers=n_layers,
                n_heads=n_heads, seq_len=seq_len)


class Layers(nn.Module):
    """The stacked per-layer weights; the leading axis is the layer."""

    def __init__(self, wqkv, wo, w1, w2):
        super().__init__()
        self.wqkv = nn.Parameter(wqkv)
        self.wo = nn.Parameter(wo)
        self.w1 = nn.Parameter(w1)
        self.w2 = nn.Parameter(w2)


class Transformer(nn.Module):
    """Parameters named as the JAX tree names them: embed, pos,
    layers.{wqkv, wo, w1, w2}, unembed."""

    def __init__(self, cfg: dict, tree: dict[str, object]):
        super().__init__()
        self.cfg = dict(cfg)
        self.embed = nn.Parameter(tree["embed"])
        self.pos = nn.Parameter(tree["pos"])
        self.layers = Layers(**tree["layers"])
        self.unembed = nn.Parameter(tree["unembed"])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def _param_shapes(cfg: dict) -> dict:
    d, f, v, n = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    return {"embed": (v, d), "pos": (cfg["seq_len"], d),
            "layers": {"wqkv": (n, d, 3 * d), "wo": (n, d, d),
                       "w1": (n, d, f), "w2": (n, f, d)},
            "unembed": (d, v)}


def init_params(cfg: dict, seed: int = 0,
                device: str | torch.device | None = None) -> Transformer:
    """Random weights in bf16, N(0, 1) * d_model^-0.5 as the JAX init; the
    numbers come from torch's generator, not JAX's."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    scale = cfg["d_model"] ** -0.5

    def init(shape):
        return (torch.randn(shape, generator=gen) * scale).to(
            torch.bfloat16).to(dev)

    shapes = _param_shapes(cfg)
    tree = {name: init(shape) for name, shape in shapes.items()
            if name != "layers"}
    tree["layers"] = {name: init(shape)
                      for name, shape in shapes["layers"].items()}
    return Transformer(cfg, tree)


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    """numpy (fp32, or ml_dtypes bfloat16 viewed bit for bit) -> tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: dict, cfg: dict,
                      device: str | torch.device | None = None
                      ) -> Transformer:
    """The JAX parameter tree, as numpy arrays, as the port's module."""
    dev = resolve_device(device)
    shapes = _param_shapes(cfg)
    out = {}
    for name, shape in shapes.items():
        if name == "layers":
            out[name] = {n: _to_tensor(tree[name][n], dev)
                         for n in shape}
        else:
            out[name] = _to_tensor(tree[name], dev)
    for name, shape in shapes.items():
        got = ({n: tuple(t.shape) for n, t in out[name].items()}
               if name == "layers" else tuple(out[name].shape))
        if got != shape:
            raise ValueError(f"{name}: shape {got}, config wants {shape}")
    return Transformer(cfg, out)


def _attention(x: torch.Tensor, wqkv: torch.Tensor, wo: torch.Tensor,
               n_heads: int) -> torch.Tensor:
    return _attend(x @ wqkv, n_heads) @ wo


def _attend(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Causal attention of [B, S, 3d] projections, heads merged: [B, S, d]."""
    b, s, d = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):
        return t.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    dh = torch.tensor(d // n_heads, dtype=torch.bfloat16, device=qkv.device)
    scores = (q @ k.transpose(-1, -2)) / torch.sqrt(dh)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=qkv.device))
    scores = torch.where(mask, scores,
                         torch.tensor(-1e9, dtype=scores.dtype,
                                      device=qkv.device))
    probs = torch.softmax(scores.float(), dim=-1).to(torch.bfloat16)
    out = probs.to(v.dtype) @ v
    return out.transpose(1, 2).reshape(b, s, d)


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6).to(x.dtype)


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Logits [B, S, vocab] in the weights' dtype."""
    x = model.embed[tokens] + model.pos[None, : tokens.shape[1]]
    lw = model.layers
    for i in range(lw.wqkv.shape[0]):
        x = x + _attention(_rms_norm(x), lw.wqkv[i], lw.wo[i],
                           model.cfg["n_heads"])
        h = _rms_norm(x) @ lw.w1[i]
        x = x + F.gelu(h, approximate="tanh") @ lw.w2[i]
    return _rms_norm(x) @ model.unembed


def loss_fn(model: Transformer, batch: dict) -> torch.Tensor:
    return _nll(forward(model, batch["tokens"]), batch["targets"])


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def sgd_train_step(model: Transformer, batch: dict,
                   lr: float = 1e-2) -> tuple[Transformer, torch.Tensor]:
    """One SGD step, in place (the JAX step returns a new tree; the port
    updates the module's tensors to keep one copy of the weights). The
    update is taken in fp32 and stored back in the weights' dtype."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_((p.float() - lr * p.grad.float()).to(p.dtype))
    model.zero_grad(set_to_none=True)
    return model, loss.detach()


def make_batch(cfg: dict, batch_size: int = 8, seed: int = 1,
               device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    tokens = torch.randint(0, cfg["vocab"], (batch_size, cfg["seq_len"]),
                           generator=gen).to(dev)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


# ---------------------------------------------------------------------------
# Sharded training (dp x tp over a ("data", "model") mesh)
# ---------------------------------------------------------------------------

def param_shardings() -> dict:
    """The JAX table, as placements over ("data", "model"): weights
    model-parallel over the FFN and head dims, embeddings replicated."""
    rep = (Replicate(), Replicate())
    return {"embed": rep, "pos": rep,
            "layers": {"wqkv": (Replicate(), Shard(2)),
                       "wo": (Replicate(), Shard(1)),
                       "w1": (Replicate(), Shard(2)),
                       "w2": (Replicate(), Shard(1))},
            "unembed": (Replicate(), Shard(1))}


def batch_sharding() -> dict:
    """The batch over "data", replicated over "model"."""
    spec = (Shard(0), Replicate())
    return {"tokens": spec, "targets": spec}


def make_mesh(device_type: str = "cuda", data: int | None = None,
              model: int | None = None) -> DeviceMesh:
    """The ("data", "model") mesh over the group's ranks, in rank order;
    with no split given, the JAX default: model 2 when the world is even
    and above 1. Its per-axis groups (`mesh.get_group("data")`) are what
    the ring, the pipeline and the MoE layer take."""
    n = dist.get_world_size()
    if data is None or model is None:
        model = 2 if n % 2 == 0 and n > 1 else 1
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data} x {model} does not cover {n} ranks")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def local_shard(t: torch.Tensor, placements, mesh: DeviceMesh
                ) -> torch.Tensor:
    """This rank's block of a full tensor, by one placement per mesh dim."""
    for mesh_dim, p in enumerate(placements):
        t = block(t, p, mesh.get_local_rank(mesh_dim), mesh.size(mesh_dim))
    return t.contiguous()


def shard_params(model: Transformer, mesh: DeviceMesh) -> Transformer:
    """This rank's slices of full weights, by `param_shardings`."""
    table = param_shardings()
    tree = {name: local_shard(getattr(model, name).detach(), table[name],
                              mesh) for name in ("embed", "pos", "unembed")}
    tree["layers"] = {name: local_shard(getattr(model.layers, name).detach(),
                                        spec, mesh)
                      for name, spec in table["layers"].items()}
    return Transformer(model.cfg, tree)


def sharded_params_from_numpy(tree: dict, cfg: dict, mesh: DeviceMesh,
                              device: str | torch.device | None = None
                              ) -> Transformer:
    """The full JAX parameter tree, as numpy arrays, as this rank's
    slices."""
    return shard_params(params_from_numpy(tree, cfg, device=device), mesh)


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This rank's rows of a full batch, by `batch_sharding`."""
    table = batch_sharding()
    return {name: local_shard(t, table[name], mesh)
            for name, t in batch.items()}


def _gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel product's slices joined along the last dim: each
    rank places its slice among zeros and the sum over the group fills in
    the rest (adding zeros is exact in any dtype)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return t
    zero = torch.zeros_like(t)
    return AllReduce.apply(
        torch.cat([t if i == me else zero for i in range(n)], dim=-1), group)


def sharded_forward(model: Transformer, tokens: torch.Tensor,
                    mesh: DeviceMesh) -> torch.Tensor:
    """Logits [B_local, S, vocab] of this rank's rows, from its slices."""
    group = mesh.get_group("model")
    me = dist.get_rank(group)
    x = model.embed[tokens] + model.pos[None, : tokens.shape[1]]
    lw = model.layers
    for i in range(lw.wqkv.shape[0]):
        qkv = _gather_last(_rms_norm(x) @ lw.wqkv[i], group)
        out = _attend(qkv, model.cfg["n_heads"])
        rows = lw.wo.shape[1]                    # this rank's rows of wo
        x = x + AllReduce.apply(out[..., me * rows:(me + 1) * rows]
                                @ lw.wo[i], group)
        h = _rms_norm(x) @ lw.w1[i]
        x = x + AllReduce.apply(F.gelu(h, approximate="tanh") @ lw.w2[i],
                                group)
    return _gather_last(_rms_norm(x) @ model.unembed, group)


def sharded_loss_and_grads(model: Transformer, batch: dict,
                           mesh: DeviceMesh
                           ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The global batch's mean loss and this rank's fp32 gradients.

    Through `AllReduce`, autograd gives each rank the gradient of the sum
    of every model rank's loss, each model rank computing the same loss;
    so the loss is divided by the model axis' size, a sharded weight's
    gradient is then its own, and a replicated weight's is the sum of its
    copies' over the model axis. The gradients are averaged over "data"
    (the JAX psum of the batch-sharded mean), in fp32, where the update is
    taken."""
    model_size = mesh.size(1)
    data_group = mesh.get_group("data")
    model.zero_grad(set_to_none=True)
    loss = _nll(sharded_forward(model, batch["tokens"], mesh),
                batch["targets"])
    (loss / model_size).backward()
    n_data = mesh.size(0)
    table = param_shardings()
    table.update({f"layers.{k}": v for k, v in table.pop("layers").items()})
    grads = {}
    for name, p in model.named_parameters():
        # a replicated weight's copies: every rank's (None: the world)
        sharded = any(isinstance(x, Shard) for x in table[name])
        grads[name] = all_reduce(p.grad.float(),
                                 data_group if sharded else None) / n_data
    model.zero_grad(set_to_none=True)
    return all_reduce(loss.detach(), data_group) / n_data, grads


def make_sharded_train_step(mesh: DeviceMesh, lr: float = 1e-2):
    """One SGD step of this rank's slices on its rows of the batch
    (`shard_params`, `shard_batch`), in place; returns (model, loss), the
    loss the global batch's mean on every rank."""
    def step(model: Transformer, batch: dict
             ) -> tuple[Transformer, torch.Tensor]:
        loss, grads = sharded_loss_and_grads(model, batch, mesh)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_((p.float() - lr * grads[name]).to(p.dtype))
        return model, loss
    return step
