"""Flagship tenant workload: a small transformer-LM trainer, one device.

Ports `vtpu_manager/workloads/trainer.py:25-119`: the config, the
stacked-layer weights, the forward pass (the JAX `lax.scan` over the layer
axis becomes a loop), the loss, the plain-autograd SGD step and the batch.
The weights keep the JAX layout (`wqkv` [L, d, 3d], attention
[B, H, S, D]) so `params_from_numpy` carries a JAX parameter tree across
bit for bit. Three numeric details follow the JAX code: the attention
scale is the sqrt of a bf16 head dim, the probabilities are cast to bf16
before the product with v, and gelu is the tanh approximation. The
sharded trainer (`trainer.py:126-175`) comes with the multi-device slice.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vtpu_manager_torch.util.torchplatform import resolve_device


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
    b, s, d = x.shape
    qkv = x @ wqkv
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):
        return t.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    dh = torch.tensor(d // n_heads, dtype=torch.bfloat16, device=x.device)
    scores = (q @ k.transpose(-1, -2)) / torch.sqrt(dh)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    scores = torch.where(mask, scores,
                         torch.tensor(-1e9, dtype=scores.dtype,
                                      device=x.device))
    probs = torch.softmax(scores.float(), dim=-1).to(torch.bfloat16)
    out = probs.to(v.dtype) @ v
    out = out.transpose(1, 2).reshape(b, s, d)
    return out @ wo


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
    logits = forward(model, batch["tokens"]).float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["targets"][..., None])
    return nll.mean()


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
