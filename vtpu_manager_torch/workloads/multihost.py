"""One rank of the multi-process data-parallel check.

Ports `tests/multihost_worker.py`: a data-parallel train step of the
flagship trainer across n real processes, then ring attention across the
process boundary. Each rank feeds its own shard of a deterministic global
batch (8 x 16 tokens, `arange % vocab`) into the sharded step on a
(data n, model 1) mesh, where the gradients are averaged over the ranks;
every rank must report the loss and updated weights one process gets on
the whole batch. Then each rank checks its own shard of a causal ring over
all ranks against the dense reference (3e-5).

    python -m vtpu_manager_torch.workloads.multihost --rank r --world n \\
        --store <file> [--device cpu|cuda] [--backend gloo|nccl] \\
        [--params <npz>] [--out <npz>]

prints `RANK <r> loss=<value> leaf=<value>` and `RANK <r> ring=OK` (or
`MISMATCH`). `--params` takes the full weights from an npz of the JAX tree
(keys `embed`, `pos`, `layers.wqkv`, ..., `unembed`; the bf16 values as
float32, which holds them exactly); by default they come from
`trainer.init_params(seed=0)`. `--out` writes the rank's updated weights
in the same layout. Rendezvous is the `file://` store that
every rank names, a fresh path for each world.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from vtpu_manager_torch.workloads import ranks
from vtpu_manager_torch.workloads import ring_attention as ra
from vtpu_manager_torch.workloads import trainer

GLOBAL_BATCH, SEQ = 8, 16
CONFIG = dict(vocab=64, d_model=32, d_ff=64, n_layers=2, n_heads=2,
              seq_len=SEQ)


def load_params(path: str) -> dict:
    """A JAX parameter tree saved flat in an npz (`layers.<name>` for the
    stacked layers)."""
    tree: dict = {"layers": {}}
    with np.load(path) as f:
        for key in f.files:
            if key.startswith("layers."):
                tree["layers"][key.split(".", 1)[1]] = f[key]
            else:
                tree[key] = f[key]
    return tree


def run(rank: ranks.Rank, params: str | None = None,
        out: str | None = None) -> dict:
    """This rank's dp step and ring shard; prints the two RANK lines and
    writes the updated weights to the npz `out` when given."""
    cfg = trainer.model_config(**CONFIG)
    dev, me, world = rank.device, rank.rank, rank.world
    if params:
        full = trainer.params_from_numpy(load_params(params), cfg,
                                         device=dev).to(torch.bfloat16)
    else:
        full = trainer.init_params(cfg, seed=0, device=dev)
    mesh = trainer.make_mesh(dev.type, data=world, model=1)
    model = trainer.shard_params(full, mesh)

    # a deterministic global batch, the same on every rank; each rank
    # feeds its own rows
    tokens = (np.arange(GLOBAL_BATCH * SEQ, dtype=np.int64).reshape(
        GLOBAL_BATCH, SEQ) % cfg["vocab"])
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "targets": torch.from_numpy(np.roll(tokens, -1, axis=1)).to(dev)}
    model, loss = trainer.make_sharded_train_step(mesh)(
        model, trainer.shard_batch(batch, mesh))
    # the first leaf of the JAX tree (keys in sorted order): the embedding
    leaf = float(model.embed.float().sum())
    print(f"RANK {me} loss={float(loss):.6f} leaf={leaf:.6f}", flush=True)
    if out:
        np.savez(out, **{name: p.detach().float().cpu().numpy()
                         for name, p in model.named_parameters()})

    # ring attention across the process boundary: every rank checks its
    # own sequence shard against the dense reference computed locally
    s_total = 8 * world
    gen = torch.Generator(device="cpu").manual_seed(2)
    q, k, v = (torch.randn((1, 2, s_total, 8), generator=gen).to(dev)
               for _ in range(3))
    out = ra.make_ring_attention(dist.group.WORLD, causal=True)(
        *(ra.sequence_shard(t, me, world) for t in (q, k, v)))
    want = ra.sequence_shard(ra.reference_attention(q, k, v, causal=True),
                             me, world)
    ok = bool(torch.allclose(out, want, atol=3e-5, rtol=3e-5))
    print(f"RANK {me} ring={'OK' if ok else 'MISMATCH'}", flush=True)
    return {"loss": float(loss), "leaf": leaf, "ring": ok}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--backend", choices=("nccl", "gloo"))
    p.add_argument("--params")
    p.add_argument("--out")
    a = p.parse_args(argv)
    backend = a.backend or ranks.default_backend(a.device)
    rank = ranks.init(a.rank, a.world, a.store, backend, a.device)
    try:
        result = run(rank, a.params, a.out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0 if result["ring"] else 1


if __name__ == "__main__":
    sys.exit(main())
