"""Entry points: the flagship trainer's loss, and the multi-device dry run.

Ports `__graft_entry__.py:14 entry` and `:33 dryrun_multichip`. Where JAX
runs n virtual devices in one process, the dry run starts n rank processes
(`workloads/ranks.py`) and makes the JAX checks at the same shapes and
tolerances on each:

- the loss of one dp x tp train step is finite;
- ring attention, causal, over the "data" group, within 3e-5 of
  `reference_attention` on each rank's sequence shard;
- the GPipe pipeline over all n ranks within 1e-5 of the sequential stages;
- top-1 MoE with 2n experts, capacity 4 and 8 tokens per rank within 1e-5
  of `reference_moe_per_shard`.

On the card each rank takes its own card over NCCL; `device="cpu"` runs
gloo ranks on the CPU. (Several ranks on one card run over gloo through
`workloads/ranks.py`, as `chip_smoke.py`'s distributed phase does.)

    python -m vtpu_manager_torch.graft_entry [n] [--cpu]
"""

from __future__ import annotations

import argparse
import math

import torch

from vtpu_manager_torch.workloads import trainer

DRYRUN_CONFIG = dict(vocab=128, d_model=64, d_ff=128, n_layers=2, n_heads=2,
                     seq_len=32)


def entry(device: str | torch.device | None = None):
    """(fn, args): the transformer-LM loss and its (model, batch)."""
    cfg = trainer.model_config(**DRYRUN_CONFIG)
    model = trainer.init_params(cfg, seed=0, device=device)
    batch = trainer.make_batch(cfg, batch_size=4, seed=1, device=device)
    return trainer.loss_fn, (model, batch)


def _randn(shape, seed: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device)


def _max_err(got: torch.Tensor, want: torch.Tensor, atol: float,
             rtol: float) -> float:
    """Largest |got - want| over atol + rtol |want| (within tolerance at
    <= 1, numpy's allclose rule)."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def check_step(mesh, cfg: dict, dev: torch.device) -> dict:
    """One dp x tp train step of full weights sharded over `mesh`: its
    loss, finite, beside one process's loss of the same weights and batch
    (the JAX test's bf16 bound, 5e-2), and the slices' shapes."""
    full = trainer.init_params(cfg, seed=0, device=dev)
    data_size = mesh.size(0)
    batch = trainer.make_batch(cfg, batch_size=max(4, data_size * 2),
                               seed=1, device=dev)
    with torch.no_grad():
        single = float(trainer.loss_fn(full, batch))
    model = trainer.shard_params(full, mesh)
    step = trainer.make_sharded_train_step(mesh)
    model, loss = step(model, trainer.shard_batch(batch, mesh))
    loss_val = float(loss)
    if not math.isfinite(loss_val) or abs(loss_val - single) > 5e-2:
        raise AssertionError(f"sharded loss {loss_val}, one process "
                             f"{single}")
    return {"loss": loss_val, "single_loss": single,
            "w1_shape": list(model.layers.w1.shape)}


def check_ring(group, shape: tuple, dev: torch.device, atol: float,
               rtol: float, block_fn=None) -> tuple[float, torch.Tensor]:
    """Causal ring attention over `group` on full q, k, v of `shape`
    (the sequence split over the ranks): its error against
    `reference_attention`'s shard, in units of atol + rtol |reference|
    (within at <= 1), and this rank's output shard."""
    import torch.distributed as dist

    from vtpu_manager_torch.workloads import ring_attention as ra

    n, i = dist.get_world_size(group), dist.get_rank(group)
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    shards = [ra.sequence_shard(t, i, n) for t in (q, k, v)]
    out = ra.ring_attention_sharded(*shards, group, causal=True,
                                    block_fn=block_fn)
    ref = ra.sequence_shard(ra.reference_attention(q, k, v, causal=True),
                            i, n)
    err = _max_err(out, ref, atol, rtol)
    if err > 1:
        raise AssertionError(f"ring attention off the reference: {err}")
    return err, out


def check_pipeline(group, dev: torch.device) -> float:
    """The GPipe schedule over every rank of `group`, n + 2 microbatches,
    against the sequential stages within 1e-5."""
    import torch.distributed as dist

    from vtpu_manager_torch.workloads import pipeline as pp

    n = dist.get_world_size(group)
    params = pp.stage_params(n, width=16, seed=5, device=dev)
    x = _randn((n + 2, 3, 16), 6, dev)
    out = pp.make_pipeline_forward(group)(pp.local_stage(params, group), x)
    ref = torch.stack([pp.reference_forward(params, mb) for mb in x])
    err = _max_err(out, ref, 1e-5, 1e-5)
    if err > 1:
        raise AssertionError(f"pipeline off the reference: {err}")
    return err


def check_moe(group, dev: torch.device) -> float:
    """Top-1 MoE with 2n experts, capacity 4 and 8 tokens per rank against
    the dense per-shard reference within 1e-5."""
    import torch.distributed as dist

    from vtpu_manager_torch.workloads import moe

    n, me = dist.get_world_size(group), dist.get_rank(group)
    n_experts, cap, t_per = 2 * n, 4, 8
    params = moe.moe_params(n_experts, width=16, hidden=32, seed=7,
                            device=dev)
    x = _randn((t_per * n, 16), 8, dev)
    out = moe.make_moe_forward(group, capacity=cap)(
        moe.local_experts(params, group), x[me * t_per:(me + 1) * t_per])
    ref = moe.reference_moe_per_shard(params, x, cap, n)[
        me * t_per:(me + 1) * t_per]
    err = _max_err(out, ref, 1e-5, 1e-5)
    if err > 1:
        raise AssertionError(f"moe off the reference: {err}")
    return err


def dryrun_rank(rank, cfg: dict | None = None) -> dict:
    """One rank's part of the dry run (a `ranks` job); raises where a
    check fails."""
    import torch.distributed as dist

    from vtpu_manager_torch.util.torchplatform import exact_fp32

    exact_fp32()
    dev = rank.device
    mesh = trainer.make_mesh(dev.type)
    step = check_step(mesh, trainer.model_config(**(cfg or DRYRUN_CONFIG)),
                      dev)
    # sequence parallelism over the data group, at the JAX shapes
    ring_err, _ = check_ring(mesh.get_group("data"),
                             (2, 2, 8 * mesh.size(0), 8), dev, 3e-5, 3e-5)
    world = dist.group.WORLD
    return {"mesh": {"data": mesh.size(0), "model": mesh.size(1)},
            "loss": step["loss"], "single_loss": step["single_loss"],
            "ring_err": ring_err, "pipeline_err": check_pipeline(world, dev),
            "moe_err": check_moe(world, dev), "device": str(dev)}


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None,
                     cfg: dict | None = None, timeout: float = 600.0,
                     env: dict | None = None) -> list[dict]:
    """Runs the dry run on n rank processes and prints the JAX entry's
    one-line verdict; returns every rank's record. A rank that fails
    fails the run. `env` is every rank's environment (what the device
    plugin's Allocate gives a pod's containers), the caller's by default."""
    from vtpu_manager_torch.workloads import ranks

    results = ranks.launch("vtpu_manager_torch.graft_entry:dryrun_rank",
                           n_devices, device=device, args={"cfg": cfg},
                           env=env, timeout=timeout)
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        raise AssertionError(f"ranks disagree on the loss: {losses}")
    print(f"dryrun_multichip({n_devices}): mesh={results[0]['mesh']} "
          f"loss={results[0]['loss']:.4f} ring-attention OK pipeline OK "
          f"moe OK", flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="the port's entry points")
    p.add_argument("n", type=int, nargs="?", default=8)
    p.add_argument("--cpu", action="store_true",
                   help="gloo ranks on the CPU (default: the card)")
    a = p.parse_args(argv)
    device = "cpu" if a.cpu else None
    fn, args = entry(device)
    print("entry loss:", float(fn(*args).detach()))
    dryrun_multichip(a.n, device=device)


if __name__ == "__main__":
    main()
