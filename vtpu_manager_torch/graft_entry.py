"""Single-device entry point: the flagship trainer's loss, ready to call.

Ports `__graft_entry__.py:14 entry`. The multi-device dry run
(`dryrun_multichip`) comes with the distributed slice.
"""

from __future__ import annotations

import torch

from vtpu_manager_torch.workloads import trainer


def entry(device: str | torch.device | None = None):
    """(fn, args): the transformer-LM loss and its (model, batch)."""
    cfg = trainer.model_config(vocab=128, d_model=64, d_ff=128, n_layers=2,
                               n_heads=2, seq_len=32)
    model = trainer.init_params(cfg, seed=0, device=device)
    batch = trainer.make_batch(cfg, batch_size=4, seed=1, device=device)
    return trainer.loss_fn, (model, batch)


if __name__ == "__main__":
    fn, args = entry()
    print("entry loss:", float(fn(*args)))
