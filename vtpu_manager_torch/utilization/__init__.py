"""The utilization plane: each tenant's allocated against used share.

The port of the JAX package's `utilization/`: `ledger.py` folds the step
rings, the container configs and the watcher's feed into per-tenant rows
and each chip's reclaimable headroom; `headroom.py` is the node
annotation's codec; `rollup.py` joins the node ledgers into the exporter's
/utilization document, which `tools/vtpu_smi.py` renders. All of it runs
under the UtilizationLedger gate.
"""

from vtpu_manager_torch.utilization.headroom import (ChipHeadroom,
                                                     NodeHeadroom,
                                                     headroom_score_input,
                                                     parse_headroom)
from vtpu_manager_torch.utilization.ledger import (HeadroomPublisher,
                                                   UtilizationLedger,
                                                   utilization_stats_for_pod)

__all__ = [
    "ChipHeadroom", "NodeHeadroom", "parse_headroom",
    "headroom_score_input", "UtilizationLedger", "HeadroomPublisher",
    "utilization_stats_for_pod",
]
