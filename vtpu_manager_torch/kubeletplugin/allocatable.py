"""The node's ResourceSlice: what the DRA scheduler can allocate here.

The port's own copy of the JAX package's `kubeletplugin/allocatable.py:
21-86`, so a slice published by either package is the same document for
the same `ChipSpec`s (resource.k8s.io/v1beta1): one device
`vtpu-<index>-<slot>` per slot of each card, each consuming its share of
the card's shared counters (`coreRatio` in percent, `memoryMiB`), so two
claims can land on one card and no more than the card is handed out.
The JAX webhook and claim resolver read the port's slices as they read
their own.
"""

from __future__ import annotations

from vtpu_manager_torch.device.types import ChipSpec
from vtpu_manager_torch.util import consts

CORE_COUNTER = "coreRatio"      # percent units per card
MEMORY_COUNTER = "memoryMiB"


def device_entries(chips: list[ChipSpec]) -> list[dict]:
    out = []
    for chip in chips:
        split = max(chip.split_count, 1)
        slot_cores = 100 // split
        slot_mem = (chip.memory // 2**20) // split
        for slot in range(split):
            out.append({
                "name": f"vtpu-{chip.index}-{slot}",
                "basic": {
                    "attributes": {
                        "uuid": {"string": chip.uuid},
                        "chipType": {"string": chip.chip_type},
                        "index": {"int": chip.index},
                        "slot": {"int": slot},
                        "meshX": {"int": chip.coords[0]},
                        "meshY": {"int": chip.coords[1]},
                        "meshZ": {"int": chip.coords[2]},
                        "healthy": {"bool": chip.healthy},
                    },
                    "capacity": {
                        CORE_COUNTER: {"value": str(slot_cores)},
                        MEMORY_COUNTER: {"value": str(slot_mem)},
                    },
                    "consumesCounters": [{
                        "counterSet": f"chip-{chip.index}",
                        "counters": {
                            CORE_COUNTER: {"value": str(slot_cores)},
                            MEMORY_COUNTER: {"value": str(slot_mem)},
                        },
                    }],
                },
            })
    return out


def shared_counter_sets(chips: list[ChipSpec]) -> list[dict]:
    return [{
        "name": f"chip-{chip.index}",
        "counters": {
            CORE_COUNTER: {"value": "100"},
            MEMORY_COUNTER: {"value": str(chip.memory // 2**20)},
        },
    } for chip in chips]


def build_resource_slice(node_name: str, chips: list[ChipSpec],
                         pool_generation: int = 1) -> dict:
    return {
        "apiVersion": "resource.k8s.io/v1beta1",
        "kind": "ResourceSlice",
        "metadata": {"name": f"{node_name}-vtpu"},
        "spec": {
            "driver": consts.DRA_DRIVER_NAME,
            "nodeName": node_name,
            "pool": {"name": node_name, "generation": pool_generation,
                     "resourceSliceCount": 1},
            "sharedCounters": shared_counter_sets(chips),
            "devices": device_entries(chips),
        },
    }
