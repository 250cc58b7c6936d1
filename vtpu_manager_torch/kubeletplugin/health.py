"""DRA-side device health: probe the cards, publish the ResourceSlice
again when one flips.

The port of the JAX package's `kubeletplugin/health.py:31-105`. The probe
loop is the device manager's `HealthWatcher` (unhealthy after a streak of
failed probes, healthy at the first good one) over a plain card list; a
flip replaces the card's `ChipSpec` in that list and calls `on_change`
with it, which publishes the slice with the card's `healthy` attribute,
so DeviceClass selectors keep new claims off a sick card. Claims already
prepared are not touched. A publication that fails is tried again at
every later poll.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import replace
from typing import Callable

from vtpu_manager_torch.device.types import ChipSpec
from vtpu_manager_torch.manager.device_manager import HealthWatcher

log = logging.getLogger(__name__)

INTERVAL_S = 10.0


def device_node_probe(minors: dict[int, int]) -> Callable[[ChipSpec], bool]:
    """The default probe: a card is healthy while /dev/nvidia<minor>
    exists (a card without a minor raises, which reads as sick)."""
    return lambda chip: os.path.exists(f"/dev/nvidia{minors[chip.index]}")


class _ChipListTarget:
    """HealthWatcher's flip interface (chips, mark_unhealthy,
    mark_healthy) over a bare card list."""

    def __init__(self, chips: list[ChipSpec]):
        self.chips = chips
        self.flipped: list[ChipSpec] = []

    def _flip(self, uuid: str, healthy: bool) -> None:
        for i, chip in enumerate(self.chips):
            if chip.uuid == uuid and chip.healthy != healthy:
                self.chips[i] = replace(chip, healthy=healthy)
                self.flipped.append(self.chips[i])
                log.log(logging.INFO if healthy else logging.ERROR,
                        "device %s -> %s", uuid,
                        "healthy" if healthy else "UNHEALTHY")

    def mark_unhealthy(self, uuid: str) -> None:
        self._flip(uuid, False)

    def mark_healthy(self, uuid: str) -> None:
        self._flip(uuid, True)

    def take_flips(self) -> list[ChipSpec]:
        out, self.flipped = self.flipped, []
        return out


class DraHealthWatcher:
    """Polls card health; a flip changes the shared card list in place and
    calls `on_change` with the updated list. A failed `on_change` (False
    or an exception) leaves the list dirty, and it is called again at
    every later poll until it succeeds."""

    def __init__(self, chips: list[ChipSpec],
                 probe: Callable[[ChipSpec], "bool | None"],
                 on_change: Callable[[list[ChipSpec]], object]):
        self.chips = chips
        self.on_change = on_change
        self._target = _ChipListTarget(chips)
        self._watcher = HealthWatcher(self._target, probe,
                                      interval_s=INTERVAL_S)
        self._dirty = False
        self._stop = threading.Event()

    def check_once(self) -> list[ChipSpec]:
        """One probe pass; returns the cards that flipped."""
        self._watcher.check_once()
        flipped = self._target.take_flips()
        if flipped:
            self._dirty = True
        if self._dirty:
            try:
                ok = self.on_change(list(self.chips))
                self._dirty = ok is False
            except Exception:  # noqa: BLE001 - retried at the next poll
                log.exception("health on_change failed; will retry")
                self._dirty = True
        return flipped

    def start(self) -> None:
        def loop():
            while not self._stop.wait(INTERVAL_S):
                self.check_once()

        threading.Thread(target=loop, daemon=True,
                         name="vtpu-dra-health").start()

    def stop(self) -> None:
        self._stop.set()
