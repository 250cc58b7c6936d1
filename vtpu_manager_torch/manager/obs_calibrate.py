"""Observation-overhead calibration, on the node (the calibration half of
the JAX package's `manager/obs_calibrate.py`).

The interposer charges a throttled tenant for what its samples measure. A
sample taken on an idle stream ("isolated", `csrc/shim/enforce_rate.cc`)
also times the launch's way to the card, and after the card has idled
that way may grow with the idle time: a tenant paced by a low quota,
whose every step starts after an idle gap, would pay it on every step.
The interposer's own idle probe measures the launch latency on an idle
stream, not what the gap adds.

The node can measure it before tenants arrive: it runs a reference
program on the card in a sync loop, back to back (the unthrottled regime,
whose span is the fair charge) and paced after idle gaps (the throttled
regime), and publishes the excess of the paced spans over the
back-to-back floor as a gap-indexed table:

    VTPU_OBS_EXCESS_TABLE="0:0,60000:1800,120000:6000,250000:14000"

The interposer interpolates the table at each isolated sample's gap and
discounts that much, still capped at half the sample. A card with no
after-idle inflation calibrates to about 0 everywhere, and the discount
vanishes.

The reference program is the JAX package's, on the card: a
REFERENCE_DIM x REFERENCE_DIM bf16 `(tanh(a @ a) * 1e-3).sum()` with a
scalar readback. Run it as `python -m vtpu_manager_torch.manager.obs_calibrate`
in a throwaway process (`calibrate_in_subprocess`), before tenants
arrive: only the process's exit reliably frees the card.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time
from typing import Callable

GAPS_MS = (60, 120, 250)
B2B_SAMPLES = 8
GAP_SAMPLES = 9
WARMUP = 4
REFERENCE_DIM = 6144
SUBPROCESS_TIMEOUT_S = 180.0

ENV_CALIBRATE = "VTPU_OBS_CALIBRATE"       # 0, 1 or auto (the default)
ENV_STAT = "VTPU_OBS_CAL_STAT"             # median (default) or min
ENV_DIM = "VTPU_OBS_CAL_DIM"
ENV_GAPS_MS = "VTPU_OBS_CAL_GAPS_MS"       # comma-separated
TABLE_PREFIX = "OBS_EXCESS_TABLE="


def measure_excess_table(run_once: Callable[[], None] | None = None,
                         gaps_ms: tuple[int, ...] = GAPS_MS,
                         b2b_samples: int = B2B_SAMPLES,
                         gap_samples: int = GAP_SAMPLES
                         ) -> list[tuple[int, int]] | None:
    """[(gap_us, excess_us), ...] for this card, or None.

    `run_once` runs the reference program once and returns when its
    result is on the host (default: `torch_run_once()` on the card). The
    floor is the least back-to-back span (no span is below the true one);
    at each gap the loop is paced (sleep, run, repeat), the first paced
    span is dropped (entering the rhythm), and the excess is the median
    paced span over the floor (`VTPU_OBS_CAL_STAT=min`: the least): a
    phase-dependent inflation would give a least sample that is clean
    while the typical step pays it. The table starts at (0, 0): a span
    with no gap is the fair charge."""
    if run_once is None:
        run_once = torch_run_once()
        if run_once is None:
            return None
    paced_stat = (min if os.environ.get(ENV_STAT, "median") == "min"
                  else _median)
    try:
        for _ in range(WARMUP):
            run_once()
        base = min(_spans_us(run_once, b2b_samples, 0.0))
        table: list[tuple[int, int]] = [(0, 0)]
        for gap_ms in gaps_ms:
            spans = _spans_us(run_once, gap_samples + 1, gap_ms / 1000.0)
            table.append((gap_ms * 1000,
                          max(0, int(paced_stat(spans[1:]) - base))))
    # any failure of the card or the program means no table; this runs in
    # a throwaway process whose stderr the caller captures
    except Exception:  # noqa: BLE001
        return None
    return table


def _median(vals: list[int]) -> int:
    return int(statistics.median(vals))


def _spans_us(run_once: Callable[[], None], n: int,
              gap_s: float) -> list[int]:
    out = []
    for _ in range(n):
        if gap_s:
            time.sleep(gap_s)
        t0 = time.perf_counter_ns()
        run_once()
        out.append((time.perf_counter_ns() - t0) // 1000)
    return out


def encode_table(table: list[tuple[int, int]]) -> str:
    return ",".join(f"{g}:{e}" for g, e in table)


def decode_table(raw: str) -> list[tuple[int, int]]:
    """The inverse of `encode_table` ("gap_us:excess_us,..."); ValueError
    on a malformed table. The interposer parses the same format
    (`enforce_rate.cc`, EnvExcessTable)."""
    out = []
    for part in raw.split(","):
        gap, _, excess = part.partition(":")
        out.append((int(gap), int(excess)))
    return out


def torch_run_once() -> Callable[[], None] | None:
    """The reference program on the card, or None without one: the
    calibration measures the card and has no CPU fallback."""
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        dim = int(os.environ.get(ENV_DIM, REFERENCE_DIM))
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((dim, dim), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    # a missing or broken torch or driver all mean: cannot measure
    except Exception:  # noqa: BLE001
        return None

    def run_once() -> None:
        # the scalar readback makes each call a sync-loop step: launch,
        # card time and the host's observation, what a tenant is charged
        float((torch.tanh(x @ x) * 1e-3).sum())

    return run_once


def calibrate_in_subprocess(timeout_s: float = SUBPROCESS_TIMEOUT_S,
                            env: dict | None = None) -> str | None:
    """The measurement in a throwaway process: the encoded table, or
    None."""
    try:
        res = subprocess.run(
            [sys.executable, "-m", "vtpu_manager_torch.manager.obs_calibrate"],
            env=env if env is not None else dict(os.environ),
            capture_output=True, text=True, timeout=timeout_s)
    except (subprocess.TimeoutExpired, OSError):
        return None
    for line in res.stdout.splitlines():
        if line.startswith(TABLE_PREFIX):
            val = line.split("=", 1)[1]
            return val if val and val != "none" else None
    return None


def maybe_calibrate(real_chips: bool, env: dict | None = None
                    ) -> str | None:
    """The calibration at a plugin's start-up: `VTPU_OBS_CALIBRATE=0`
    never, `1` always, `auto` (the default) only when discovery found real
    devices. `env` is the plugin's environment (default: this process's);
    the measurement runs in it."""
    env = dict(os.environ) if env is None else env
    mode = env.get(ENV_CALIBRATE, "auto")
    if mode == "0" or (mode != "1" and not real_chips):
        return None
    return calibrate_in_subprocess(env=env)


def main() -> int:
    gaps = tuple(int(g) for g in os.environ.get(
        ENV_GAPS_MS, ",".join(str(g) for g in GAPS_MS)).split(","))
    table = measure_excess_table(gaps_ms=gaps)
    if table is None:
        print(f"{TABLE_PREFIX}none")
        return 1
    print(f"{TABLE_PREFIX}{encode_table(table)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
