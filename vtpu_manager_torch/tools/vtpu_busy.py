#!/usr/bin/env python3
"""vtpu_busy: drive the card at a duty cycle.

The port's `library/tools/vtpu_busy.py`: the operator's load generator
for checking a tenant's compute limit. Each period runs steps for duty %
of it, then sleeps the rest. Under the interposer the share the card
gives the tool is min(--duty, the container's limit); unmanaged it is
--duty. The step is the 8192 bf16 matmul (`--step matmul`, the quota
step's product) or `torch.cuda._sleep` of about one millisecond
(`--step sleep`), on the card unless `--device cpu` is asked for; each
step ends in a synchronisation.

The share reported is completed steps times the step's unthrottled time
over the wall time. The unthrottled time is the least step time seen over
the run: most steps under a limit are paced, but the first launch after
an idle gap goes at once, so the minimum keeps finding the step's own
time even inside an enforced container; time blocked in the interposer's
bucket does not count as busy.

    python -m vtpu_manager_torch.tools.vtpu_busy --duty 60 --seconds 30
    python -m vtpu_manager_torch.tools.vtpu_busy --step sleep --report-every 5

The last line is `VTPU_BUSY {json}`: the share, the steps, the step's
time and the wall time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SLEEP_STEP_S = 1e-3


def make_step(torch, kind: str, dim: int, dev):
    """The step function (returns when the card has run it)."""
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    if kind == "sleep":
        if dev.type != "cuda":
            raise ValueError("--step sleep needs the card")
        # calibrate the spin to about one millisecond on this card
        cycles = 1_000_000
        torch.cuda._sleep(cycles)
        sync()
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        sync()
        cycles = max(1, int(cycles * SLEEP_STEP_S
                            / max(time.perf_counter() - t0, 1e-6)))

        def step() -> None:
            torch.cuda._sleep(cycles)
            sync()
        return step
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((dim, dim), generator=gen, device=dev,
                    dtype=torch.bfloat16)

    def step() -> None:
        nonlocal x
        x = torch.tanh(x @ x) * 1e-3
        sync()
    return step


def run(duty: int, period_ms: int, seconds: float, step, report_every: float,
        out=sys.stdout) -> dict:
    # warm-up (first-call costs kept out of the count and the minimum)
    step_s = float("inf")
    for i in range(4):
        t0 = time.perf_counter()
        step()
        if i > 0:
            step_s = min(step_s, time.perf_counter() - t0)
    period_s = period_ms / 1000.0
    busy_target = period_s * min(max(duty, 0), 100) / 100.0
    deadline = time.monotonic() + seconds if seconds else None
    wall_start = last_report = time.perf_counter()
    steps = 0

    def share(wall: float) -> float:
        return 100.0 * steps * step_s / wall if wall > 0 else 0.0

    print(f"step ~{step_s * 1000:.2f} ms, duty {duty}% of {period_ms} ms "
          f"periods; ctrl-c to stop", file=out, flush=True)
    try:
        while deadline is None or time.monotonic() < deadline:
            period_start = time.perf_counter()
            while time.perf_counter() - period_start < busy_target:
                t0 = time.perf_counter()
                step()
                step_s = min(step_s, time.perf_counter() - t0)
                steps += 1
            rest = period_s - (time.perf_counter() - period_start)
            if rest > 0:
                time.sleep(rest)
            now = time.perf_counter()
            if now - last_report >= report_every:
                print(f"effective {share(now - wall_start):5.1f}% of card "
                      f"({steps} steps, {now - wall_start:.1f}s)", file=out,
                      flush=True)
                last_report = now
    except KeyboardInterrupt:
        pass
    wall = time.perf_counter() - wall_start
    print(f"final: effective {share(wall):.1f}% of card over {wall:.1f}s "
          f"({steps} steps)", file=out, flush=True)
    return {"effective_pct": share(wall), "steps": steps,
            "step_ms": step_s * 1000, "wall_s": wall, "duty": duty}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duty", type=int, default=100,
                    help="target busy percent per period")
    ap.add_argument("--period-ms", type=int, default=500)
    ap.add_argument("--seconds", type=float, default=0,
                    help="0 = run until interrupted")
    ap.add_argument("--step", choices=("matmul", "sleep"), default="matmul")
    ap.add_argument("--dim", type=int, default=8192,
                    help="the bf16 matmul's edge (sizes one step)")
    ap.add_argument("--report-every", type=float, default=2.0)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    import torch

    from vtpu_manager_torch.util.torchplatform import (device_name,
                                                        resolve_device)
    dev = resolve_device(args.device)
    step = make_step(torch, args.step, args.dim, dev)
    rec = run(args.duty, args.period_ms, args.seconds, step,
              args.report_every)
    rec.update(device=device_name(dev), step=args.step)
    print("VTPU_BUSY " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
