"""Enforcement checks: the quota sweep and the exact memory cap.

Ports `bench.py:293 paired_quota_sweep`, `bench.py:536 run_hbm_check` and
`bench.py:579 run_fake_sweep`. Each measurement on the card runs in a
fresh tenant subprocess with the interposer preloaded (the preload reaches
that subprocess only) and its limits in the environment:

- quota sweep: the step loop of `bench_steps.quota_step_measure` at quotas
  100/50/25. A quota's share is t(100)/t(q) from a back-to-back pair, and
  the tracking error is |share - q|, averaged over the throttled quotas;
- memory cap: under a 64 MiB cap the card must report a 64 MiB total and
  a 256 MiB tensor must fail with torch.cuda.OutOfMemoryError;
- fake sweep: the same quotas against the fake driver, with no card.

Run `python -m vtpu_manager_torch.bench_quota --worker ...` only as the
tenant subprocess these functions start.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

from vtpu_manager_torch import build
from vtpu_manager_torch.runtime.client import install

QUOTAS = (100, 50, 25)
CAP_BYTES = 64 * 2**20
OVER_CAP_SHAPE = (64, 1024, 1024)     # 256 MiB of float32


def tenant_env(shim: str | None, quota: int = 100,
               mem_limit: int = 0) -> dict:
    """This process's environment plus the interposer (none when `shim` is
    None: the overhead baseline) and the limits."""
    env = dict(os.environ)
    if shim is not None:
        env.update(install(shim_path=shim) or {})
    env["VTPU_CORE_LIMIT_0"] = str(quota if quota < 100 else 0)
    env["VTPU_MEM_LIMIT_0"] = str(mem_limit)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(build.REPO), env.get("PYTHONPATH")) if p)
    return env


def _run_tenant(args: list[str], env: dict, tag: str,
                timeout: int) -> dict | None:
    try:
        res = subprocess.run([sys.executable, *args], env=env,
                             cwd=str(build.REPO), capture_output=True,
                             text=True, timeout=timeout, check=False)
    except subprocess.TimeoutExpired:
        print(f"{tag} timed out", file=sys.stderr)
        return None
    for line in res.stdout.splitlines():
        if line.startswith(f"{tag} "):
            return json.loads(line[len(tag) + 1:])
    print(f"{tag} failed (rc={res.returncode}):\n{res.stdout[-600:]}\n"
          f"{res.stderr[-1500:]}", file=sys.stderr)
    return None


def run_worker(shim: str | None, quota: int, dim: int = 8192,
               warmup: int = 10, steps: int = 30,
               timeout: int = 300) -> dict | None:
    """One tenant run of the step loop at `quota` (`shim` None: no
    interposer). At quota 100 under the interposer the tenant also
    launches the block-attention kernel once, to show the interposer
    meters a hand-written kernel too."""
    args = ["-m", "vtpu_manager_torch.bench_quota", "--worker",
            "--dim", str(dim), "--warmup", str(warmup),
            "--steps", str(steps)]
    if shim is not None and quota >= 100:
        args.append("--kernel")
    return _run_tenant(args, tenant_env(shim, quota), "WORKER", timeout)


def paired_quota_sweep(run, quotas=QUOTAS, reps: int = 1
                       ) -> tuple[dict[int, float], dict[int, float],
                                  list[dict]]:
    """(ms/step per quota, share % per quota, every worker's record).

    `run(quota)` returns a worker record or None. Each rep runs (t100, tq)
    back to back and the pair with the least summed wall gives the share,
    so both sides of the ratio come from one moment of the machine."""
    times: dict[int, float] = {}
    shares: dict[int, float] = {}
    records: list[dict] = []
    for quota in quotas:
        best = None
        for _ in range(max(1, reps)):
            r100 = run(100)
            rq = run(quota)
            records += [r for r in (r100, rq) if r is not None]
            if r100 is None or rq is None:
                continue
            t100, tq = r100["ms_per_step"], rq["ms_per_step"]
            if 100 not in times or t100 < times[100]:
                times[100] = t100
            if best is None or t100 + tq < sum(best):
                best = (t100, tq)
        if best is not None:
            times[quota] = best[1]
            shares[quota] = 100.0 * best[0] / best[1]
    return times, shares, records


def tracking_mae(shares: dict[int, float]) -> float | None:
    """Mean |share - quota| over the throttled quotas."""
    errs = [abs(s - q) for q, s in shares.items() if q < 100]
    return sum(errs) / len(errs) if errs else None


def run_hbm_check(shim: str, timeout: int = 300) -> dict:
    """Exact-cap check. `error` is 0 when the cap held with the right error
    and the capped view, 100 on a violation or a wrong error class, None
    when the check could not run."""
    out = _run_tenant(["-m", "vtpu_manager_torch.bench_quota",
                       "--hbm-worker"],
                      tenant_env(shim, 100, mem_limit=CAP_BYTES), "HBM",
                      timeout)
    if out is None:
        return {"error": None}
    ok = out["verdict"] == "oom" and out["total"] == CAP_BYTES
    return {**out, "cap": CAP_BYTES, "error": 0 if ok else 100}


def run_fake_sweep(iters: int = 100, exec_us: int = 2000,
                   quotas=QUOTAS) -> dict[int, float] | None:
    """ms per launch+synchronize step at each quota, against the fake
    driver: the interposer's pacing with no card and no host noise."""
    shim = str(build.build_shim())
    fake = str(build.build_fake_driver())
    harness = str(build.build_shim_test())
    out: dict[int, float] = {}
    for quota in quotas:
        env = dict(os.environ)
        env.update({
            "LD_PRELOAD": shim, "SHIM_PATH": shim,
            "VTPU_REAL_CUDA_LIBRARY_PATH": fake,
            "VTPU_CORE_LIMIT_0": str(quota if quota < 100 else 0),
            "FAKE_EXEC_US": str(exec_us), "SHIM_TEST_ITERS": str(iters),
        })
        res = subprocess.run([harness, "--throttle-only"], env=env,
                             capture_output=True, text=True, timeout=120,
                             check=False)
        for line in res.stdout.splitlines():
            if line.startswith("wall="):
                out[quota] = float(line.split("=")[1].split("ms")[0]) / iters
    return out if len(out) == len(quotas) else None


def _shim_counters() -> dict:
    """The preloaded interposer's exported counters; none without it."""
    path = os.environ.get("LD_PRELOAD", "").split(":")[0]
    if not path:
        return {}
    lib = ctypes.CDLL(path)
    out = {}
    for name in ("vtpu_launches_total", "vtpu_sampled_launches_total",
                 "vtpu_throttle_wait_ns_total", "vtpu_charged_ns_total",
                 "vtpu_gap_bypass_total", "vtpu_fail_open_total",
                 "vtpu_proc_address_hooked_total"):
        fn = getattr(lib, name)
        fn.restype = (ctypes.c_int64 if name == "vtpu_charged_ns_total"
                      else ctypes.c_uint64)
        out[name] = int(fn())
    return out


def _worker(args) -> None:
    import torch

    from vtpu_manager_torch.bench_steps import quota_step_measure
    ms = quota_step_measure(dim=args.dim, warmup=args.warmup,
                            steps=args.steps)
    out = {"ms_per_step": ms, "steps": args.warmup + args.steps,
           **_shim_counters()}
    if args.kernel:
        from vtpu_manager_torch.workloads import block_attention as ba
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((8, 16, 512, 128), generator=gen,
                               device="cuda") for _ in range(3))
        bias = torch.zeros((512, 512), device="cuda")
        torch.cuda.synchronize()
        before = _shim_counters()["vtpu_launches_total"]
        kernel_before = ba.LAUNCHES["attn_block"]
        ba.attention_block(q, k, v, bias)
        torch.cuda.synchronize()
        out["kernel_shim_launches_delta"] = (
            _shim_counters()["vtpu_launches_total"] - before)
        out["kernel_launches_delta"] = (ba.LAUNCHES["attn_block"]
                                        - kernel_before)
    print("WORKER " + json.dumps(out), flush=True)


def _hbm_worker() -> None:
    import torch
    x = torch.ones((64, 64), device="cuda")
    _ = float((x * 2).sum())           # context and allocator are up
    free, total = torch.cuda.mem_get_info()
    try:
        y = torch.ones(OVER_CAP_SHAPE, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        verdict = "violation"
        del y
    except torch.cuda.OutOfMemoryError:
        verdict = "oom"
    except RuntimeError as e:           # refused, but with the wrong class
        verdict = f"unexpected: {type(e).__name__}: {str(e)[:160]}"
    print("HBM " + json.dumps({"verdict": verdict, "free": free,
                               "total": total}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--hbm-worker", action="store_true")
    ap.add_argument("--dim", type=int, default=8192)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--kernel", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args)
    elif args.hbm_worker:
        _hbm_worker()
    else:
        ap.error("bench_quota runs as a tenant worker; the sweep is driven "
                 "by chip_smoke.py")


if __name__ == "__main__":
    main()
