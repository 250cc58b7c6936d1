"""The port's step loops and quota arithmetic, run on the CPU at tiny
shapes (as tests/test_bench_logic.py runs the JAX loops)."""

import os
import pytest
import torch

from vtpu_manager_torch import bench_quota, bench_steps
from vtpu_manager_torch.util import torchplatform
from vtpu_manager_torch.util.torchplatform import cap_cpu_threads


@pytest.fixture(autouse=True, scope="module")
def _threads():
    cap_cpu_threads()


def test_quota_step_measure_runs():
    ms = bench_steps.quota_step_measure(dim=32, warmup=1, steps=3,
                                        device="cpu")
    assert ms > 0


def test_step_device_share_needs_the_card():
    with pytest.raises(ValueError):
        bench_steps.step_device_share(dim=32, warmup=1, steps=1, device="cpu")


def test_mfu_measure_on_cpu_has_no_mfu(capsys):
    out = bench_steps.mfu_measure(n=32, inner=2, reads=2, device="cpu")
    assert out["tflops"] > 0 and out["wall_s"] > 0
    assert out["mfu_pct"] is None and out["device"] == "cpu"
    assert "'cpu'" in capsys.readouterr().err


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H200", 989e12),
    ("NVIDIA A100-SXM4-80GB", None),
    ("TPU v5 lite", None),
])
def test_peak_lookup_by_card_name(name, peak):
    assert bench_steps.bf16_peak_flops(name) == peak


def test_paired_sweep_shares_and_mae():
    ms = {100: 2.0, 50: 4.2, 25: 7.6}
    calls = []

    def run(quota):
        calls.append(quota)
        return {"ms_per_step": ms[quota]}

    times, shares, records = bench_quota.paired_quota_sweep(run)
    assert calls == [100, 100, 100, 50, 100, 25]
    assert shares[100] == pytest.approx(100.0)
    assert shares[50] == pytest.approx(100 * 2.0 / 4.2)
    assert shares[25] == pytest.approx(100 * 2.0 / 7.6)
    assert times[100] == 2.0 and len(records) == 6
    mae = bench_quota.tracking_mae(shares)
    assert mae == pytest.approx((abs(shares[50] - 50)
                                 + abs(shares[25] - 25)) / 2)


def test_paired_sweep_skips_failed_pairs():
    def run(quota):
        return None if quota == 25 else {"ms_per_step": 1.0}

    times, shares, _ = bench_quota.paired_quota_sweep(run, reps=2)
    assert 25 not in shares and 50 in shares


def test_tenant_env_preloads_only_the_child(tmp_path, monkeypatch):
    shim = tmp_path / "libvtpu-cuda-control.so"
    shim.write_bytes(b"")
    monkeypatch.delenv("LD_PRELOAD", raising=False)
    env = bench_quota.tenant_env(str(shim), quota=50, mem_limit=1024)
    assert env["LD_PRELOAD"].split(":")[0] == str(shim)
    assert env["VTPU_CORE_LIMIT_0"] == "50"
    assert env["VTPU_MEM_LIMIT_0"] == "1024"
    assert bench_quota.tenant_env(str(shim), 100)["VTPU_CORE_LIMIT_0"] == "0"
    assert "LD_PRELOAD" not in bench_quota.tenant_env(None, 100)
    import os
    assert "LD_PRELOAD" not in os.environ


def test_resolve_device():
    assert torchplatform.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            torchplatform.resolve_device(None)
    with pytest.raises(ValueError):
        torchplatform.resolve_device("meta")


def test_exact_fp32_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torchplatform.exact_fp32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


class _Event:
    """A torch.profiler event as `kernel_reading` reads it."""

    def __init__(self, name, us, device="CUDA"):
        self.name = name
        self.device_type = type("D", (), {"name": device})()
        self.time_range = type("R", (), {"start": 0, "end": us})()


@pytest.mark.parametrize("case", ["whole", "repeated", "dropped", "slow"])
def test_kernel_reading_tells_events_from_slow_runs(case):
    """Over 4 steps of a 1000 us, a 100 us and two 50 us kernels: the
    median reading holds where the profile repeats or drops an event, the
    sum does not, and the counts and the longest run say which of those
    happened; the interposer's own slice-clock kernel is left out."""
    gemm = [1000.0] * 4
    if case == "repeated":
        gemm.append(1000.0)
    elif case == "dropped":
        gemm.pop()
    elif case == "slow":
        gemm[0] = 1400.0
    long = "void at::native::elementwise_kernel<128, 4, at::native::gpu_"
    events = ([_Event("gemm", us) for us in gemm]
              + [_Event("add", 100.0) for _ in range(4)]
              + [_Event(long + "mul", 50.0) for _ in range(4)]
              + [_Event(long + "div", 50.0) for _ in range(4)]
              + [_Event("Memcpy HtoD", 500.0), _Event("cpu_op", 9e9, "CPU"),
                 _Event("vtpu_slice_watch", 1300.0)])
    prof = type("P", (), {"events": lambda self: events})()
    r = bench_steps.kernel_reading(prof, steps=4)
    assert r["median_ms"] == pytest.approx(1.2)
    assert r["kernels"]["add"] == [4, 0.1, pytest.approx(0.1), 0.1]
    count, median, _, longest = r["kernels"]["gemm"]
    assert (count, median) == ({"whole": 4, "repeated": 5, "dropped": 3,
                                "slow": 4}[case], 1.0)
    assert longest == (1.4 if case == "slow" else 1.0)
    assert r["sum_ms"] == pytest.approx(
        {"whole": 1.2, "repeated": 1.45, "dropped": 0.95,
         "slow": 1.3}[case])
    # two kernels alike in their first 60 characters each keep a line
    assert sorted(k for k in r["kernels"] if k.startswith(long)) == [
        long, long + "#1"]
    assert "vtpu_slice_watch" not in r["kernels"]


# --- the tenant pool -----------------------------------------------------------


def _pool_env(preload: str = "") -> dict:
    from vtpu_manager_torch import build
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "DISABLE_VTPU"))}
    env.update({"LD_PRELOAD": preload, "PYTHONPATH": str(build.REPO),
                "VTPU_POD_UID": "uid-pool"})
    return env


def test_pooled_tenants_run_as_the_tenants_they_are_given(tmp_path):
    """Two workers from a pool of processes started ahead (imports done,
    no device touched): each takes its tenant's argv and environment, runs
    its steps on the CPU, and the pool starts new ones once the batch's
    timed steps are done."""
    from vtpu_manager_torch import bench_quota as bq
    world = bq.World(str(tmp_path / "node"))
    pool = bq.TenantPool(str(world.root), "", size=2)
    try:
        args = [*bq.worker_args(3, dim=16), "--device", "cpu"]
        env_a = {**_pool_env(), "VTPU_CONTAINER_NAME": "a"}
        out = bq.run_tenants(world, [("a", args, env_a),
                                     ("b", args, _pool_env())], pool=pool)
        assert set(out) == {"a", "b"}
        for rec in out.values():
            assert rec["timed_steps"] == 3 and rec["ms_per_step"] > 0
        assert pool.started == 4 and len(pool.idle) == 2
    finally:
        pool.close()


def test_a_pooled_process_refuses_another_interposer(tmp_path):
    from vtpu_manager_torch import bench_quota as bq
    world = bq.World(str(tmp_path / "node"))
    pool = bq.TenantPool(str(world.root), "", size=1)
    try:
        t = pool.take("x", [*bq.worker_args(3, dim=16), "--device", "cpu"],
                      _pool_env(preload="/no/such/interposer.so"))
        assert t.proc.wait(timeout=120) != 0
        assert "pooled under LD_PRELOAD=''" in t.stderr_tail()
        t.stop()
    finally:
        pool.close()
