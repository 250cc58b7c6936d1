"""The port's step loops and quota arithmetic, run on the CPU at tiny
shapes (as tests/test_bench_logic.py runs the JAX loops)."""

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
