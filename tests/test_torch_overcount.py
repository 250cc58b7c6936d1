"""The token bucket charges a throttled tenant its kernels' device time,
not the way each launch takes to the card.

The fake driver's FAKE_SUBMIT_LATENCY_US starts work issued to an idle
device that long after the call while an event recorded there is stamped
at once, as a card does (the counterpart of FAKE_OBS_LATENCY_US,
library/test/fake_pjrt_plugin.cc:138). A throttled tenant's launches all
land on an idle stream, so each sampled span is the kernel plus that
latency; the interposer's idle-time probe measures the latency and
discounts isolated samples by it, as enforce.cc:2777-2812 discounts
isolated spans.
"""

import pytest

from vtpu_manager_torch import bench_quota

EXEC_US = 2000
ITERS = 150


@pytest.mark.parametrize("latency_us", [0, 300])
@pytest.mark.parametrize("quota", [25, 50])
def test_charged_time_per_launch_is_the_kernel(quota, latency_us):
    out = bench_quota.run_fake_harness(
        "--throttle-only", VTPU_CORE_LIMIT_0=quota, FAKE_EXEC_US=EXEC_US,
        FAKE_SUBMIT_LATENCY_US=latency_us, SHIM_TEST_ITERS=ITERS)
    assert out["rc"] == 0, out["stderr"]
    per_launch = out["vtpu_charged_ns_total"] / out["vtpu_launches_total"]
    assert per_launch == pytest.approx(EXEC_US * 1000, rel=0.03), out
    # the probe learned the latency (within a scheduler tick's noise)
    assert out["vtpu_probes_total"] > 0
    assert out["vtpu_obs_overhead_ns"] == pytest.approx(
        latency_us * 1000, abs=100_000)


def test_share_tracks_quota_with_submission_latency():
    # the kernel's share of wall time is the quota, not quota x 2000/2300
    out = bench_quota.run_fake_harness(
        "--throttle-only", VTPU_CORE_LIMIT_0=25, FAKE_EXEC_US=EXEC_US,
        FAKE_SUBMIT_LATENCY_US=300, SHIM_TEST_ITERS=ITERS)
    share = 100.0 * ITERS * EXEC_US / 1000 / out["wall_ms"]
    assert share == pytest.approx(25, abs=2.5), out
