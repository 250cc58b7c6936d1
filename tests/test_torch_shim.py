"""The CUDA interposer, built with g++ and driven against the fake driver.

The harness (csrc/shim/test/cuda_shim_test.cc) runs as a tenant runs: the
interposer in LD_PRELOAD, the fake libcuda.so.1 as the real driver, and
every entry point reached the way the CUDA runtime reaches it.
"""

import subprocess
import tempfile
from pathlib import Path

import pytest

from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.util import consts

CAP = 1 << 20
SHARE_BAND = 15.0


@pytest.fixture(scope="module")
def artifacts():
    return {"shim": str(build.build_shim()),
            "fake": str(build.build_fake_driver()),
            "harness": str(build.build_shim_test())}


def _run(artifacts, mode, **env_extra):
    return subprocess.run([artifacts["harness"], mode],
                          env=bench_quota.fake_harness_env(**env_extra),
                          capture_output=True, text=True, timeout=60,
                          check=False)


def test_every_route_lands_on_its_hook(artifacts):
    res = _run(artifacts, "--routes")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ROUTES OK" in res.stdout
    # exported name, dlsym override, cuGetProcAddress v2 and v1, pass-through
    for label in ("export:cuMemGetInfo_v2", "dlsym:cuGetProcAddress_v2",
                  "proc:cuLaunchKernel/ptsz", "proc:cuMemAlloc",
                  "proc-v1:cuLaunchKernel", "proc:cuEventQuery"):
        assert f"ROUTE {label} ok" in res.stdout


def _verdicts(stdout):
    out = {}
    for line in stdout.splitlines():
        parts = line.split()
        if parts and parts[0] == "VERDICT":
            out[parts[1]] = int(parts[2])
        elif parts and parts[0] == "MEMINFO":
            out[f"meminfo_{parts[1]}"] = tuple(
                int(p.split("=")[1]) for p in parts[2:])
        elif parts and parts[0] == "TOTALMEM":
            out["totalmem"] = int(parts[1])
    return out


OOM = 2   # CUDA_ERROR_OUT_OF_MEMORY


def test_cap_verdicts_are_exact(artifacts):
    res = _run(artifacts, "--caps", VTPU_MEM_LIMIT_0=CAP)
    assert res.returncode == 0, res.stderr
    v = _verdicts(res.stdout)
    assert v["under"] == 0 and v["at_cap"] == 0
    assert v["over_by_one"] == OOM
    assert v["free"] == 0 and v["after_free"] == 0   # a free returns credit
    assert v["async_over"] == OOM
    assert v["create_over"] == OOM and v["create_at_cap"] == 0
    assert v["alloc_while_created"] == OOM
    assert v["release"] == 0 and v["alloc_after_release"] == 0


def test_memory_view_is_the_cap(artifacts):
    v = _verdicts(_run(artifacts, "--caps", VTPU_MEM_LIMIT_0=CAP).stdout)
    assert v["meminfo_start"] == (CAP, CAP)        # free, total
    assert v["meminfo_full"] == (0, CAP)
    assert v["totalmem"] == CAP


def test_disabled_control_passes_through(artifacts):
    res = _run(artifacts, "--caps", VTPU_MEM_LIMIT_0=CAP,
               DISABLE_VTPU_CONTROL=1)
    v = _verdicts(res.stdout)
    assert v["over_by_one"] == 0 and v["create_over"] == 0
    assert v["meminfo_start"][1] == 16 << 30          # the fake's total


@pytest.mark.parametrize("quota", [0, 50])
def test_every_launch_is_counted(artifacts, quota):
    res = _run(artifacts, "--throttle-only", VTPU_CORE_LIMIT_0=quota,
               FAKE_EXEC_US=500, SHIM_TEST_ITERS=20)
    assert res.returncode == 0, res.stderr
    assert "shim_launches=20" in res.stdout


def test_fake_sweep_tracks_quota():
    # paired as the card's sweep is: an unpaired t100 carries the host's
    # stalls under a loaded suite into both shares
    sweep = bench_quota.paired_fake_sweep()
    assert sweep is not None
    _, shares = sweep
    for quota in (50, 25):
        assert abs(shares[quota] - quota) <= SHARE_BAND, shares
    assert bench_quota.tracking_mae(shares) <= SHARE_BAND


def test_concurrent_tenant_threads(artifacts):
    # 8 threads allocate, free and launch at once under a cap and a quota
    res = _run(artifacts, "--stress", VTPU_MEM_LIMIT_0=CAP,
               VTPU_CORE_LIMIT_0=50, FAKE_EXEC_US=1)
    assert res.returncode == 0, res.stderr
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("STRESS"))
    got = {k: int(v) for k, v in (f.split("=") for f in line.split()[1:])}
    assert got["granted"] > 0 and got["refused"] > 0
    assert got["max_used"] <= CAP                  # the cap held throughout
    assert got["end_used"] == 0 and got["end_free"] == CAP   # ledger drained
    assert got["launches"] == got["forwarded"] == got["expected"]


NODE_KEYS = (consts.ENV_LOCK_DIR, consts.ENV_CONFIG_PATH, consts.ENV_VMEM_PATH,
             consts.ENV_TC_UTIL_PATH)


def test_runs_stay_on_a_private_node(artifacts):
    # the harness and the sweep's tenants get the four node paths in a
    # directory of this process's own under $TMPDIR
    tmp = Path(tempfile.gettempdir()).resolve()
    envs = (bench_quota.fake_harness_env(),
            bench_quota.tenant_env(artifacts["shim"], 50, CAP))
    for env in envs:
        paths = [Path(env[key]).resolve() for key in NODE_KEYS]
        root = paths[0].parent
        assert root.parent == tmp and root.name.startswith("vtpu-node-")
        assert all(p.parent == root for p in paths)
    # a capped run takes the device lock there, and maps no ledger or feed
    res = _run(artifacts, "--caps", VTPU_MEM_LIMIT_0=CAP, VTPU_LOGGER_LEVEL=2)
    assert res.returncode == 0, res.stderr
    locks = [Path(line.split(" lock: ")[1]) for line in res.stderr.splitlines()
             if " lock: " in line]
    assert locks and all(p.parent == Path(envs[0][consts.ENV_LOCK_DIR])
                         and p.exists() for p in locks)
    for fixed in (consts.LOCK_DIR, consts.VMEM_DIR, "/etc/vtpu-manager"):
        assert fixed not in res.stderr
    assert "ledger mapped" not in res.stderr
    assert "feed mapped" not in res.stderr
