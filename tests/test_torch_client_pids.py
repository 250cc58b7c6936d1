"""CLIENT compat mode in the interposer: the registry-attested pid set.

The interposer against the fake driver, as tests/test_torch_shim.py runs
it. A ledger entry without an owner token is one of the tenant's own
processes when the container's `pids.config` names its pid and the config
carries the client bit, and a co-tenant otherwise, as
`library/src/enforce.cc:513-514` decides; a rewritten `pids.config` is read
again and a corrupt one leaves the set as it was. In CLIENT mode the
interposer starts the device client, which registers over the node
registry's socket, and the registry's pid set reaches the interposer.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
import uuid

import pytest

from vtpu_manager.registry import server as jserver
from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.config.vmem import VmemLedger
from vtpu_manager_torch.registry import server
from vtpu_manager_torch.util import consts

MIB = 2**20
CAP = 64 * MIB
PLANTED = 48 * MIB     # the tokenless entry
OK, OOM = 0, 2


@pytest.fixture
def planted(tmp_path):
    """A private node whose ledger holds a live process's 48 MiB with no
    owner token (a tenant process the interposer did not register)."""
    world = bench_quota.World(str(tmp_path / "node"))
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(120)"])
    ledger = VmemLedger(world.vmem_path)
    ledger.record(proc.pid, 0, PLANTED, owner_token=0)
    ledger.close()
    try:
        yield world, proc.pid
    finally:
        proc.kill()
        proc.wait()


def tenant_env(world, tmp_path, compat: int, **extra) -> dict:
    cfg_dir = tmp_path / "uid-a_main" / "config"
    cfg_dir.mkdir(parents=True)
    path = str(cfg_dir / "vtpu.config")
    bench_quota.tenant_config(path, "uid-a", cap=CAP, compat_mode=compat)
    env = bench_quota.fake_harness_env(
        VTPU_CONFIG_PATH=path, VTPU_VMEM_PATH=world.vmem_path,
        VTPU_LOCK_DIR=world.lock_dir, VTPU_POD_UID="uid-a",
        VTPU_CONTAINER_NAME="main", VTPU_LOGGER_LEVEL=2,
        # CLIENT mode starts a device client; nothing registers here
        VTPU_DEVICE_CLIENT_CMD="true", **extra)
    return env


@pytest.mark.parametrize("compat", ["client", "host"])
def test_a_tokenless_entry_of_the_pid_set_shares_the_cap(planted, tmp_path,
                                                         compat):
    world, pid = planted
    bit = consts.COMPAT_CLIENT if compat == "client" else consts.COMPAT_HOST
    env = tenant_env(world, tmp_path, bit, SHIM_TEST_ALLOCS=32 * MIB)
    server.write_pids_config(
        str(tmp_path / "uid-a_main" / "config" / consts.PIDS_CONFIG_NAME),
        [pid])
    res = subprocess.run([str(build.build_shim_test()), "--alloc"], env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    verdict = bench_quota.parse_harness(res.stdout)["verdicts"]["alloc0"]
    if compat == "client":
        # a sibling: 48 MiB of the 64 MiB cap are taken, 32 do not fit
        assert verdict == OOM, res.stdout + res.stderr
        assert "client pid set refreshed (1 pids)" in res.stderr
    else:
        # a co-tenant counts only against the card's memory
        assert verdict == OK, res.stdout + res.stderr
        assert "client pid set" not in res.stderr


def test_a_rewritten_pid_set_is_read_again_and_a_corrupt_one_ignored(
        planted, tmp_path):
    world, pid = planted
    pids_path = str(tmp_path / "uid-a_main" / "config" /
                    consts.PIDS_CONFIG_NAME)
    step = str(tmp_path / "step")
    env = tenant_env(world, tmp_path, consts.COMPAT_CLIENT,
                     SHIM_TEST_ALLOCS=f"{32 * MIB},{16 * MIB},{16 * MIB}",
                     SHIM_TEST_STEP_FILE=step)
    server.write_pids_config(pids_path, [])
    proc = subprocess.Popen([str(build.build_shim_test()), "--alloc"],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        # the planted process is not in the set: 32 MiB fit the cap
        assert proc.stdout.readline().split() == ["VERDICT", "alloc0", "0"]
        server.write_pids_config(pids_path, [pid])
        open(f"{step}.1", "w").close()
        # now a sibling: 32 own + 48 + 16 is over the cap
        assert proc.stdout.readline().split() == ["VERDICT", "alloc1", "2"]
        with open(pids_path, "wb") as f:
            f.write(b"not a pid set")
        open(f"{step}.2", "w").close()
        # the corrupt file leaves the set as it was
        assert proc.stdout.readline().split() == ["VERDICT", "alloc2", "2"]
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stderr
    assert "client pid set refreshed (0 pids)" in stderr
    assert "client pid set refreshed (1 pids)" in stderr
    assert "does not decode; keeping the last" in stderr


def test_the_interposer_starts_the_device_client_that_registers(tmp_path):
    """CLIENT mode end to end on the CPU: the interposer spawns the
    registrar beside it (the build dir's `vtpu_device_client.py`), which
    registers over the registry socket; the
    registry attests the peer (a stand-in cgroup that embeds the pod uid,
    as tests/test_registry.py's fixture), writes pids.config, and the
    interposer reads the set it wrote."""
    uid = str(uuid.uuid4())
    base = tmp_path / "base"
    cfg_dir = base / f"{uid}_main" / "config"
    cfg_dir.mkdir(parents=True)
    cfg = str(cfg_dir / "vtpu.config")
    bench_quota.tenant_config(cfg, uid, cap=CAP,
                              compat_mode=consts.COMPAT_CLIENT)
    tenant: list[int] = []
    sock_dir = tempfile.mkdtemp(prefix="vreg")   # a short unix path
    reg = server.RegistryServer(
        socket_path=os.path.join(sock_dir, "r.sock"), base_dir=str(base),
        cgroup_of_pid=lambda pid: f"/kubepods/burstable/pod{uid}/c1",
        pids_in_cgroup=lambda cg: list(tenant))
    reg.start()
    step = str(tmp_path / "step")
    env = bench_quota.fake_harness_env(
        VTPU_CONFIG_PATH=cfg, VTPU_POD_UID=uid, VTPU_CONTAINER_NAME="main",
        VTPU_LOGGER_LEVEL=2, VTPU_REGISTRY_SOCKET=reg.socket_path,
        PYTHONPATH=str(build.REPO), SHIM_TEST_ALLOCS=f"{MIB},{MIB}",
        SHIM_TEST_STEP_FILE=step)
    env.pop(consts.ENV_DEVICE_CLIENT_CMD, None)
    proc = subprocess.Popen([str(build.build_shim_test()), "--alloc"],
                            env=env, cwd=str(build.REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    tenant.append(proc.pid)
    try:
        deadline = time.monotonic() + 30
        while not reg.registrations and time.monotonic() < deadline:
            time.sleep(0.05)
        open(f"{step}.1", "w").close()
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reg.stop()
    assert proc.returncode == 0, stderr
    assert "device-client spawned" in stderr, stderr
    assert len(reg.registrations) == 1, reg.registrations
    got = reg.registrations[0]
    assert got["pod_uid"] == uid and got["container"] == "main"
    # the tenant's pid and the registrar's, which the kernel attested
    pids = jserver.read_pids_config(str(cfg_dir / consts.PIDS_CONFIG_NAME))
    assert proc.pid in pids and got["peer_pid"] in pids and len(pids) == 2
    assert "client pid set refreshed (2 pids)" in stderr, stderr
