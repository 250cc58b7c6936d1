"""The node's operator tools in the port, against the JAX package's.

`vtpu_manager_torch/tools/`: the stdlib-only CLIENT-mode registrar
(`library/tools/vtpu_device_client.py`'s counterpart, F7's repair: the
interposer runs it from beside itself, so a tenant image without the
package registers), `vtpu_inspect` (its dump of a node dir against the
JAX `vtpu_inspect`'s of the same files), `vtpu_busy` and the host-offload
demo (`examples/host_offload_demo.py`'s counterpart), each on the CPU at
a small size.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import uuid

import pytest

from vtpu_manager.registry import server as jserver
from vtpu_manager_torch import bench_quota, build
from vtpu_manager_torch.config import tc_watcher, vtpu_config as vc
from vtpu_manager_torch.config.vmem import VmemLedger
from vtpu_manager_torch.deviceplugin.vnum import install_interposer
from vtpu_manager_torch.registry import server
from vtpu_manager_torch.tools import vtpu_inspect
from vtpu_manager_torch.util import consts

REPO = str(build.REPO)
MIB = 2**20


def _without_repo(pythonpath: str) -> str:
    return os.pathsep.join(
        p for p in pythonpath.split(os.pathsep)
        if p and os.path.realpath(p) != os.path.realpath(REPO))


# --- F7: the registrar beside the interposer --------------------------------


def _client_tenant(tmp_path, cmd: str | None):
    """A CLIENT-mode harness tenant (`--alloc`, two 1 MiB allocations) with
    a PYTHONPATH that lacks the repo, started outside it; the node registry
    on a short socket path attests it by a stand-in cgroup. Returns the
    registrations, the pid set and the tenant's stderr."""
    uid = str(uuid.uuid4())
    base = tmp_path / "base"
    cfg_dir = base / f"{uid}_main" / "config"
    cfg_dir.mkdir(parents=True)
    cfg = str(cfg_dir / "vtpu.config")
    bench_quota.tenant_config(cfg, uid, cap=64 * MIB,
                              compat_mode=consts.COMPAT_CLIENT)
    tenant: list[int] = []
    sock_dir = tempfile.mkdtemp(prefix="vreg")
    reg = server.RegistryServer(
        socket_path=os.path.join(sock_dir, "r.sock"), base_dir=str(base),
        cgroup_of_pid=lambda pid: f"/kubepods/burstable/pod{uid}/c1",
        pids_in_cgroup=lambda cg: list(tenant))
    reg.start()
    step = str(tmp_path / "step")
    env = bench_quota.fake_harness_env(
        VTPU_CONFIG_PATH=cfg, VTPU_POD_UID=uid, VTPU_CONTAINER_NAME="main",
        VTPU_LOGGER_LEVEL=2, VTPU_REGISTRY_SOCKET=reg.socket_path,
        SHIM_TEST_ALLOCS=f"{MIB},{MIB}", SHIM_TEST_STEP_FILE=step)
    env["PYTHONPATH"] = _without_repo(env.get("PYTHONPATH", ""))
    env.pop(consts.ENV_DEVICE_CLIENT_CMD, None)
    if cmd is not None:
        env[consts.ENV_DEVICE_CLIENT_CMD] = cmd
    outside = tmp_path / "outside"
    outside.mkdir()
    proc = subprocess.Popen([str(build.build_shim_test()), "--alloc"],
                            env=env, cwd=str(outside),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    tenant.append(proc.pid)
    try:
        deadline = time.monotonic() + (20 if cmd is None else 4)
        while not reg.registrations and time.monotonic() < deadline:
            time.sleep(0.05)
        open(f"{step}.1", "w").close()
        _, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reg.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert proc.returncode == 0, stderr
    pids_path = cfg_dir / consts.PIDS_CONFIG_NAME
    pids = (jserver.read_pids_config(str(pids_path))
            if pids_path.exists() else [])
    return reg.registrations, pids, proc.pid, stderr


def test_a_tenant_without_the_package_registers_through_the_script(
        tmp_path):
    """F7's pin: no VTPU_DEVICE_CLIENT_CMD, no package on the path or in
    the cwd; the interposer runs the registrar it finds beside itself, and
    the registration lands with the tenant's pid."""
    regs, pids, pid, stderr = _client_tenant(tmp_path, None)
    script = os.path.join(os.path.dirname(str(build.build_shim())),
                          consts.DEVICE_CLIENT_SCRIPT)
    assert f"device-client spawned: python3 '{script}'" in stderr, stderr
    assert len(regs) == 1 and pid in pids, (regs, pids)
    assert regs[0]["peer_pid"] in pids and len(pids) == 2
    assert "client pid set refreshed (2 pids)" in stderr, stderr


def test_the_module_alone_registers_nothing_from_there(tmp_path):
    """What the interposer ran before the repair, from the same tenant:
    the module does not import, the spawn still logs success, nothing
    registers."""
    regs, pids, _, stderr = _client_tenant(
        tmp_path, "python3 -m vtpu_manager_torch.runtime.client")
    assert "device-client spawned" in stderr
    assert not regs and not pids


def _load_registrar():
    import importlib.util
    spec = importlib.util.spec_from_file_location("vtpu_device_client",
                                                  build.REGISTRAR)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_registrar_speaks_the_registry_protocol(tmp_path, monkeypatch):
    """The script as a process (the peer the registry attests) against the
    port's registry registers; a uid that is not its cgroup's pod is
    refused."""
    uid = str(uuid.uuid4())
    base = tmp_path / "base"
    (base / f"{uid}_main" / "config").mkdir(parents=True)
    sock_dir = tempfile.mkdtemp(prefix="vreg")
    reg = server.RegistryServer(
        socket_path=os.path.join(sock_dir, "r.sock"), base_dir=str(base),
        cgroup_of_pid=lambda pid: f"/kubepods/burstable/pod{uid}/c1",
        pids_in_cgroup=lambda cg: [])
    reg.start()
    env = {"PATH": os.environ.get("PATH", ""),
           "VTPU_REGISTRY_SOCKET": reg.socket_path,
           "VTPU_POD_UID": uid, "VTPU_CONTAINER_NAME": "main"}
    try:
        ok = subprocess.run([sys.executable, str(build.REGISTRAR)], env=env,
                            cwd=str(tmp_path), capture_output=True,
                            text=True, timeout=60)
        registrar = _load_registrar()
        monkeypatch.setenv("VTPU_POD_UID", str(uuid.uuid4()))
        monkeypatch.setenv("VTPU_CONTAINER_NAME", "main")
        refused = registrar.register_once(reg.socket_path)
    finally:
        reg.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert ok.returncode == 0 and "registered" in ok.stderr, ok.stderr
    assert len(reg.registrations) == 1
    assert reg.registrations[0]["pod_uid"] == uid
    assert refused is False
    # nothing listens: a refusal, not an exception
    assert registrar.register_once(str(tmp_path / "none.sock")) is False


@pytest.mark.parametrize("sampled", ["true", "false"])
def test_the_registrar_records_its_side_of_a_traced_registration(
        tmp_path, sampled):
    """A traced tenant's registrar spools one `shim.register` span per
    attempt, as the port's recorder writes one: the pod's timeline reads
    it beside the registry's `registry.register`. An unsampled tenant
    spools nothing."""
    from vtpu_manager_torch.trace import assemble
    uid = str(uuid.uuid4())
    base = tmp_path / "base"
    (base / f"{uid}_main" / "config").mkdir(parents=True)
    spool = tmp_path / "trace"
    sock_dir = tempfile.mkdtemp(prefix="vreg")
    reg = server.RegistryServer(
        socket_path=os.path.join(sock_dir, "r.sock"), base_dir=str(base),
        cgroup_of_pid=lambda pid: f"/kubepods/burstable/pod{uid}/c1",
        pids_in_cgroup=lambda cg: [])
    reg.start()
    env = {"PATH": os.environ.get("PATH", ""),
           "VTPU_REGISTRY_SOCKET": reg.socket_path,
           "VTPU_POD_UID": uid, "VTPU_CONTAINER_NAME": "main",
           consts.ENV_TRACE_ID: "trace-f7", consts.ENV_TRACE_SAMPLED: sampled,
           consts.ENV_TRACE_DIR: str(spool)}
    try:
        t0 = time.time()
        res = subprocess.run([sys.executable, str(build.REGISTRAR)], env=env,
                             cwd=str(tmp_path), capture_output=True,
                             text=True, timeout=60)
    finally:
        reg.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert res.returncode == 0, res.stderr
    assert len(reg.registrations) == 1
    if sampled == "false":
        assert not spool.exists()
        return
    spans, _ = assemble.read_spools(str(spool))
    (span,) = spans
    assert (span.stage, span.trace_id, span.pod_uid, span.service) == (
        "shim.register", "trace-f7", uid, "tenant")
    assert t0 <= span.start_s <= time.time() and 0 < span.dur_s < 60


def test_build_and_install_put_the_registrar_beside_the_interposer(
        tmp_path):
    shim = build.build_shim()
    beside = shim.parent / consts.DEVICE_CLIENT_SCRIPT
    assert beside.read_bytes() == build.REGISTRAR.read_bytes()
    driver = tmp_path / "driver"
    dst = install_interposer(str(shim), str(driver))
    assert dst == str(driver / consts.CONTROL_LIBRARY_NAME)
    assert (driver / consts.DEVICE_CLIENT_SCRIPT).read_bytes() == \
        build.REGISTRAR.read_bytes()
    # an interposer with no registrar beside it: the package's copy
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy2(shim, lone / "lib.so")
    install_interposer(str(lone / "lib.so"), str(tmp_path / "driver2"))
    assert (tmp_path / "driver2" / consts.DEVICE_CLIENT_SCRIPT).exists()


def test_the_interposer_hooks_no_host_allocation():
    """Host memory is never charged to the cap (the reference's rule for
    host memory spaces): the interposer exports no host allocation entry,
    and its cuGetProcAddress routes none."""
    out = subprocess.run(["nm", "-D", "--defined-only",
                          str(build.build_shim())], capture_output=True,
                         text=True, check=True).stdout
    names = {ln.split()[-1] for ln in out.splitlines() if ln.strip()}
    assert "cuMemAlloc_v2" in names and "vtpu_peak_bytes" in names
    assert not {n for n in names if n.startswith(("cuMemHostAlloc",
                                                  "cuMemAllocHost",
                                                  "cuMemHostRegister"))}
    src = (build.SHIM_SRC / "loader.cc").read_text()
    assert '"cuMemAllocHost' not in src and '"cuMemHostAlloc' not in src


# --- vtpu_inspect against the JAX tool --------------------------------------


def _node(tmp_path):
    """A node dir: two containers' configs (one with a lease, a freeze and
    a pid set), a ledger with two entries, a feed with a record and no
    calibration."""
    base = tmp_path / "mgr"
    for uid, hard, lease, freeze in (("uid-a", 25, 25, 0),
                                     ("uid-b", 60, -25, 1)):
        path = base / f"{uid}_main" / "config" / "vtpu.config"
        path.parent.mkdir(parents=True)
        vc.write_config(str(path), vc.VtpuConfig(
            pod_uid=uid, pod_name=uid, pod_namespace="default",
            container_name="main", workload_class=1, quota_epoch=7,
            migration_freeze=freeze, freeze_epoch=freeze,
            devices=[vc.DeviceConfig(
                uuid="GPU-0", total_memory=8 << 30, real_memory=80 << 30,
                hard_core=hard, soft_core=hard,
                core_limit=vc.CORE_LIMIT_HARD, memory_limit=True,
                lease_core=lease, host_index=0)]))
    server.write_pids_config(str(base / "uid-a_main" / "config" /
                                 consts.PIDS_CONFIG_NAME), [11, 12])
    vmem = str(tmp_path / "vmem_node.config")
    ledger = VmemLedger(vmem, create=True)
    ledger.record(os.getpid(), 0, 3 * MIB, owner_token=0xABC)
    ledger.record(os.getppid(), 0, 5 * MIB, owner_token=0xDEF)
    ledger.close()
    tc = str(tmp_path / "tc_util.config")
    feed = tc_watcher.TcUtilFile(tc, create=True)
    feed.write_device(0, tc_watcher.DeviceUtil(
        timestamp_ns=time.monotonic_ns(), device_util=42,
        procs=[tc_watcher.ProcUtil(pid=os.getpid(), util=30,
                                   mem_used=3 * MIB, owner_token=0xABC)]))
    feed.close()
    return str(base), vmem, tc


def test_inspect_dumps_what_the_jax_tool_reads(tmp_path):
    base, vmem, tc = _node(tmp_path)
    args = ["--base", base, "--vmem", vmem, "--tc", tc]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    theirs = subprocess.run(
        [sys.executable, os.path.join(REPO, "library", "tools",
                                      "vtpu_inspect.py"), *args],
        env=env, capture_output=True, text=True, timeout=120)
    mine = subprocess.run(
        [sys.executable, "-m", "vtpu_manager_torch.tools.vtpu_inspect",
         *args], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert theirs.returncode == mine.returncode == 0, theirs.stderr
    shared = [ln for ln in mine.stdout.splitlines()
              if not vtpu_inspect.port_only(ln)]
    assert shared == theirs.stdout.splitlines()
    extra = [ln.strip() for ln in mine.stdout.splitlines()
             if vtpu_inspect.port_only(ln)]
    assert extra == [
        "quota: epoch=7 class=1 freeze=0 freeze_epoch=0",
        "dev[0] lease=+25 effective=50",
        "quota: epoch=7 class=1 freeze=1 freeze_epoch=1",
        "dev[0] lease=-25 effective=35"]
    assert "pids: [11, 12]" in mine.stdout


def test_inspect_of_an_empty_node_equals_the_jax_tools(tmp_path):
    args = ["--base", str(tmp_path / "none"), "--vmem",
            str(tmp_path / "none"), "--tc", str(tmp_path / "none")]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    theirs = subprocess.run(
        [sys.executable, os.path.join(REPO, "library", "tools",
                                      "vtpu_inspect.py"), *args],
        env=env, capture_output=True, text=True, timeout=120)
    mine = subprocess.run(
        [sys.executable, "-m", "vtpu_manager_torch.tools.vtpu_inspect",
         *args], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert mine.stdout == theirs.stdout


# --- vtpu_busy and the host-offload demo on the CPU -------------------------


def _last_json(stdout: str, tag: str) -> dict:
    line = next(ln for ln in reversed(stdout.splitlines())
                if ln.startswith(tag + " "))
    return json.loads(line[len(tag) + 1:])


def test_busy_runs_its_duty_and_reports_the_share(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "vtpu_manager_torch.tools.vtpu_busy",
         "--device", "cpu", "--dim", "64", "--duty", "50",
         "--period-ms", "100", "--seconds", "0.6", "--report-every", "0.2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    rec = _last_json(res.stdout, "VTPU_BUSY")
    assert rec["device"] == "cpu" and rec["steps"] > 0
    # the share counts the least step, never more than the duty's time
    assert 0 < rec["effective_pct"] <= 50 + 5, rec
    assert re.search(r"^effective +[0-9.]+% of card", res.stdout, re.M)


def test_busy_refuses_a_sleep_step_off_the_card():
    res = subprocess.run(
        [sys.executable, "-m", "vtpu_manager_torch.tools.vtpu_busy",
         "--device", "cpu", "--step", "sleep", "--seconds", "0.1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "needs the card" in res.stderr


def test_the_offload_demo_streams_layers_and_agrees_with_one_pass():
    import torch

    from vtpu_manager_torch.tools import host_offload_demo as demo
    weights, x = demo.make_layers(torch, 3, 64, 8, seed=0)
    streamed = demo.streamed_forward(torch, demo.offload(
        weights, torch.device("cpu")), x, torch.device("cpu"))
    ref = x
    for w in weights:
        ref = torch.tanh(ref @ w)
    assert torch.equal(streamed, ref)
    res = subprocess.run(
        [sys.executable, "-m", "vtpu_manager_torch.tools.host_offload_demo",
         "--device", "cpu", "--layers", "3", "--width", "64", "--batch", "8",
         "--check"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    rec = _last_json(res.stdout, "HOST_OFFLOAD")
    assert rec["finite"] and rec["shape"] == [8, 64]
    assert rec["model_bytes"] == 3 * 64 * 64 * 2
    # bf16 products against float32 ones rounded per layer
    assert 0 <= rec["max_abs_err"] <= 3e-2, rec


@pytest.mark.parametrize("tool", ["vtpu_busy", "host_offload_demo"])
def test_the_tools_refuse_a_missing_card(tool):
    """On the card unless the CPU is asked for: no card is an error."""
    res = subprocess.run(
        [sys.executable, "-m", f"vtpu_manager_torch.tools.{tool}",
         "--seconds" if tool == "vtpu_busy" else "--layers", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and "no CUDA device" in res.stderr
