"""CommTelemetry in the port against the JAX package (tests/test_comm.py).

The gate and its Allocate env, the device plugin's rule that the gate needs
StepTelemetry, the Python writer's comm deltas (records byte for byte the
JAX writer's for the same counter sequences), and the exporter's
`vtpu_tenant_comm_*` families (the port's collector against the JAX one
over the same rings, and the `step_stats` splice). The interposer's side,
on the fake driver, is tests/test_torch_comm_shim.py.
"""

import copy
import os
import logging

import pytest

from vtpu_manager.deviceplugin.api import deviceplugin_pb2 as jpb
from vtpu_manager.device.types import fake_chip
from vtpu_manager.runtime import client as jax_client
from vtpu_manager.telemetry import aggregate as jax_aggregate
from vtpu_manager.telemetry import stepring as jax_stepring
from vtpu_manager.util import consts as jc
from vtpu_manager.util import featuregates as jax_fg
from vtpu_manager_torch.cmd import device_plugin as dp
from vtpu_manager_torch.deviceplugin.vnum import device_id
from vtpu_manager_torch.runtime import client as port_client
from vtpu_manager_torch.telemetry import aggregate as port_aggregate
from vtpu_manager_torch.telemetry import stepring
from vtpu_manager_torch.util import consts
from vtpu_manager_torch.util import featuregates as fg

from test_torch_deviceplugin import (alloc, committed_pod, jax_plugin,
                                     plugin)  # noqa: F401 (fixture)
from test_torch_device_monitor import Exporter, node_dir
from test_torch_metrics import _mk_config_dir, _ring, collectors, masked

GIB = 2**30


# --- the gate and Allocate --------------------------------------------------

@pytest.mark.parametrize("side", ["jax", "port"])
def test_gate_registered_default_off(side):
    mod = jax_fg if side == "jax" else fg
    gates = mod.FeatureGates()
    assert mod.COMM_TELEMETRY == "CommTelemetry"
    assert not gates.enabled(mod.COMM_TELEMETRY)
    gates.parse("CommTelemetry=true")
    assert gates.enabled(mod.COMM_TELEMETRY)


def test_env_name_is_the_jax_one():
    assert consts.ENV_COMM_TELEMETRY == jc.ENV_COMM_TELEMETRY == \
        "VTPU_COMM_TELEMETRY"


@pytest.mark.parametrize("step", [False, True])
@pytest.mark.parametrize("comm", [False, True])
def test_allocate_envs_equal_jax(plugin, tmp_path, step, comm):  # noqa: F811
    """The comm env only beside the ring's, as the JAX Allocate writes it
    (`deviceplugin/vnum.py:560-567`): both plugins, the same pod."""
    p, client, mgr = plugin
    p.step_telemetry_enabled = step
    p.comm_telemetry_enabled = comm
    pod = committed_pod(mgr, cores=40, memory=3 * GIB)
    jp, jclient = jax_plugin(mgr, tmp_path / "jax")
    jp.step_telemetry_enabled = step
    jp.comm_telemetry_enabled = comm
    client.add_pod(copy.deepcopy(pod))
    jclient.add_pod(copy.deepcopy(pod))
    ids = [device_id(mgr.chips[0].uuid, 0)]
    mine = alloc(p, *ids)
    theirs = dict(jp.allocate(jpb.AllocateRequest(container_requests=[
        jpb.ContainerAllocateRequest(devicesIDs=ids)])).container_responses[0]
        .envs)
    keys = (consts.ENV_COMM_TELEMETRY, consts.ENV_STEP_TELEMETRY,
            consts.ENV_STEP_RING_PATH)
    assert {k: mine.envs.get(k) for k in keys} == \
        {k: theirs.get(k) for k in keys}
    assert (mine.envs.get(consts.ENV_COMM_TELEMETRY) == "true") == \
        (step and comm)


@pytest.mark.parametrize("spec,armed", [
    ("", False),
    ("CommTelemetry=true", False),
    ("StepTelemetry=true", False),
    ("StepTelemetry=true,CommTelemetry=true", True),
    ("StepTelemetry=true,CommTelemetry=false", False),
])
def test_gate_needs_step_telemetry(spec, armed, caplog):
    """JAX `cmd/device_plugin.py:236-246`: CommTelemetry without
    StepTelemetry warns and stays disarmed."""
    gates = fg.FeatureGates()
    gates.parse(spec)
    with caplog.at_level(logging.WARNING):
        assert dp.comm_telemetry_on(gates) is armed
    warned = "CommTelemetry=true requires StepTelemetry=true" in caplog.text
    assert warned == (spec == "CommTelemetry=true")


# --- the Python writer --------------------------------------------------------

SEQUENCES = {
    "rising": [(5_000_000, 4096, 3), (7_000_000, 5120, 4),
               (7_000_000, 5120, 4), (9_500_000, 1 << 30, 9)],
    "reloaded": [(5_000_000, 4096, 3), (0, 0, 0), (1_000_000, 100, 1)],
    "zeros": [(0, 0, 0), (0, 0, 0)],
}


def _write(side, path, seq, comm_armed):
    mod_ring = jax_stepring if side == "jax" else stepring
    mod_client = jax_client if side == "jax" else port_client
    ring = mod_ring.StepRingWriter(str(path), trace_id="tr-comm")
    state = {"i": 0, "wait": 0}
    values = [(0, 0, 0), *seq]

    def counter(k):
        return lambda: values[state["i"]][k]

    fns = tuple(counter(k) for k in range(3)) if comm_armed else None
    wrapped = mod_client._ShimWaitStepRing(ring, lambda: state["wait"],
                                           comm_fns=fns)
    for i in range(1, len(values)):
        state["i"] = i
        state["wait"] += 1000 * i
        wrapped.record(100_000_000 + i, hbm_highwater_bytes=i << 20,
                       compiled=i == 1, start_mono_ns=10**12 + i * 10**8)
    wrapped.close()
    return path.read_bytes()


@pytest.mark.parametrize("comm_armed", [True, False])
@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_python_writer_records_equal_jax(tmp_path, seq, comm_armed):
    """The records byte for byte the JAX writer's for the same counter
    sequences (tests/test_comm.py:627): deltas, a reloaded interposer's
    re-baseline, and zeros when the counters are not armed."""
    mine = _write("port", tmp_path / "port.ring", SEQUENCES[seq], comm_armed)
    theirs = _write("jax", tmp_path / "jax.ring", SEQUENCES[seq], comm_armed)
    assert mine == theirs
    reader = stepring.StepRingReader(str(tmp_path / "port.ring"))
    recs, _, _ = reader.poll(0)
    reader.close()
    if not comm_armed:
        assert all((r.comm_time_ns, r.bytes_transferred,
                    r.collective_count) == (0, 0, 0) for r in recs)
    elif seq == "rising":
        assert [(r.comm_time_ns, r.bytes_transferred, r.collective_count)
                for r in recs] == [(5_000_000, 4096, 3), (2_000_000, 1024, 1),
                                   (0, 0, 0), (2_500_000, (1 << 30) - 5120,
                                               5)]


def test_comm_sources_need_env_as_jax(monkeypatch):
    """Unarmed, no accessor (tests/test_comm.py:654); armed in a process
    without the interposer, none either: the block stays zeros."""
    monkeypatch.delenv(consts.ENV_COMM_TELEMETRY, raising=False)
    assert port_client._interposer_comm_sources() is None
    assert jax_client._shim_comm_sources() is None
    monkeypatch.setenv(consts.ENV_COMM_TELEMETRY, "true")
    assert port_client._interposer_comm_sources() is None


# --- the exporter's families --------------------------------------------------

def _comm_node(base):
    """One tenant whose ring carries a comm block, one whose does not, on
    one chip."""
    chip = fake_chip(0)
    for uid in ("uid-c", "uid-plain"):
        _mk_config_dir(base, uid, "main", chip, cores=30)
    w = _ring(base, "uid-c", "main", trace_id="tr-c")
    for i in range(4):
        w.record(duration_ns=100_000_000, throttle_wait_ns=0,
                 comm_time_ns=25_000_000 + i, bytes_transferred=1 << 21,
                 collective_count=i % 2)
    w.close()
    w = _ring(base, "uid-plain", "main")
    for _ in range(4):
        w.record(duration_ns=50_000_000)
    w.close()
    return [chip]


def _comm_lines(text):
    return [line for line in masked(text) if "vtpu_tenant_comm" in line]


@pytest.mark.parametrize("comm", [True, False])
def test_collector_comm_lines_equal_jax(tmp_path, comm):
    """The port's collector with comm on renders exactly the JAX
    collector's `vtpu_tenant_comm_*` lines over the same rings, for the
    tenant whose ring carries the block only; off, none
    (tests/test_comm.py:319-374)."""
    base = str(tmp_path / "mgr")
    chips = _comm_node(base)
    kw = dict(base_dir=base, tc_path=str(tmp_path / "no-tc"),
              vmem_path=str(tmp_path / "no-vmem"),
              pod_resources_socket=str(tmp_path / "no.sock"),
              kubelet_checkpoint=str(tmp_path / "no.ckpt"),
              comm_enabled=comm)
    jax_c, port_c = collectors(chips, **kw)
    jax_text, port_text = jax_c.render(), port_c.render()
    assert masked(port_text) == masked(jax_text)
    lines = _comm_lines(port_text)
    assert lines == _comm_lines(jax_text)
    if comm:
        assert any('pod_uid="uid-c"' in line for line in lines)
        assert not any('pod_uid="uid-plain"' in line for line in lines)
        assert ('vtpu_tenant_comm_time_fraction{node="n1",pod_uid="uid-c",'
                'container="main"} 0.25') in port_text
    else:
        assert "vtpu_tenant_comm" not in port_text


@pytest.mark.parametrize("uid,comm_rows", [("uid-c", True),
                                           ("uid-plain", False)])
def test_step_stats_splice_equal_jax(tmp_path, uid, comm_rows):
    """The splice carries the comm row only where the ring holds a
    measured block (tests/test_comm.py:376-394)."""
    base = str(tmp_path / "mgr")
    _comm_node(base)
    mine = port_aggregate.step_stats_for_pod(base, uid)
    theirs = jax_aggregate.step_stats_for_pod(base, uid)
    assert mine == theirs and mine
    assert ("comm_time_frac" in mine[0]) == comm_rows
    if comm_rows:
        assert mine[0]["comm_bytes_per_step"] == 1 << 21
        assert mine[0]["collectives"] == 2


@pytest.mark.parametrize("gates,rendered", [
    ("CommTelemetry=true", True), ("StepTelemetry=true", False)])
def test_device_monitor_takes_the_gate(tmp_path, gates, rendered):
    """`--feature-gates CommTelemetry=true` is no longer refused: the
    exporter renders the comm families of a ring that carries them."""
    node_dir(tmp_path)
    ring = (tmp_path / "mgr" / "uid-b_main" / consts.TELEMETRY_SUBDIR)
    ring.mkdir(parents=True)
    w = stepring.StepRingWriter(str(ring / consts.STEP_RING_NAME))
    for _ in range(3):
        w.record(duration_ns=10**7, comm_time_ns=10**6,
                 bytes_transferred=4096, collective_count=1)
    w.close()
    exp = Exporter(tmp_path, "--feature-gates", gates)
    try:
        status, body, _ = exp.get("/metrics")
    finally:
        assert exp.stop() == 0
    assert status == 200
    assert ('vtpu_tenant_comm_time_fraction{node="n1",pod_uid="uid-b",'
            'container="main"} 0.1' in body) == rendered
    assert ("vtpu_tenant_comm" in body) == rendered


# --- the card phase's comm checks (chip_smoke.py, phase 14) ----------------

def _rank_rings(base, ranks=2):
    for r in range(ranks):
        d = os.path.join(base, f"pod-dist_rank{r}", consts.TELEMETRY_SUBDIR)
        os.makedirs(d)
        w = stepring.StepRingWriter(os.path.join(d, consts.STEP_RING_NAME))
        for _ in range(3):
            w.record(duration_ns=10**7, comm_time_ns=10**6,
                     bytes_transferred=1 << 20)
        w.close()


def _good_ranks():
    comm = {"staged": 1 << 26,
            "ring_s": 0.5, "time_ns": 4 * 10**6, "bytes": (1 << 26) + 8,
            "collectives": 0, "ring_sum": [4 * 10**6, (1 << 26) + 8, 0]}
    return [{"comm": copy.deepcopy(comm)} for _ in range(2)], \
        {"comm": {"collectives": 3, "nccl_kernels": 3}}


def test_phase_comm_export_and_checks_pass(tmp_path):
    import chip_smoke
    base = str(tmp_path / "mgr")
    _rank_rings(base)
    exported = chip_smoke.comm_exported(base, "pod-dist", 2)
    assert not exported["off_any"]
    assert exported["on"]["rank0"] == exported["on"]["rank1"]
    assert "vtpu_tenant_comm_time_fraction" in exported["on"]["rank0"]
    two, one = _good_ranks()
    assert chip_smoke.check_comm(two, one, exported) == []


def test_phase_staged_bytes_are_the_ring_hops():
    """A gloo rank of the phase's ring stages its K/V shard stack once to
    the host and once back per hop: at two ranks on the attention probe's
    shard (8, 16, 512, 128) fp32, 64 MiB each way (the interposer on the
    H100 counted these 128 MiB plus a 4-byte readback)."""
    import chip_smoke
    assert chip_smoke.staged_bytes((8, 16, 1024, 128), 2) == 128 << 20
    assert chip_smoke.staged_bytes((8, 16, 1024, 128), 4) == 3 * 64 << 20
    assert chip_smoke.staged_bytes((8, 16, 1024, 128), 1) == 0


def test_dryrun_multichip_gives_its_ranks_the_pods_env(monkeypatch):
    """The entry point hands a pod's environment (Allocate's, with
    CommTelemetry armed) to every rank it starts."""
    from vtpu_manager_torch import graft_entry
    from vtpu_manager_torch.workloads import ranks

    seen = {}

    def launch(job, world, **kw):
        seen.update(job=job, world=world, **kw)
        return [{"loss": 1.0, "mesh": {}}] * world

    monkeypatch.setattr(ranks, "launch", launch)
    env = {consts.ENV_COMM_TELEMETRY: "true"}
    graft_entry.dryrun_multichip(1, cfg={"x": 1}, env=env)
    assert seen["env"] is env and seen["world"] == 1
    assert seen["job"] == "vtpu_manager_torch.graft_entry:dryrun_rank"
    graft_entry.dryrun_multichip(1)
    assert seen["env"] is None


BREAKS = {
    "under_staged": lambda two, one: two[0]["comm"].update(bytes=10),
    "over_slack": lambda two, one: two[1]["comm"].update(
        bytes=(1 << 26) + 4097),
    "no_time": lambda two, one: two[0]["comm"].update(time_ns=0),
    "over_wall": lambda two, one: two[0]["comm"].update(time_ns=10**9),
    "collective": lambda two, one: two[1]["comm"].update(collectives=1),
    "ring_sum": lambda two, one: two[0]["comm"].update(ring_sum=[0, 0, 0]),
    "unarmed": lambda two, one: two[0]["comm"].pop("bytes"),
    "nccl": lambda two, one: one["comm"].update(nccl_kernels=2),
}


@pytest.mark.parametrize("brk", sorted(BREAKS))
def test_phase_comm_checks_fail(tmp_path, brk):
    import chip_smoke
    base = str(tmp_path / "mgr")
    _rank_rings(base)
    exported = chip_smoke.comm_exported(base, "pod-dist", 2)
    two, one = _good_ranks()
    BREAKS[brk](two, one)
    assert chip_smoke.check_comm(two, one, exported)
