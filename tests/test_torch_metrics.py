"""The port's node exporter collector against the JAX package's.

Every case of tests/test_metrics.py (and the collector cases of
tests/test_telemetry.py) builds one node directory (config files from the
port's writer, which are byte for byte the JAX writer's, a memory ledger,
a watcher feed, step rings, a kubelet checkpoint) and renders it with the
JAX `NodeCollector.render()` and with the port's. The two texts must be
equal line for line once the values that depend on the moment of the
scrape are masked (`MASKED` below, and the `version` label of
`vtpu_node_info`), and each text must pass the JAX case's own asserts.
Then the pod-resources codec against the JAX package's generated
`podresources_pb2`.
"""

import json
import os
import re
import shutil
import time
from concurrent import futures
from types import SimpleNamespace

import pytest

from vtpu_manager.client import pod_resources as jax_pod_resources
from vtpu_manager.config.vmem import VmemLedger as JaxVmemLedger
from vtpu_manager.device.types import fake_chip
from vtpu_manager.deviceplugin.api import podresources_pb2 as pb
from vtpu_manager.metrics import collector as jax_collector
from vtpu_manager_torch.client import pod_resources
from vtpu_manager_torch.config import tc_watcher, vtpu_config as vc
from vtpu_manager_torch.config.vmem import VmemLedger, fnv64
from vtpu_manager_torch.device.types import ChipSpec
from vtpu_manager_torch.deviceplugin.api import podresources_messages as pr
from vtpu_manager_torch.metrics import collector
from vtpu_manager_torch.telemetry import stepring
from vtpu_manager_torch.util import consts

# gauges whose value is the age of something at the moment of the scrape
MASKED = ("vtpu_device_feed_age_seconds", "vtpu_node_obs_calibration_age_seconds",
          "vtpu_container_heartbeat_age_seconds",
          "vtpu_node_scrape_duration_seconds")
SIDES = {"jax": jax_collector, "torch": collector}


@pytest.fixture(autouse=True)
def _no_startup_grace(monkeypatch):
    """The config dirs here are seconds old; the grace has its own case."""
    for mod in SIDES.values():
        monkeypatch.setattr(mod, "STARTUP_GRACE_S", 0.0)


def masked(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        name = line.split("{", 1)[0]
        if name in MASKED or name.endswith("_age_seconds"):
            line = line.rsplit(" ", 1)[0] + " <t>"
        out.append(re.sub(r'version="[^"]*"', 'version="<v>"', line))
    return out


def port_chips(chips):
    """The port's ChipSpec for each of the JAX package's fake chips."""
    return [ChipSpec(uuid=c.uuid, index=c.index, chip_type=c.chip_type,
                     memory=c.memory, core_count=c.core_count,
                     split_count=c.split_count, coords=c.coords,
                     host_id=c.host_id, numa=c.numa, healthy=c.healthy)
            for c in chips]


def collectors(chips, **kw):
    return (jax_collector.NodeCollector("n1", chips, **kw),
            collector.NodeCollector("n1", port_chips(chips), **kw))


def render_both(chips, **kw) -> tuple[str, str]:
    """Both renders of one node directory, held equal (masked)."""
    jax_text, port_text = (c.render() for c in collectors(chips, **kw))
    assert masked(port_text) == masked(jax_text)
    return jax_text, port_text


def _mk_config_dir(base, pod_uid, container, chip, dra_request=None,
                   cores=10, memory=2**30):
    sub = "config" if dra_request is None else f"config_{dra_request}"
    d = os.path.join(base, f"{pod_uid}_{container}", sub)
    vc.write_config(os.path.join(d, "vtpu.config"), vc.VtpuConfig(
        pod_uid=pod_uid, container_name=container,
        devices=[vc.DeviceConfig(uuid=chip.uuid, total_memory=memory,
                                 real_memory=chip.memory, hard_core=cores,
                                 host_index=chip.index)]))


def _ring(base, pod_uid, container, trace_id=""):
    d = os.path.join(base, f"{pod_uid}_{container}", consts.TELEMETRY_SUBDIR)
    os.makedirs(d, exist_ok=True)
    return stepring.StepRingWriter(os.path.join(d, consts.STEP_RING_NAME),
                                   trace_id=trace_id)


def _checkpoint(path, pairs):
    with open(path, "w") as f:
        json.dump({"Data": {"PodDeviceEntries": [
            {"PodUID": uid, "ContainerName": name,
             "ResourceName": consts.vtpu_number_resource(),
             "DeviceIDs": {"-1": [f"vtpu-{uid}-0"]}}
            for uid, name in pairs]}}, f)


def _fake_pod_resources_server(socket_path, containers):
    """Kubelet's pod-resources service on a unix socket, answering with the
    JAX package's generated messages (real protobuf bytes)."""
    import grpc

    def list_rpc(req, ctx):
        resp = pb.ListPodResourcesResponse()
        for name in containers:
            pod = resp.pod_resources.add(name=f"pod-{name}", namespace="ns")
            cont = pod.containers.add(name=name)
            cont.devices.add(resource_name=consts.vtpu_number_resource(),
                             device_ids=[f"vtpu-{name}-0"])
        return resp

    s = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    s.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "v1alpha1.PodResources",
        {"List": grpc.unary_unary_rpc_method_handler(
            list_rpc,
            request_deserializer=pb.ListPodResourcesRequest.FromString,
            response_serializer=(
                pb.ListPodResourcesResponse.SerializeToString))}),))
    s.add_insecure_port(f"unix://{socket_path}")
    s.start()
    return s


# --- the whole node directory ------------------------------------------------

def test_full_node_directory_renders_as_jax(tmp_path):
    """Configs (a device-plugin tenant on two cards, a DRA claim with two
    requests, an orphan), a ledger, a feed with per-process shares and a
    calibration block, rings, a checkpoint, a compile cache's counters."""
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0), fake_chip(1)]
    vc.write_config(os.path.join(base, "uid-1_main", "config", "vtpu.config"),
                    vc.VtpuConfig(pod_uid="uid-1", container_name="main",
                                  devices=[vc.DeviceConfig(
                                      uuid=c.uuid, total_memory=2 * 2**30,
                                      real_memory=c.memory, hard_core=50,
                                      host_index=c.index) for c in chips]))
    _mk_config_dir(base, "uid-2", "side", chips[0], cores=25)
    _mk_config_dir(base, "bogus-uid", "main", chips[1], cores=5)
    for req, chip in (("a", chips[0]), ("b", chips[1])):
        _mk_config_dir(base, "claim", "cm", chip, dra_request=req, cores=20)
    tok1, tok2 = fnv64("uid-1/main"), fnv64("uid-2/side")
    tc_path = str(tmp_path / "tc.config")
    tc = tc_watcher.TcUtilFile(tc_path, create=True)
    for chip in chips:
        tc.write_device(chip.index, tc_watcher.DeviceUtil(
            timestamp_ns=time.monotonic_ns(), device_util=70,
            procs=[tc_watcher.ProcUtil(100 + chip.index, 40, 5, tok1),
                   tc_watcher.ProcUtil(200, 20 * (1 - chip.index), 6,
                                       tok2)]))
    tc.write_calibration([(0, 0), (60000, 730), (250000, 1700)])
    tc.close()
    vmem_path = str(tmp_path / "vmem.config")
    led = VmemLedger(vmem_path, create=True)
    led.record(100, 0, 3 * 2**20, owner_token=tok1)
    led.record(101, 1, 5 * 2**20, owner_token=tok1)
    led.record(200, 0, 7 * 2**20, owner_token=tok2)
    led.record(300, 1, 11, owner_token=fnv64("ghost/main"))
    led.close()
    for uid, name, wait in (("uid-1", "main", 3), ("uid-2", "side", 6)):
        w = _ring(base, uid, name, trace_id=f"tr-{uid}")
        for i in range(40):
            w.record(duration_ns=10_000_000, throttle_wait_ns=wait * 10**6,
                     hbm_highwater_bytes=(i + 1) << 20, compiled=(i == 0))
        w.close()
    ckpt = str(tmp_path / "kubelet_internal_checkpoint")
    _checkpoint(ckpt, [("uid-1", "main"), ("uid-2", "side")])
    stats = os.path.join(base, consts.COMPILE_CACHE_SUBDIR, "stats")
    os.makedirs(stats)
    with open(os.path.join(stats, "c1.json"), "w") as f:
        json.dump({"hits": 3, "misses": 2}, f)
    jax_text, port_text = render_both(
        chips, base_dir=base, tc_path=tc_path, vmem_path=vmem_path,
        pod_resources_socket=str(tmp_path / "no-sock"),
        kubelet_checkpoint=ckpt)
    for text in (jax_text, port_text):
        assert ('vtpu_container_pod_mapping_mismatch{node="n1",'
                'pod_uid="bogus-uid",container="main"} 1.0') in text
        assert ('vtpu_tenant_step_duration_seconds_count{node="n1",'
                'pod_uid="uid-2",container="side"} 40') in text
        assert 'vtpu_node_pressure_throttle_frac{node="n1"} 0.6' in text
        assert 'vtpu_compile_cache_hits_total{node="n1"} 3' in text
        assert 'vtpu_node_obs_excess_max_us{node="n1"} 1700.0' in text


# --- the cases of tests/test_metrics.py -------------------------------------

def test_collector_renders_gauges(tmp_path):
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0), fake_chip(1)]
    vc.write_config(os.path.join(base, "uid-1_main", "config", "vtpu.config"),
                    vc.VtpuConfig(pod_uid="uid-1", container_name="main",
                                  devices=[vc.DeviceConfig(
                                      uuid=chips[0].uuid, total_memory=2**30,
                                      real_memory=chips[0].memory,
                                      hard_core=40, host_index=0)]))
    tc_path = str(tmp_path / "tc_util.config")
    tc = tc_watcher.TcUtilFile(tc_path, create=True)
    tc.write_device(0, tc_watcher.DeviceUtil(
        timestamp_ns=1, device_util=37,
        procs=[tc_watcher.ProcUtil(pid=os.getpid(), util=29,
                                   mem_used=123456,
                                   owner_token=fnv64("uid-1/main"))]))
    tc.close()
    vmem_path = str(tmp_path / "vmem.config")
    led = VmemLedger(vmem_path, create=True)
    led.record(os.getpid(), 0, 123456, owner_token=fnv64("uid-1/main"))
    led.record(os.getpid() + 1, 0, 999999,
               owner_token=fnv64("uid-other/main"))
    led.close()
    for text in render_both(chips, base_dir=base, tc_path=tc_path,
                            vmem_path=vmem_path):
        assert 'vtpu_device_memory_total_bytes{node="n1",' \
            'uuid="TPU-FAKE-0000"' in text
        assert 'vtpu_device_utilization_percent{node="n1",' \
            'uuid="TPU-FAKE-0000",index="0"} 37.0' in text
        assert 'vtpu_container_utilization_percent{node="n1",' \
            'pod_uid="uid-1",container="main",uuid="TPU-FAKE-0000"} 29.0' \
            in text
        assert 'vtpu_container_memory_used_bytes{node="n1",' \
            'pod_uid="uid-1",container="main",uuid="TPU-FAKE-0000"} ' \
            '123456.0' in text
        assert 'vtpu_container_core_limit_percent{node="n1",' \
            'pod_uid="uid-1",container="main",uuid="TPU-FAKE-0000"} 40.0' \
            in text
        assert 'vtpu_node_slots_total{node="n1"} 20.0' in text
        assert 'vtpu_node_slots_assigned{node="n1"} 1.0' in text


def test_collector_empty_node(tmp_path):
    for text in render_both([], base_dir=str(tmp_path / "none"),
                            tc_path="/nonexistent",
                            vmem_path="/nonexistent"):
        assert "vtpu_node_slots_total" in text


def test_multi_request_dra_claim_partitions_counted(tmp_path):
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0), fake_chip(1)]
    for req, index, cores in (("train", 0, 60), ("eval", 1, 30)):
        d = os.path.join(base, "claim_cm", f"config_{req}")
        vc.write_config(os.path.join(d, "vtpu.config"), vc.VtpuConfig(
            pod_uid="cm", container_name=f"dra-{req}",
            devices=[vc.DeviceConfig(
                uuid=chips[index].uuid, total_memory=2**30,
                real_memory=chips[index].memory, hard_core=cores,
                host_index=index)]))
    for text in render_both(chips, base_dir=base, tc_path="/nonexistent",
                            vmem_path="/nonexistent"):
        assert 'container="cm/train"' in text
        assert 'container="cm/eval"' in text
        assert 'vtpu_node_slots_assigned{node="n1"} 2.0' in text


def test_multi_chip_container_rows_stay_per_device(tmp_path):
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0), fake_chip(1)]
    vc.write_config(os.path.join(base, "uid-1_main", "config", "vtpu.config"),
                    vc.VtpuConfig(pod_uid="uid-1", container_name="main",
                                  devices=[vc.DeviceConfig(
                                      uuid=c.uuid, total_memory=2**30,
                                      real_memory=c.memory,
                                      host_index=c.index) for c in chips]))
    token = fnv64("uid-1/main")
    tc_path = str(tmp_path / "tc.config")
    tc = tc_watcher.TcUtilFile(tc_path, create=True)
    tc.write_device(0, tc_watcher.DeviceUtil(
        timestamp_ns=1, device_util=60,
        procs=[tc_watcher.ProcUtil(7, 60, 0, token)]))
    tc.write_device(1, tc_watcher.DeviceUtil(
        timestamp_ns=1, device_util=25,
        procs=[tc_watcher.ProcUtil(7, 25, 0, token)]))
    tc.close()
    vmem_path = str(tmp_path / "vmem.config")
    led = VmemLedger(vmem_path, create=True)
    led.record(os.getpid(), 0, 111, owner_token=token)
    led.record(os.getpid(), 1, 222, owner_token=token)
    led.close()
    for text in render_both(chips, base_dir=base, tc_path=tc_path,
                            vmem_path=vmem_path):
        for chip, used, util in ((chips[0], 111, 60), (chips[1], 222, 25)):
            row = (f'{{node="n1",pod_uid="uid-1",container="main",'
                   f'uuid="{chip.uuid}"}}')
            assert f"vtpu_container_memory_used_bytes{row} {used}.0" in text
            assert f"vtpu_container_utilization_percent{row} {util}.0" \
                in text


def test_extended_gauge_parity(tmp_path):
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0)]
    chip_mem = chips[0].memory
    vc.write_config(os.path.join(base, "uid-1_main", "config", "vtpu.config"),
                    vc.VtpuConfig(pod_uid="uid-1", container_name="main",
                                  devices=[vc.DeviceConfig(
                                      uuid=chips[0].uuid,
                                      total_memory=2 * chip_mem,
                                      real_memory=chip_mem, hard_core=40,
                                      host_index=0)]))
    token = fnv64("uid-1/main")
    tc_path = str(tmp_path / "tc.config")
    tc = tc_watcher.TcUtilFile(tc_path, create=True)
    tc.write_device(0, tc_watcher.DeviceUtil(
        timestamp_ns=time.monotonic_ns(), device_util=50,
        procs=[tc_watcher.ProcUtil(pid=41, util=30, mem_used=100,
                                   owner_token=token),
               tc_watcher.ProcUtil(pid=42, util=20, mem_used=50,
                                   owner_token=token)]))
    tc.close()
    vmem_path = str(tmp_path / "vmem.config")
    led = VmemLedger(vmem_path, create=True)
    led.record(41, 0, 1000, owner_token=token)
    led.record(42, 0, 2000, owner_token=token)
    led.close()
    pair = collectors(chips, base_dir=base, tc_path=tc_path,
                      vmem_path=vmem_path)
    texts = [c.render() for c in pair]
    assert masked(texts[1]) == masked(texts[0])
    uuid = chips[0].uuid
    for text in texts:
        assert f'vtpu_device_memory_used_bytes{{node="n1",uuid="{uuid}",' \
            'index="0"} 3000.0' in text
        assert f'vtpu_container_memory_limit_bytes{{node="n1",' \
            f'pod_uid="uid-1",container="main",uuid="{uuid}"}} ' \
            f'{float(2 * chip_mem)}' in text
        assert 'vtpu_container_memory_limit_physical_bytes{node="n1",' \
            f'pod_uid="uid-1",container="main",uuid="{uuid}"}} ' \
            f'{float(chip_mem)}' in text
        assert f'vtpu_device_memory_assigned_physical_bytes{{node="n1",' \
            f'uuid="{uuid}",index="0"}} {float(chip_mem)}' in text
        assert f'vtpu_device_cores_assigned_percent{{node="n1",' \
            f'uuid="{uuid}",index="0"}} 40.0' in text
        for pid, used, util in (("41", 1000, 30), ("42", 2000, 20)):
            row = (f'{{node="n1",pod_uid="uid-1",container="main",'
                   f'uuid="{uuid}",pid="{pid}"}}')
            assert f"vtpu_process_memory_used_bytes{row} {used}.0" in text
            assert f"vtpu_process_utilization_percent{row} {util}.0" in text
        assert 'vtpu_device_feed_age_seconds{' in text
        hb = [ln for ln in text.splitlines()
              if ln.startswith("vtpu_container_heartbeat_age_seconds{")]
        assert hb and all(float(ln.rsplit(" ", 1)[1]) < 60 for ln in hb)
        assert f'vtpu_node_memory_total_bytes{{node="n1"}} ' \
            f'{float(chip_mem)}' in text
        assert 'vtpu_node_info{node="n1",version=' in text
    # the peak survives the tenant going away
    shutil.rmtree(os.path.join(base, "uid-1_main"))
    texts = [c.render() for c in pair]
    assert masked(texts[1]) == masked(texts[0])
    for text in texts:
        assert f'vtpu_device_assigned_containers_peak{{node="n1",' \
            f'uuid="{uuid}"}} 1.0' in text
        assert 'vtpu_device_assigned_containers{node="n1"' not in text


def test_unattributed_ledger_rows_skipped(tmp_path):
    chips = [fake_chip(0)]
    vmem_path = str(tmp_path / "vmem.config")
    led = VmemLedger(vmem_path, create=True)
    led.record(77, 0, 5000, owner_token=fnv64("ghost/main"))
    led.close()
    for text in render_both(chips, base_dir=str(tmp_path / "none"),
                            tc_path="/nonexistent", vmem_path=vmem_path):
        assert 'pid="77"' not in text
        assert 'vtpu_device_memory_used_bytes{node="n1",' \
            f'uuid="{chips[0].uuid}",index="0"}} 5000.0' in text


def test_calibration_gauges(tmp_path):
    chips = [fake_chip(0)]
    tc_path = str(tmp_path / "tc.config")
    tc = tc_watcher.TcUtilFile(tc_path, create=True)
    tc.write_calibration([(0, 0), (60000, 730), (250000, 1700)])
    tc.close()
    for text in render_both(chips, base_dir=str(tmp_path / "none"),
                            tc_path=tc_path, vmem_path="/nonexistent"):
        assert 'vtpu_node_obs_excess_max_us{node="n1"} 1700.0' in text
        assert 'vtpu_node_obs_calibration_age_seconds{node="n1"}' in text
    tc2_path = str(tmp_path / "tc2.config")
    tc_watcher.TcUtilFile(tc2_path, create=True).close()
    for text in render_both(chips, base_dir=str(tmp_path / "none"),
                            tc_path=tc2_path, vmem_path="/nonexistent"):
        assert "vtpu_node_obs_excess_max_us{" not in text


def _mismatch_block(text):
    return text.split("vtpu_container_pod_mapping_mismatch", 1)[1] \
        .split("# ", 1)[0]


def test_mapping_crosscheck_pod_resources_socket(tmp_path):
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0)]
    _mk_config_dir(base, "uid-1", "main", chips[0])
    _mk_config_dir(base, "uid-2", "ghost", chips[0])
    _mk_config_dir(base, "uid-3", "dra", chips[0], dra_request="r0")
    _mk_config_dir(base, "claim", "abc-claim-uid", chips[0])
    sock = str(tmp_path / "podres.sock")
    server = _fake_pod_resources_server(sock, ["main"])
    try:
        texts = render_both(chips, base_dir=base,
                            tc_path=str(tmp_path / "tc"),
                            vmem_path=str(tmp_path / "vm"),
                            pod_resources_socket=sock,
                            kubelet_checkpoint=str(tmp_path / "no-ckpt"))
    finally:
        server.stop(0)
    for text in texts:
        assert ('vtpu_container_pod_mapping_mismatch{node="n1",'
                'pod_uid="uid-1",container="main"} 0.0') in text
        assert ('vtpu_container_pod_mapping_mismatch{node="n1",'
                'pod_uid="uid-2",container="ghost"} 1.0') in text
        block = _mismatch_block(text)
        assert 'pod_uid="uid-3"' not in block
        assert 'pod_uid="claim"' not in block
        assert 'vtpu_node_pod_mapping_source{node="n1"} 2.0' in text


def test_mapping_startup_grace_skips_fresh_tenants(tmp_path, monkeypatch):
    for mod in SIDES.values():
        monkeypatch.setattr(mod, "STARTUP_GRACE_S", 60.0)
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0)]
    _mk_config_dir(base, "uid-new", "ghost", chips[0])
    _mk_config_dir(base, "uid-old", "ghost", chips[0])
    old_cfg = os.path.join(base, "uid-old_ghost", "config", "vtpu.config")
    past = os.path.getmtime(old_cfg) - 3600
    os.utime(old_cfg, (past, past))
    sock = str(tmp_path / "podres.sock")
    server = _fake_pod_resources_server(sock, ["main"])
    try:
        texts = render_both(chips, base_dir=base,
                            tc_path=str(tmp_path / "tc"),
                            vmem_path=str(tmp_path / "vm"),
                            pod_resources_socket=sock,
                            kubelet_checkpoint=str(tmp_path / "no-ckpt"))
    finally:
        server.stop(0)
    for text in texts:
        assert ('vtpu_container_pod_mapping_mismatch{node="n1",'
                'pod_uid="uid-old",container="ghost"} 1.0') in text
        assert 'pod_uid="uid-new"' not in _mismatch_block(text)


def test_mapping_crosscheck_checkpoint_fallback(tmp_path):
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0)]
    _mk_config_dir(base, "uid-1", "main", chips[0])
    _mk_config_dir(base, "uid-9", "main", chips[0])
    ckpt_path = str(tmp_path / "kubelet_internal_checkpoint")
    _checkpoint(ckpt_path, [("uid-1", "main")])
    for text in render_both(chips, base_dir=base,
                            tc_path=str(tmp_path / "tc"),
                            vmem_path=str(tmp_path / "vm"),
                            pod_resources_socket=str(tmp_path / "no-sock"),
                            kubelet_checkpoint=ckpt_path):
        assert ('vtpu_container_pod_mapping_mismatch{node="n1",'
                'pod_uid="uid-1",container="main"} 0.0') in text
        assert ('vtpu_container_pod_mapping_mismatch{node="n1",'
                'pod_uid="uid-9",container="main"} 1.0') in text
        assert 'vtpu_node_pod_mapping_source{node="n1"} 1.0' in text


def test_mapping_crosscheck_socket_plus_checkpoint_pair_keyed(tmp_path):
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0)]
    _mk_config_dir(base, "uid-1", "main", chips[0])
    _mk_config_dir(base, "bogus-uid", "main", chips[0])
    _mk_config_dir(base, "uid-5", "gone", chips[0])
    ckpt_path = str(tmp_path / "kubelet_internal_checkpoint")
    _checkpoint(ckpt_path, [("uid-1", "main"), ("uid-5", "gone")])
    sock = str(tmp_path / "podres.sock")
    server = _fake_pod_resources_server(sock, ["main"])
    try:
        texts = render_both(chips, base_dir=base,
                            tc_path=str(tmp_path / "tc"),
                            vmem_path=str(tmp_path / "vm"),
                            pod_resources_socket=sock,
                            kubelet_checkpoint=ckpt_path)
    finally:
        server.stop(0)
    for text in texts:
        for uid, name, value in (("uid-1", "main", "0.0"),
                                 ("bogus-uid", "main", "1.0"),
                                 ("uid-5", "gone", "1.0")):
            assert ('vtpu_container_pod_mapping_mismatch{node="n1",'
                    f'pod_uid="{uid}",container="{name}"}} {value}') in text
        assert 'vtpu_node_pod_mapping_source{node="n1"} 3.0' in text


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_mapping_crosscheck_view_is_ttl_cached(tmp_path, monkeypatch, side):
    mod = SIDES[side]
    pr_mod = jax_pod_resources if side == "jax" else pod_resources
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0)] if side == "jax" else port_chips([fake_chip(0)])
    _mk_config_dir(base, "uid-1", "main", chips[0])
    calls = []
    monkeypatch.setattr(
        pr_mod, "kubelet_view",
        lambda *a, **k: calls.append(1) or pr_mod.KubeletView(
            source="podresources", containers=frozenset({"main"})))
    c = mod.NodeCollector(
        "n1", chips, base_dir=base, tc_path=str(tmp_path / "tc"),
        vmem_path=str(tmp_path / "vm"),
        pod_resources_socket=str(tmp_path / "no-sock"),
        kubelet_checkpoint=str(tmp_path / "no-ckpt"))
    c.render()
    c.render()
    assert len(calls) == 1
    c._kubelet_view_ts -= c.kubelet_view_ttl_s + 1
    c.render()
    assert len(calls) == 2


def test_mapping_crosscheck_no_source(tmp_path):
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0)]
    _mk_config_dir(base, "uid-1", "main", chips[0])
    for text in render_both(chips, base_dir=base,
                            tc_path=str(tmp_path / "tc"),
                            vmem_path=str(tmp_path / "vm"),
                            pod_resources_socket=str(tmp_path / "no-sock"),
                            kubelet_checkpoint=str(tmp_path / "no-ckpt")):
        assert 'vtpu_node_pod_mapping_source{node="n1"} 0.0' in text
        assert "mapping_mismatch{" not in text


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_mapping_crosscheck_cached_view_refetches_before_alarming(
        tmp_path, monkeypatch, side):
    mod = SIDES[side]
    pr_mod = jax_pod_resources if side == "jax" else pod_resources
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0)] if side == "jax" else port_chips([fake_chip(0)])
    _mk_config_dir(base, "uid-1", "main", chips[0])
    views = [pr_mod.KubeletView(source="podresources",
                                containers=frozenset()),
             pr_mod.KubeletView(source="podresources",
                                containers=frozenset({"main"}))]
    calls = []
    monkeypatch.setattr(
        pr_mod, "kubelet_view",
        lambda *a, **k: calls.append(1) or views[min(len(calls) - 1,
                                                     len(views) - 1)])
    c = mod.NodeCollector(
        "n1", chips, base_dir=base, tc_path=str(tmp_path / "tc"),
        vmem_path=str(tmp_path / "vm"),
        pod_resources_socket=str(tmp_path / "no-sock"),
        kubelet_checkpoint=str(tmp_path / "no-ckpt"))
    c.render()
    text = c.render()
    assert len(calls) == 2
    assert ('vtpu_container_pod_mapping_mismatch{node="n1",'
            'pod_uid="uid-1",container="main"} 0.0') in text


# --- the collector cases of tests/test_telemetry.py --------------------------

def test_rings_surface_on_metrics(tmp_path):
    base = str(tmp_path / "mgr")
    w = _ring(base, "uid-1", "main", trace_id="tr-9")
    for _ in range(7):
        w.record(duration_ns=2_000_000, throttle_wait_ns=1_000_000,
                 hbm_highwater_bytes=4096)
    w.close()
    chips = [fake_chip(0)]
    headroom = chips[0].memory - 4096
    for text in render_both(chips, base_dir=base, tc_path="/nonexistent",
                            vmem_path="/nonexistent"):
        assert ('vtpu_tenant_step_duration_seconds_count{node="n1",'
                'pod_uid="uid-1",container="main"} 7') in text
        assert 'trace_id="tr-9"' in text
        assert 'vtpu_node_pressure_throttle_frac{node="n1"} 0.5' in text
        assert (f'vtpu_node_pressure_hbm_headroom_bytes{{node="n1"}} '
                f"{headroom}") in text


def test_self_observability_gauges(tmp_path):
    for text in render_both([], base_dir=str(tmp_path / "x"),
                            tc_path="/nonexistent",
                            vmem_path="/nonexistent"):
        dur = [ln for ln in text.splitlines()
               if ln.startswith("vtpu_node_scrape_duration_seconds{")]
        assert dur and float(dur[0].rsplit(" ", 1)[1]) >= 0
        for feed in ("tc_util", "vmem", "telemetry"):
            assert (f'vtpu_node_scrape_last_error{{node="n1",'
                    f'feed="{feed}"}} 0.0') in text


def test_wedged_feed_raises_error_gauge(tmp_path):
    bad_tc = tmp_path / "tc.config"
    bad_tc.write_bytes(b"garbage-not-a-feed")
    bad_vmem = tmp_path / "vmem.config"
    bad_vmem.write_bytes(b"also-garbage")
    pair = collectors([], base_dir=str(tmp_path / "x"), tc_path=str(bad_tc),
                      vmem_path=str(bad_vmem))
    texts = [c.render() for c in pair]
    assert masked(texts[1]) == masked(texts[0])
    for text in texts:
        for feed in ("tc_util", "vmem"):
            assert (f'vtpu_node_scrape_last_error{{node="n1",'
                    f'feed="{feed}"}} 1.0') in text
    os.unlink(bad_tc)
    os.unlink(bad_vmem)
    for c in pair:
        assert ('vtpu_node_scrape_last_error{node="n1",feed="tc_util"} '
                "0.0") in c.render()


def test_unreadable_ring_raises_telemetry_error_gauge(tmp_path):
    base = str(tmp_path / "mgr")
    d = os.path.join(base, "uid-1_main", consts.TELEMETRY_SUBDIR)
    os.makedirs(d)
    ring = os.path.join(d, consts.STEP_RING_NAME)
    with open(ring, "wb") as f:
        f.write(b"truncated-garbage")
    pair = collectors([], base_dir=base, tc_path="/nonexistent",
                      vmem_path="/nonexistent")
    texts = [c.render() for c in pair]
    assert masked(texts[1]) == masked(texts[0])
    for text in texts:
        assert ('vtpu_node_scrape_last_error{node="n1",feed="telemetry"}'
                " 1.0") in text
    os.unlink(ring)
    w = stepring.StepRingWriter(ring)
    w.record(duration_ns=1)
    w.close()
    for c in pair:
        assert ('vtpu_node_scrape_last_error{node="n1",feed="telemetry"}'
                " 0.0") in c.render()


def test_ledger_sum_is_the_container_gauge_across_processes(tmp_path):
    """What the card's `monitor` phase checks: a tenant's memory gauge is
    the sum of its processes' ledger entries, read back through the JAX
    package's ledger too."""
    base = str(tmp_path / "mgr")
    chips = [fake_chip(0)]
    _mk_config_dir(base, "uid-q50", "main", chips[0], cores=50,
                   memory=16 * 2**30)
    vmem_path = str(tmp_path / "vmem.config")
    led = VmemLedger(vmem_path, create=True)
    tok = fnv64("uid-q50/main")
    for pid, nbytes in ((11, 64 << 20), (12, 3 << 20)):
        led.record(pid, 0, nbytes, owner_token=tok)
    led.close()
    jl = JaxVmemLedger(vmem_path)
    want = sum(e.bytes for e in jl.entries() if e.owner_token == tok)
    jl.close()
    for text in render_both(chips, base_dir=base, tc_path="/nonexistent",
                            vmem_path=vmem_path):
        assert ('vtpu_container_memory_used_bytes{node="n1",'
                f'pod_uid="uid-q50",container="main",'
                f'uuid="{chips[0].uuid}"}} {float(want)}') in text


def test_resilience_metrics_block_renders_as_jax():
    from random import Random

    from vtpu_manager.resilience import policy as jpol
    from vtpu_manager_torch.client.kube import KubeError
    from vtpu_manager_torch.resilience import policy as tpol

    policy = tpol.RetryPolicy(max_attempts=2, rng=Random(1),
                              sleep=lambda s: None)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise KubeError(503, "x")
        return "ok"

    policy.run(flaky, op="metrics.block")
    text = tpol.render_resilience_metrics()
    assert "# TYPE vtpu_resilience_retries_total counter" in text
    assert 'vtpu_resilience_retries_total{op="metrics.block"} 1' in text
    assert 'vtpu_resilience_recovered_total{op="metrics.block"} 1' in text
    assert "vtpu_reschedule_reconcile_failures_total 0" in text
    assert "vtpu_circuit_state" not in text
    # the JAX package's render of the same counters, with its failpoint
    # registry disabled (nothing armed), is the same text
    saved = dict(jpol.COUNTERS.data)
    try:
        jpol.COUNTERS.data.clear()
        jpol.COUNTERS.data.update(tpol.COUNTERS.data)
        assert text == jpol.render_resilience_metrics()
    finally:
        jpol.COUNTERS.data.clear()
        jpol.COUNTERS.data.update(saved)


# --- the pod-resources codec ---------------------------------------------

def _pb_response():
    resp = pb.ListPodResourcesResponse()
    for i, name in enumerate(("main", "side")):
        pod = resp.pod_resources.add(name=f"pod-{i}", namespace="ns")
        cont = pod.containers.add(name=name)
        cont.devices.add(resource_name=consts.vtpu_number_resource(),
                         device_ids=[f"GPU-{i}::0", f"GPU-{i}::1"])
        cont.devices.add(resource_name="nvidia.com/gpu", device_ids=[])
    resp.pod_resources.add(name="empty")
    return resp


@pytest.mark.parametrize("name", ["ListPodResourcesRequest",
                                  "ListPodResourcesResponse", "PodResources",
                                  "ContainerResources", "ContainerDevices"])
def test_codec_round_trips_against_podresources_pb2(name):
    full = _pb_response()
    samples = {
        "ListPodResourcesRequest": pb.ListPodResourcesRequest(),
        "ListPodResourcesResponse": full,
        "PodResources": full.pod_resources[0],
        "ContainerResources": full.pod_resources[1].containers[0],
        "ContainerDevices": full.pod_resources[0].containers[0].devices[0],
    }
    raw = samples[name].SerializeToString()
    ours = getattr(pr, name).decode(raw)
    assert ours.encode() == raw
    assert type(samples[name]).FromString(ours.encode()) == samples[name]


def test_codec_skips_unknown_fields():
    """A newer kubelet adds fields (v1's topology, cpu ids, memory): they
    are skipped, the known ones read."""
    from vtpu_manager_torch.kubeletplugin.api.nri_messages import (_LEN,
                                                                   _VARINT,
                                                                   _record,
                                                                   _varint)
    dev = (_record(1, _LEN, b"google.com/vtpu-number")
           + _record(2, _LEN, b"GPU-0::0")
           + _record(3, _LEN, b"\x0a\x02\x08\x01")       # topology
           + _record(9, _VARINT, _varint(7)))
    cont = _record(1, _LEN, b"main") + _record(2, _LEN, dev) \
        + _record(3, _VARINT, _varint(2))                 # cpu_ids
    pod = _record(1, _LEN, b"p") + _record(2, _LEN, b"ns") \
        + _record(3, _LEN, cont) + _record(4, _LEN, b"x")
    raw = _record(1, _LEN, pod) + _record(7, _LEN, b"?")
    got = pr.ListPodResourcesResponse.decode(raw)
    want = pb.ListPodResourcesResponse.FromString(raw)
    (p,) = got.pod_resources
    assert (p.name, p.namespace) == (want.pod_resources[0].name, "ns")
    (c,) = p.containers
    assert c.name == "main"
    assert c.devices[0].device_ids == ["GPU-0::0"]
    assert c.devices[0].resource_name == "google.com/vtpu-number"
    assert pb.ListPodResourcesResponse.FromString(got.encode()) == \
        pb.ListPodResourcesResponse.FromString(
            pb.ListPodResourcesResponse(pod_resources=[
                pb.PodResources(name="p", namespace="ns", containers=[
                    pb.ContainerResources(name="main", devices=[
                        pb.ContainerDevices(
                            resource_name="google.com/vtpu-number",
                            device_ids=["GPU-0::0"])])])]).SerializeToString())


def test_list_pod_resources_over_grpc_as_jax(tmp_path):
    sock = str(tmp_path / "podres.sock")
    server = _fake_pod_resources_server(sock, ["main", "side"])
    try:
        ours = pod_resources.list_pod_resources(sock)
        theirs = jax_pod_resources.list_pod_resources(sock)
        view = pod_resources.kubelet_view(sock, str(tmp_path / "none"))
    finally:
        server.stop(0)
    assert [tuple(vars(e).values()) for e in ours] == \
        [tuple(vars(e).values()) for e in theirs]
    assert view == pod_resources.KubeletView(
        source="podresources", containers=frozenset({"main", "side"}))


def test_missing_socket_or_grpc_falls_back_to_checkpoint(tmp_path,
                                                        monkeypatch):
    import sys
    ckpt = str(tmp_path / "ckpt")
    _checkpoint(ckpt, [("uid-1", "main")])
    assert pod_resources.list_pod_resources(str(tmp_path / "none")) is None
    sock = tmp_path / "present.sock"
    sock.write_text("")
    monkeypatch.setitem(sys.modules, "grpc", None)       # no grpc here
    assert pod_resources.list_pod_resources(str(sock)) is None
    view = pod_resources.kubelet_view(str(sock), ckpt)
    assert view.source == "checkpoint"
    assert view.corroborates("uid-1", "main") is True
    assert view.corroborates("uid-2", "main") is False
    assert pod_resources.kubelet_view(
        str(sock), str(tmp_path / "none")).corroborates("u", "c") is None


def test_kubelet_view_agrees_with_jax(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _checkpoint(ckpt, [("uid-1", "main"), ("uid-2", "x")])
    ours = pod_resources.kubelet_view(str(tmp_path / "no"), ckpt)
    theirs = jax_pod_resources.kubelet_view(str(tmp_path / "no"), ckpt)
    assert (ours.source, ours.containers, ours.pairs) == \
        (theirs.source, theirs.containers, theirs.pairs)
    probe = SimpleNamespace(pairs=[("uid-1", "main"), ("uid-3", "main")])
    for pair in probe.pairs:
        assert ours.corroborates(*pair) == theirs.corroborates(*pair)
