"""The port's device plugin: advertisement, preferred allocation, Allocate,
PreStartContainer and the gRPC side, against the JAX package's plugin.

The cases of tests/test_deviceplugin.py on the port's fake H100s, kubelet
simulated by calling the servicer and over a real unix socket; then the
two plugins side by side on the same devices and pod (the config file
byte for byte, the environment name for name), and a pod the JAX
scheduler's filter and bind commit onto the port's registry.
"""

import copy
import os
from concurrent import futures
from types import SimpleNamespace

import pytest

from vtpu_manager.client.fake import FakeKubeClient as JaxFakeKubeClient
from vtpu_manager.deviceplugin.api import deviceplugin_pb2 as jpb
from vtpu_manager.deviceplugin.vnum import VnumPlugin as JaxVnumPlugin
from vtpu_manager.device.types import ChipSpec as JaxChipSpec
from vtpu_manager.manager.device_manager import \
    DeviceManager as JaxDeviceManager
from vtpu_manager.util import consts as jc
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.client.kube import KubeError
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.deviceplugin.api import messages as api
from vtpu_manager_torch.deviceplugin.vnum import (VnumPlugin, device_id,
                                                  interposer_container_path)
from vtpu_manager_torch.device.claims import DeviceClaim, PodDeviceClaims
from vtpu_manager_torch.manager.device_manager import (DeviceManager,
                                                       device_node_probe)
from vtpu_manager_torch.tpu.discovery import FakeBackend, TorchBackend
from vtpu_manager_torch.util import consts

GIB = 2**30


def make_manager(client, n_chips=2, split=4):
    client.add_node({"metadata": {"name": "node-1", "annotations": {}}})
    mgr = DeviceManager("node-1", client,
                        node_config=NodeConfig(device_split_count=split),
                        backends=[FakeBackend(n_chips=n_chips)])
    mgr.init_devices()
    return mgr


def committed_pod(mgr, cores=50, memory=2 * GIB, name="p1",
                  container="main", chip_idx=0, annotations=None):
    chip = mgr.chips[chip_idx]
    claims = PodDeviceClaims()
    claims.add(container, DeviceClaim(chip.uuid, chip.index, cores, memory))
    anns = {consts.pre_allocated_annotation(): claims.encode(),
            consts.predicate_node_annotation(): "node-1"}
    anns.update(annotations or {})
    return {
        "metadata": {"name": name, "namespace": "default",
                     "uid": f"uid-{name}", "annotations": anns},
        "spec": {"nodeName": "node-1", "containers": [{"name": container}]},
        "status": {"phase": "Pending"},
    }


def node_dirs(root):
    return {"base_dir": str(root / "mgr"), "lock_dir": str(root / "locks"),
            "vmem_dir": str(root / "vmem"),
            "watcher_dir": str(root / "watcher"),
            "shim_host_dir": str(root / "driver")}


@pytest.fixture
def plugin(tmp_path):
    client = FakeKubeClient()
    mgr = make_manager(client)
    p = VnumPlugin(mgr, client, "node-1", node_config=NodeConfig(),
                   **node_dirs(tmp_path))
    return p, client, mgr


def alloc(p, *ids):
    return p.allocate(api.AllocateRequest(
        [api.ContainerAllocateRequest(list(ids))])).container_responses[0]


def config_of(cresp):
    host = next(m.host_path for m in cresp.mounts
                if m.container_path == f"{consts.MANAGER_BASE_DIR}/config")
    return vc.read_config(os.path.join(host, "vtpu.config"))


class TestAdvertisement:
    def test_split_slots(self, plugin):
        p, _, _ = plugin
        devices = p.list_devices()
        assert len(devices) == 2 * 4
        assert all(d.health == "Healthy" for d in devices)
        assert devices[5].ID == "fake-1::1"

    def test_unhealthy_propagates(self, plugin):
        p, _, mgr = plugin
        mgr.mark_unhealthy(mgr.chips[0].uuid)
        sick = [d for d in p.list_devices() if d.health == "Unhealthy"]
        assert len(sick) == 4
        mgr.mark_healthy(mgr.chips[0].uuid)
        assert all(d.health == "Healthy" for d in p.list_devices())

    def test_registration_reaches_the_node(self, plugin):
        _, client, mgr = plugin
        mgr.register_node()
        anns = client.get_node("node-1")["metadata"]["annotations"]
        assert anns[consts.node_device_register_annotation()] == \
            mgr.registry().encode()
        assert float(anns[consts.node_device_heartbeat_annotation()]) > 0


class TestPreferredAllocation:
    def test_honors_preallocation(self, plugin):
        p, client, mgr = plugin
        client.add_pod(committed_pod(mgr, chip_idx=1))
        available = [device_id(c.uuid, s) for c in mgr.chips
                     for s in range(4)]
        resp = p.get_preferred_allocation(api.PreferredAllocationRequest([
            api.ContainerPreferredAllocationRequest(
                available_deviceIDs=available, allocation_size=1)]))
        ids = resp.container_responses[0].deviceIDs
        assert len(ids) == 1 and ids[0].startswith(mgr.chips[1].uuid)

    def test_without_a_pod_takes_must_include_first(self, plugin):
        p, _, mgr = plugin
        resp = p.get_preferred_allocation(api.PreferredAllocationRequest([
            api.ContainerPreferredAllocationRequest(
                available_deviceIDs=["fake-0::0", "fake-0::1"],
                must_include_deviceIDs=["fake-1::3"], allocation_size=2)]))
        assert resp.container_responses[0].deviceIDs == ["fake-1::3",
                                                         "fake-0::0"]


class TestAllocate:
    def test_full_path(self, plugin):
        p, client, mgr = plugin
        client.add_pod(committed_pod(mgr, cores=25, memory=4 * GIB))
        chip = mgr.chips[0]
        cresp = alloc(p, device_id(chip.uuid, 0))
        envs = cresp.envs
        assert envs[f"{consts.ENV_MEM_LIMIT}_0"] == str(4 * GIB)
        assert envs[f"{consts.ENV_CORE_LIMIT}_0"] == "25"
        assert envs[consts.ENV_VISIBLE_DEVICES] == "0"
        assert envs[consts.ENV_NVIDIA_VISIBLE_DEVICES] == chip.uuid
        assert envs[consts.ENV_REAL_CUDA_LIBRARY_PATH] == "libcuda.so.1"
        assert envs[consts.ENV_CONFIG_PATH] == consts.CONTAINER_CONFIG
        assert [d.host_path for d in cresp.devices] == \
            ["/dev/nvidia0", "/dev/nvidiactl", "/dev/nvidia-uvm"]
        mounts = {m.container_path: m for m in cresp.mounts}
        preload = mounts[consts.LD_SO_PRELOAD]
        assert preload.read_only
        with open(preload.host_path) as f:
            assert f.read() == interposer_container_path() + "\n"
        assert mounts[consts.DRIVER_DIR].host_path == p.shim_host_dir
        assert mounts[consts.LOCK_DIR].host_path == p.lock_dir
        assert mounts[consts.VMEM_DIR].host_path == p.vmem_dir
        assert mounts[consts.WATCHER_DIR].host_path == p.watcher_dir
        cfg = config_of(cresp)
        assert cfg.devices[0].hard_core == 25
        assert cfg.devices[0].total_memory == 4 * GIB
        assert cfg.devices[0].real_memory == chip.memory
        anns = client.get_pod("default", "p1")["metadata"]["annotations"]
        assert anns[consts.allocation_status_annotation()] == "succeed"
        real = PodDeviceClaims.decode(anns[consts.real_allocated_annotation()])
        assert real.all_claims()[0].uuid == chip.uuid

    def test_device_node_minor_comes_from_discovery(self, plugin):
        p, client, mgr = plugin
        mgr.minors = {0: 5, 1: 2}
        client.add_pod(committed_pod(mgr, chip_idx=1))
        cresp = alloc(p, device_id(mgr.chips[1].uuid, 0))
        assert cresp.devices[0].host_path == "/dev/nvidia2"

    def test_torch_discovered_chip_gets_no_device_node(self, plugin,
                                                       monkeypatch):
        # CUDA's index is not the device-node minor: a card torch found
        # is refused a node rather than handed another card's
        import torch
        props = SimpleNamespace(uuid="0a1b", name="NVIDIA H100 80GB HBM3",
                                total_memory=80 * GIB,
                                multi_processor_count=132)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: props)
        p, client, _ = plugin
        mgr = DeviceManager("node-1", client, backends=[TorchBackend()])
        assert [c.uuid for c in mgr.init_devices()] == ["GPU-0a1b"]
        assert mgr.minors == {}
        with pytest.raises(KeyError, match="no device-node minor"):
            mgr.device_node(0)
        with pytest.raises(KeyError):
            device_node_probe(mgr)(mgr.chips[0])
        p.manager = mgr
        client.add_pod(committed_pod(mgr))
        with pytest.raises(KeyError):
            alloc(p, device_id("GPU-0a1b", 0))
        anns = client.get_pod("default", "p1")["metadata"]["annotations"]
        assert anns[consts.allocation_status_annotation()] == "failed"

    def test_multi_container_pod_both_enforced(self, plugin):
        p, client, mgr = plugin
        pod = committed_pod(mgr, chip_idx=0)
        claims = PodDeviceClaims.decode(
            pod["metadata"]["annotations"][consts.pre_allocated_annotation()])
        chip1 = mgr.chips[1]
        claims.add("side", DeviceClaim(chip1.uuid, chip1.index, 20, GIB))
        pod["metadata"]["annotations"][consts.pre_allocated_annotation()] = \
            claims.encode()
        pod["spec"]["containers"].append({"name": "side"})
        client.add_pod(pod)
        r1 = alloc(p, device_id(mgr.chips[0].uuid, 0))
        assert f"{consts.ENV_CORE_LIMIT}_0" in r1.envs
        r2 = alloc(p, device_id(chip1.uuid, 0))
        assert r2.envs[f"{consts.ENV_CORE_LIMIT}_0"] == "20"
        real = PodDeviceClaims.decode(
            client.get_pod("default", "p1")["metadata"]["annotations"][
                consts.real_allocated_annotation()])
        assert set(real.containers) == {"main", "side"}

    def test_balance_policy_soft_limit(self, plugin):
        p, client, mgr = plugin
        client.add_pod(committed_pod(mgr, cores=30, annotations={
            consts.compute_policy_annotation(): "balance"}))
        cresp = alloc(p, device_id(mgr.chips[0].uuid, 0))
        assert cresp.envs[f"{consts.ENV_CORE_SOFT_LIMIT}_0"] == "100"
        dev = config_of(cresp).devices[0]
        assert (dev.hard_core, dev.soft_core, dev.core_limit) == \
            (30, 100, vc.CORE_LIMIT_SOFT)

    def test_unmatched_devices_served_permissively(self, plugin):
        p, _, mgr = plugin
        cresp = alloc(p, device_id(mgr.chips[0].uuid, 2))
        assert consts.ENV_VISIBLE_DEVICES in cresp.envs
        assert f"{consts.ENV_CORE_LIMIT}_0" not in cresp.envs
        assert cresp.mounts == []        # no config, no interposer

    def test_step_telemetry_gate(self, plugin):
        p, client, mgr = plugin
        client.add_pod(committed_pod(mgr, name="off"))
        off = alloc(p, device_id(mgr.chips[0].uuid, 0))
        p.step_telemetry_enabled = True
        client.add_pod(committed_pod(mgr, name="on", chip_idx=1))
        on = alloc(p, device_id(mgr.chips[1].uuid, 0))
        tel = os.path.join(consts.MANAGER_BASE_DIR, consts.TELEMETRY_SUBDIR)
        assert consts.ENV_STEP_TELEMETRY not in off.envs
        assert tel not in [m.container_path for m in off.mounts]
        assert on.envs[consts.ENV_STEP_RING_PATH] == os.path.join(
            tel, consts.STEP_RING_NAME)
        mount = next(m for m in on.mounts if m.container_path == tel)
        assert not mount.read_only and os.path.isdir(mount.host_path)
        assert not os.path.exists(os.path.join(
            p._container_dir("uid-off", "main"), consts.TELEMETRY_SUBDIR))

    def test_failed_config_write_fails_the_rpc(self, plugin, tmp_path):
        p, client, mgr = plugin
        blocker = tmp_path / "not-a-dir"
        blocker.write_text("")
        p.base_dir = str(blocker)
        client.add_pod(committed_pod(mgr))
        with pytest.raises(OSError):
            alloc(p, device_id(mgr.chips[0].uuid, 0))
        anns = client.get_pod("default", "p1")["metadata"]["annotations"]
        assert anns[consts.allocation_status_annotation()] == "failed"
        assert consts.real_allocated_annotation() not in anns

    def test_failed_pod_list_fails_the_rpc(self, plugin):
        # a pod the scheduler committed is never served unenforced because
        # the plugin could not look for its pre-allocation
        p, client, mgr = plugin
        client.add_pod(committed_pod(mgr))

        def down():
            raise KubeError(503, "api server unavailable")

        client.list_pods = down
        dev = device_id(mgr.chips[0].uuid, 0)
        with pytest.raises(KubeError):
            alloc(p, dev)
        assert not os.path.exists(p.base_dir)     # no config, no preload
        anns = client.get_pod("default", "p1")["metadata"]["annotations"]
        assert consts.allocation_status_annotation() not in anns
        # the preference is only a hint: it still answers
        pref = p.get_preferred_allocation(api.PreferredAllocationRequest([
            api.ContainerPreferredAllocationRequest(
                available_deviceIDs=[dev], allocation_size=1)]))
        assert pref.container_responses[0].deviceIDs == [dev]

    def test_prestart_verifies_and_heals(self, plugin):
        p, client, mgr = plugin
        client.add_pod(committed_pod(mgr))
        ids = [device_id(mgr.chips[0].uuid, 0)]
        alloc(p, *ids)
        cfg_path = os.path.join(p._container_dir("uid-p1", "main"),
                                "config", "vtpu.config")
        pids = os.path.join(os.path.dirname(cfg_path),
                            consts.PIDS_CONFIG_NAME)
        open(pids, "w").close()
        os.unlink(cfg_path)
        p.pre_start_container(api.PreStartContainerRequest(ids))
        dev = vc.read_config(cfg_path).devices[0]
        assert (dev.hard_core, dev.total_memory) == (50, 2 * GIB)
        assert not os.path.exists(pids)

    def test_prestart_unknown_devices_fails(self, plugin):
        p, _, _ = plugin
        with pytest.raises(RuntimeError):
            p.pre_start_container(api.PreStartContainerRequest(["ghost::0"]))

    def test_prestart_refuses_same_uuid_different_slot(self, plugin):
        p, client, mgr = plugin
        client.add_pod(committed_pod(mgr))
        chip = mgr.chips[0]
        alloc(p, device_id(chip.uuid, 0))
        with pytest.raises(RuntimeError):
            p.pre_start_container(api.PreStartContainerRequest(
                [device_id(chip.uuid, 1)]))


# --- the port's plugin beside the JAX package's -------------------------


def jax_plugin(port_mgr, root, **kw):
    client = JaxFakeKubeClient()
    mgr = JaxDeviceManager("node-1", client)
    mgr.chips = [JaxChipSpec.from_wire(c.to_wire()) for c in port_mgr.chips]
    return JaxVnumPlugin(mgr, client, "node-1", base_dir=str(root), **kw), \
        client


POLICIES = {
    "fixed": {},
    "balance": {consts.compute_policy_annotation(): "balance"},
    "none": {consts.compute_policy_annotation(): "none"},
    "oversold": {consts.memory_oversold_annotation(): "true"},
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("cores,memory", [(25, 4 * GIB), (0, GIB),
                                          (60, 0)])
def test_config_file_byte_identical_to_jax(plugin, tmp_path, policy, cores,
                                           memory):
    p, client, mgr = plugin
    pod = committed_pod(mgr, cores=cores, memory=memory, chip_idx=1,
                        annotations=POLICIES[policy])
    jp, jclient = jax_plugin(mgr, tmp_path / "jax")
    client.add_pod(copy.deepcopy(pod))
    jclient.add_pod(copy.deepcopy(pod))
    ids = [device_id(mgr.chips[1].uuid, 2)]
    alloc(p, *ids)
    jp.allocate(jpb.AllocateRequest(container_requests=[
        jpb.ContainerAllocateRequest(devicesIDs=ids)]))
    rel = os.path.join("uid-p1_main", "config", "vtpu.config")
    with open(os.path.join(p.base_dir, rel), "rb") as f:
        mine = f.read()
    with open(os.path.join(str(tmp_path / "jax"), rel), "rb") as f:
        theirs = f.read()
    assert len(mine) == vc.CONFIG_SIZE and mine == theirs


@pytest.mark.parametrize("telemetry", [False, True])
def test_environment_differs_from_jax_only_by_the_cuda_names(
        plugin, tmp_path, telemetry):
    p, client, mgr = plugin
    p.step_telemetry_enabled = telemetry
    pod = committed_pod(mgr, cores=40, memory=3 * GIB)
    jp, jclient = jax_plugin(mgr, tmp_path / "jax")
    jp.step_telemetry_enabled = telemetry
    client.add_pod(copy.deepcopy(pod))
    jclient.add_pod(copy.deepcopy(pod))
    ids = [device_id(mgr.chips[0].uuid, 0)]
    mine = alloc(p, *ids)
    theirs = jp.allocate(jpb.AllocateRequest(container_requests=[
        jpb.ContainerAllocateRequest(devicesIDs=ids)])).container_responses[0]
    jenvs = dict(theirs.envs)
    shared = set(mine.envs) & set(jenvs)
    assert {k: mine.envs[k] for k in shared} == {k: jenvs[k] for k in shared}
    assert set(jenvs) - shared == {
        jc.ENV_TPU_VISIBLE_DEVICES, jc.ENV_TPU_LIBRARY_PATH,
        jc.ENV_PJRT_PLUGIN_LIBRARY_PATH, jc.ENV_VTPU_REAL_PLUGIN_PATH}
    assert set(mine.envs) - shared == {consts.ENV_NVIDIA_VISIBLE_DEVICES,
                                       consts.ENV_REAL_CUDA_LIBRARY_PATH}
    assert (consts.ENV_STEP_RING_PATH in shared) == telemetry
    # mounts: the same container paths, and the preload file
    assert {m.container_path for m in mine.mounts} == \
        {m.container_path for m in theirs.mounts} | {consts.LD_SO_PRELOAD}


def test_pod_committed_by_the_jax_scheduler_is_allocated(tmp_path):
    """The cluster path: the port's device manager registers an H100 node,
    the JAX scheduler's filter and bind commit a 25 % / 4 GiB pod onto it,
    and the port's plugin allocates that pod."""
    from vtpu_manager.scheduler.bind import BindPredicate
    from vtpu_manager.scheduler.filter import FilterPredicate

    client = FakeKubeClient()
    client.add_node({"metadata": {"name": "gpu-node", "annotations": {}}})
    mgr = DeviceManager("gpu-node", client,
                        node_config=NodeConfig(device_split_count=4),
                        backends=[FakeBackend(1, "nvidia-h100-sxm")])
    mgr.init_devices()
    mgr.register_node()

    jclient = JaxFakeKubeClient()
    jclient.add_node(client.get_node("gpu-node"))
    pod = {"metadata": {"name": "p1", "namespace": "default",
                        "uid": "uid-p1", "annotations": {}},
           "spec": {"containers": [{"name": "main", "resources": {"limits": {
               jc.vtpu_number_resource(): 1, jc.vtpu_cores_resource(): 25,
               jc.vtpu_memory_resource(): 4096}}}]},
           "status": {"phase": "Pending"}}
    jclient.add_pod(pod)
    result = FilterPredicate(jclient).filter({"Pod": pod,
                                              "NodeNames": ["gpu-node"]})
    assert result.node_names == ["gpu-node"], result
    bound = BindPredicate(jclient).bind({"PodName": "p1",
                                         "PodNamespace": "default",
                                         "PodUID": "uid-p1",
                                         "Node": "gpu-node"})
    assert not bound.error, bound

    client.add_pod(jclient.get_pod("default", "p1"))
    p = VnumPlugin(mgr, client, "gpu-node", **node_dirs(tmp_path))
    chip = mgr.chips[0]
    cresp = alloc(p, device_id(chip.uuid, 0))
    dev = config_of(cresp).devices[0]
    assert (dev.uuid, dev.hard_core, dev.total_memory) == \
        (chip.uuid, 25, 4096 * 2**20)
    assert cresp.envs[consts.ENV_NVIDIA_VISIBLE_DEVICES] == chip.uuid
    anns = client.get_pod("default", "p1")["metadata"]["annotations"]
    assert anns[consts.allocation_status_annotation()] == "succeed"


# --- gRPC: the port's PluginServer against a kubelet ---------------------


def _channel_calls(chan):
    from vtpu_manager_torch.deviceplugin.api import deviceplugin_pb2 as pb
    law = chan.unary_stream(
        "/v1beta1.DevicePlugin/ListAndWatch",
        request_serializer=pb.Empty.SerializeToString,
        response_deserializer=pb.ListAndWatchResponse.FromString)
    allocate = chan.unary_unary(
        "/v1beta1.DevicePlugin/Allocate",
        request_serializer=pb.AllocateRequest.SerializeToString,
        response_deserializer=pb.AllocateResponse.FromString)
    return pb, law, allocate


class TestGrpc:
    def test_round_trip_over_unix_socket(self, plugin, tmp_path):
        import grpc

        from vtpu_manager_torch.deviceplugin.base import PluginServer
        p, client, mgr = plugin
        server = PluginServer(p, plugin_dir=str(tmp_path / "sock"))
        server.serve()
        try:
            with grpc.insecure_channel(
                    f"unix://{server.socket_path}") as chan:
                pb, law, allocate = _channel_calls(chan)
                opts = chan.unary_unary(
                    "/v1beta1.DevicePlugin/GetDevicePluginOptions",
                    request_serializer=pb.Empty.SerializeToString,
                    response_deserializer=pb.DevicePluginOptions.FromString)(
                        pb.Empty(), timeout=5)
                assert opts.pre_start_required
                assert not opts.get_preferred_allocation_available
                first = next(iter(law(pb.Empty(), timeout=5)))
                assert len(first.devices) == 8
                assert first.devices[0].topology.nodes[0].ID == 0
                client.add_pod(committed_pod(mgr))
                ids = [device_id(mgr.chips[0].uuid, 0)]
                resp = allocate(pb.AllocateRequest(container_requests=[
                    pb.ContainerAllocateRequest(devicesIDs=ids)]), timeout=5)
                cresp = resp.container_responses[0]
                assert cresp.envs["VTPU_MEM_LIMIT_0"] == str(2 * GIB)
                assert [d.host_path for d in cresp.devices][0] == \
                    "/dev/nvidia0"
                assert any(m.container_path == consts.LD_SO_PRELOAD
                           and m.read_only for m in cresp.mounts)
                prestart = chan.unary_unary(
                    "/v1beta1.DevicePlugin/PreStartContainer",
                    request_serializer=
                    pb.PreStartContainerRequest.SerializeToString,
                    response_deserializer=
                    pb.PreStartContainerResponse.FromString)
                prestart(pb.PreStartContainerRequest(devicesIDs=ids),
                         timeout=5)
                with pytest.raises(grpc.RpcError):
                    prestart(pb.PreStartContainerRequest(
                        devicesIDs=["ghost::0"]), timeout=5)
                pref = chan.unary_unary(
                    "/v1beta1.DevicePlugin/GetPreferredAllocation",
                    request_serializer=
                    pb.PreferredAllocationRequest.SerializeToString,
                    response_deserializer=
                    pb.PreferredAllocationResponse.FromString)(
                        pb.PreferredAllocationRequest(container_requests=[
                            pb.ContainerPreferredAllocationRequest(
                                available_deviceIDs=["fake-1::0"],
                                allocation_size=1)]), timeout=5)
                assert list(pref.container_responses[0].deviceIDs) == \
                    ["fake-1::0"]
        finally:
            server.stop()

    def test_generated_module_is_the_jax_one(self):
        from vtpu_manager_torch.deviceplugin.api import deviceplugin_pb2 as pb
        assert pb.AllocateRequest is jpb.AllocateRequest
        assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb

    def test_listandwatch_streams_health_flip(self, plugin, tmp_path):
        import grpc

        from vtpu_manager_torch.deviceplugin.base import PluginServer
        p, _, mgr = plugin
        server = PluginServer(p, plugin_dir=str(tmp_path / "hsock"))
        server.serve()
        try:
            with grpc.insecure_channel(
                    f"unix://{server.socket_path}") as chan:
                pb, law, _ = _channel_calls(chan)
                it = iter(law(pb.Empty(), timeout=30))
                first = next(it)
                assert all(d.health == "Healthy" for d in first.devices)
                mgr.mark_unhealthy(mgr.chips[0].uuid)
                second = next(it)
                assert len([d for d in second.devices
                            if d.health == "Unhealthy"]) == 4
        finally:
            server.stop()


def fake_kubelet(sock, registrations):
    """A kubelet's Registration service on a unix socket."""
    import grpc

    from vtpu_manager_torch.deviceplugin.api import deviceplugin_pb2 as pb

    def register(request, context):
        registrations.append((request.resource_name, request.endpoint,
                              request.version,
                              request.options.pre_start_required))
        return pb.Empty()

    s = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    s.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "v1beta1.Registration", {"Register": grpc.unary_unary_rpc_method_handler(
            register, request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString)}),))
    s.add_insecure_port(f"unix://{sock}")
    s.start()
    return s


def test_kubelet_register_listandwatch_allocate_and_restart(plugin,
                                                            tmp_path):
    import time

    import grpc

    from vtpu_manager_torch.deviceplugin.base import PluginServer
    p, client, mgr = plugin
    plugin_dir = str(tmp_path / "kubelet-plugins")
    os.makedirs(plugin_dir)
    kubelet_sock = os.path.join(plugin_dir, "kubelet.sock")
    registrations = []
    kubelet = fake_kubelet(kubelet_sock, registrations)
    server = PluginServer(p, plugin_dir=plugin_dir,
                          kubelet_socket=kubelet_sock)
    try:
        server.serve()
        server.register()
        assert registrations[0] == (p.resource_name, "vtpu-number.sock",
                                    "v1beta1", True)
        with grpc.insecure_channel(f"unix://{server.socket_path}") as chan:
            pb, law, allocate = _channel_calls(chan)
            assert len(next(iter(law(pb.Empty(), timeout=10))).devices) == 8
            client.add_pod(committed_pod(mgr))
            resp = allocate(pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(
                    devicesIDs=[device_id(mgr.chips[0].uuid, 0)])]),
                timeout=10)
            assert "VTPU_MEM_LIMIT_0" in resp.container_responses[0].envs
        # kubelet restarts: its socket is made anew, the plugin registers
        # again
        server.watch_kubelet_restarts(poll_s=0.05)
        kubelet.stop(grace=0)
        kubelet = fake_kubelet(kubelet_sock, registrations)
        deadline = time.time() + 10
        while len(registrations) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(registrations) >= 2, "no re-registration"
    finally:
        server.stop()
        kubelet.stop(grace=0)


# --- the fake API client's watch, and device health ----------------------


def test_fake_client_watch_matches_jax():
    from vtpu_manager.client.kube import KubeError as JaxKubeError

    from vtpu_manager_torch.client.kube import KubeError
    mine, theirs = FakeKubeClient(), JaxFakeKubeClient()
    for c in (mine, theirs):
        c.add_node({"metadata": {"name": "n1"}})
        c.patch_node_annotations("n1", {"a": "1"})
        c.add_pod({"metadata": {"name": "p", "namespace": "default"},
                   "spec": {}})
        c.patch_pod_annotations("default", "p", {"b": "2", "gone": None})
    for kind in ("watch_nodes", "watch_pods"):
        a, b = getattr(mine, kind)("0"), getattr(theirs, kind)("0")
        assert [(e["type"], e["resourceVersion"]) for e in a] == \
            [(e["type"], e["resourceVersion"]) for e in b]
        assert getattr(mine, kind)(a[-1]["resourceVersion"])[0]["type"] == \
            "BOOKMARK"
    mine.compact_watch_events()
    theirs.compact_watch_events()
    with pytest.raises(KubeError) as e:
        mine.watch_pods("1")
    with pytest.raises(JaxKubeError) as je:
        theirs.watch_pods("1")
    assert e.value.status == je.value.status == 410
    assert mine.list_pods(field_selector="spec.nodeName!=") == []
    with pytest.raises(KubeError):
        mine.patch_pod_annotations("default", "ghost", {"x": "1"})


@pytest.mark.parametrize("verdicts", [
    [False, False, False, True],          # flips at the third, recovers
    [False, None, False, True, False],    # a probe that did not run
    [False, False, True, False, False],   # the streak restarts
    ["raise", "raise", "raise"],          # a raising probe reads sick
])
def test_health_watcher_flips_as_jax(verdicts):
    from vtpu_manager.manager.device_manager import \
        HealthWatcher as JaxHealthWatcher

    from vtpu_manager_torch.manager.device_manager import HealthWatcher

    def run(watcher_cls, mgr):
        seq = iter(verdicts)

        def probe(chip):
            v = next(seq)
            if v == "raise":
                raise OSError("probe broke")
            return v

        w = watcher_cls(mgr, probe, flip_after=3)
        seen = []
        for _ in verdicts:
            w.check_once()
            seen.append(mgr.chips[0].healthy)
        return seen

    client = FakeKubeClient()
    mine = make_manager(client, n_chips=1)
    jclient = JaxFakeKubeClient()
    jclient.add_node({"metadata": {"name": "node-1"}})
    theirs = JaxDeviceManager("node-1", jclient)
    theirs.chips = [JaxChipSpec.from_wire(c.to_wire()) for c in mine.chips]
    assert run(HealthWatcher, mine) == run(JaxHealthWatcher, theirs)


def test_external_probe_verdicts(tmp_path):
    from vtpu_manager_torch.manager.device_manager import make_external_probe
    script = tmp_path / "probe.sh"
    script.write_text('#!/bin/sh\n[ "$2" = "fake-0" ]\n')
    script.chmod(0o755)
    chips = FakeBackend(2).discover().chips
    probe = make_external_probe(str(script))
    assert [probe(c) for c in chips] == [True, False]
    assert make_external_probe(str(tmp_path / "missing"))(chips[0]) is None
