"""The port's DRA kubelet plugin against the JAX package's.

The cases of tests/test_dra.py (checkpoint, DeviceState, gRPC, claim
source resilience, ownership, claim resolution, ResourceSlice, health,
readiness) on the port; then both plugins side by side on the same chips
and claims (literal dicts): `vtpu.config` and the checkpoint byte for
byte, each package loading the other's checkpoint, the resolved
partitions, the ResourceSlice and the NodePrepare responses equal, and
the CDI specs differing only by the listed CUDA names, device nodes and
identity variables. Last, the identity the port adds, on the fake
driver: two processes of one claim share its cap; with the JAX package's
environment they do not.
"""

import json
import os
import shutil
import subprocess
import tempfile
import urllib.error
import urllib.request
from dataclasses import astuple
from random import Random

import grpc
import pytest

from vtpu_manager.claimresolve import resolve as jresolve
from vtpu_manager.device.types import ChipSpec as JaxChipSpec
from vtpu_manager.kubeletplugin import allocatable as jalloc
from vtpu_manager.kubeletplugin import cdi as jcdi
from vtpu_manager.kubeletplugin import checkpoint as jckpt
from vtpu_manager.kubeletplugin.api import dra_pb2 as jpb
from vtpu_manager.kubeletplugin.device_state import \
    DeviceState as JaxDeviceState
from vtpu_manager.kubeletplugin.driver import ClaimSource as JaxClaimSource
from vtpu_manager.kubeletplugin.driver import DraDriver as JaxDraDriver
from vtpu_manager.resilience import policy as jpolicy
from vtpu_manager.util import consts as jc
from vtpu_manager_torch import bench_dra, bench_quota, build
from vtpu_manager_torch.claimresolve.resolve import (PartitionKey,
                                                     pod_partitions,
                                                     resolve_claim_partitions)
from vtpu_manager_torch.client.fake import FakeKubeClient
from vtpu_manager_torch.client.kube import KubeError
from vtpu_manager_torch.config import vtpu_config as vc
from vtpu_manager_torch.config.node_config import NodeConfig
from vtpu_manager_torch.config.vmem import VmemLedger
from vtpu_manager_torch.device.types import ChipSpec
from vtpu_manager_torch.deviceplugin.vnum import (install_interposer,
                                                  interposer_container_path)
from vtpu_manager_torch.kubeletplugin import cdi
from vtpu_manager_torch.kubeletplugin.allocatable import build_resource_slice
from vtpu_manager_torch.kubeletplugin.api import messages as api
from vtpu_manager_torch.kubeletplugin.checkpoint import (Checkpoint,
                                                         PreparedClaim)
from vtpu_manager_torch.kubeletplugin.device_state import (DeviceState,
                                                           PrepareError)
from vtpu_manager_torch.kubeletplugin.driver import (ClaimLookupError,
                                                     ClaimSource, DraDriver)
from vtpu_manager_torch.kubeletplugin.health import (DraHealthWatcher,
                                                     device_node_probe)
from vtpu_manager_torch.kubeletplugin.readiness import (Readiness,
                                                        ReadinessServer)
from vtpu_manager_torch.kubeletplugin.registration import (
    RegistrationServer, publish_resource_slice)
from vtpu_manager_torch.resilience.policy import (CircuitBreaker,
                                                  KubeResilience, RetryPolicy)
from vtpu_manager_torch.util import consts

GIB = 2**30
MIB = 2**20
DRIVER = consts.DRA_DRIVER_NAME


def fake_chip(index, **kw):
    """The JAX tests' fake chip (device/types.py fake_chip), as the port's
    ChipSpec."""
    kw.setdefault("memory", 16 * GIB)
    kw.setdefault("split_count", 10)
    return ChipSpec(uuid=f"TPU-FAKE-{index:04d}", index=index,
                    chip_type="tpu-v5e", coords=(index, 0, 0), **kw)


def jax_chips(chips):
    return [JaxChipSpec.from_wire(c.to_wire()) for c in chips]


def allocated_claim(uid="claim-1", device="vtpu-0", cores=50,
                    memory_mib=2048, name="c1", namespace="ml"):
    return {
        "metadata": {"uid": uid, "name": name, "namespace": namespace},
        "status": {"allocation": {"devices": {
            "results": [{"request": "tpu", "driver": DRIVER,
                         "pool": "node-1", "device": device}],
            "config": [{"requests": ["tpu"], "opaque": {
                "driver": DRIVER,
                "parameters": {"cores": cores, "memoryMiB": memory_mib}}}],
        }}},
    }


def multi_request_claim(uid="claim-m", train_device="vtpu-0",
                        eval_device="vtpu-1", train_mem=4096,
                        eval_mem=2048):
    return {
        "metadata": {"uid": uid, "name": "cm", "namespace": "ml"},
        "status": {"allocation": {"devices": {
            "results": [
                {"request": "train", "driver": DRIVER, "pool": "node-1",
                 "device": train_device},
                {"request": "eval", "driver": DRIVER, "pool": "node-1",
                 "device": eval_device},
            ],
            "config": [
                {"requests": ["train"], "opaque": {
                    "driver": DRIVER,
                    "parameters": {"cores": 60, "memoryMiB": train_mem}}},
                {"requests": ["eval"], "opaque": {
                    "driver": DRIVER,
                    "parameters": {"cores": 30, "memoryMiB": eval_mem}}},
            ],
        }}},
    }


def two_slot_claim(uid="claim-1"):
    """Two slots of chip 0 and no opaque config: slot capacities merged."""
    claim = allocated_claim(uid=uid, name=uid)
    claim["status"]["allocation"]["devices"]["results"] = [
        {"request": "tpu", "driver": DRIVER, "pool": "node-1",
         "device": "vtpu-0-0"},
        {"request": "tpu", "driver": DRIVER, "pool": "node-1",
         "device": "vtpu-0-1"}]
    claim["status"]["allocation"]["devices"]["config"] = []
    return claim


CLAIMS = {
    "single": allocated_claim,
    "whole_chip": lambda: allocated_claim(uid="claim-w", name="cw",
                                          device="vtpu-1", cores=100,
                                          memory_mib=16384),
    "two_slots": lambda: two_slot_claim("claim-2"),
    "multi_request": multi_request_claim,
    "prioritized_subrequest": lambda: _subrequest_claim(),
}


def _subrequest_claim():
    claim = allocated_claim(uid="claim-s", device="vtpu-1-3", cores=10,
                            memory_mib=1024)
    claim["status"]["allocation"]["devices"]["results"][0]["request"] = \
        "tpu/small"
    return claim


MINORS = {0: 0, 1: 1}


@pytest.fixture
def state(tmp_path):
    return DeviceState("node-1", [fake_chip(0), fake_chip(1)],
                       base_dir=str(tmp_path / "mgr"),
                       cdi_dir=str(tmp_path / "cdi"), minors=MINORS)


def spec_of(state, uid):
    with open(cdi.spec_path(uid, state.cdi_dir)) as f:
        return json.load(f)


# --- checkpoint ------------------------------------------------------------


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        path = str(tmp_path / "ck.json")
        ck = Checkpoint(path)
        ck.claims["u1"] = PreparedClaim("u1", "ns", "c",
                                        devices=[{"device": "vtpu-0"}],
                                        cdi_devices=["google.com/vtpu=u1"])
        ck.save()
        ck2 = Checkpoint(path)
        ck2.load()
        assert ck2.claims["u1"].devices[0]["device"] == "vtpu-0"

    def test_checksum_detects_corruption(self, tmp_path):
        path = str(tmp_path / "ck.json")
        ck = Checkpoint(path)
        ck.claims["u1"] = PreparedClaim("u1", "ns", "c")
        ck.save()
        doc = json.load(open(path))
        doc["data"]["claims"]["u1"]["name"] = "tampered"
        json.dump(doc, open(path, "w"))
        with pytest.raises(ValueError, match="checksum"):
            Checkpoint(path).load()

    def test_v1_migration(self, tmp_path):
        path = str(tmp_path / "ck.json")
        payload = {"version": 1, "claims": {"u1": [{"device": "vtpu-0"}]}}
        json.dump({"data": payload}, open(path, "w"))
        ck = Checkpoint(path)
        ck.load()
        assert ck.claims["u1"].devices == [{"device": "vtpu-0"}]
        assert (ck.claims["u1"].namespace, ck.claims["u1"].cdi_devices) == \
            ("", [])

    def test_unknown_version_refused(self, tmp_path):
        path = str(tmp_path / "ck.json")
        json.dump({"data": {"version": 7, "claims": {}}}, open(path, "w"))
        with pytest.raises(ValueError, match="unsupported"):
            Checkpoint(path).load()

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_each_package_reads_the_others_file(self, tmp_path, writer):
        devices = [{"device": "vtpu-0-1", "uuid": "GPU-1", "hostIndex": 0,
                    "cores": 25, "memory": 8 * GIB, "request": "train",
                    "cdi": "google.com/vtpu=u1-train"}]
        path = str(tmp_path / "ck.json")
        mod = {"port": (Checkpoint, PreparedClaim),
               "jax": (jckpt.Checkpoint, jckpt.PreparedClaim)}
        w_ck, w_claim = mod[writer]
        r_ck, _ = mod["jax" if writer == "port" else "port"]
        ck = w_ck(path)
        ck.claims["u1"] = w_claim("u1", "ml", "c1", devices=devices,
                                  cdi_devices=["google.com/vtpu=u1-train"])
        ck.save()
        back = r_ck(path)
        back.load()
        assert back.claims["u1"].to_doc() == ck.claims["u1"].to_doc()


# --- DeviceState -------------------------------------------------------------


class TestDeviceState:
    def test_prepare_writes_partition_and_cdi(self, state):
        assert state.prepare_claim(allocated_claim()) == \
            ["google.com/vtpu=claim-1"]
        edits = spec_of(state, "claim-1")["devices"][0]["containerEdits"]
        env = dict(e.split("=", 1) for e in edits["env"])
        assert env["VTPU_CORE_LIMIT_0"] == "50"
        assert env[consts.ENV_NVIDIA_VISIBLE_DEVICES] == "TPU-FAKE-0000"
        assert env[consts.ENV_POD_UID] == "claim-1"
        assert env[consts.ENV_CONTAINER_NAME] == "dra-claim"
        assert [d["path"] for d in edits["deviceNodes"]] == \
            ["/dev/nvidia0", "/dev/nvidiactl", "/dev/nvidia-uvm"]
        cfg = vc.read_config(os.path.join(
            state.base_dir, "claim_claim-1", "config", "vtpu.config"))
        assert (cfg.pod_uid, cfg.container_name) == ("claim-1", "dra-claim")
        assert cfg.devices[0].hard_core == 50
        assert cfg.devices[0].total_memory == 2048 * MIB

    def test_device_node_minor_comes_from_discovery(self, tmp_path):
        """NVML's minor, never the host index."""
        st = DeviceState("node-1", [fake_chip(0), fake_chip(1)],
                         base_dir=str(tmp_path / "mgr"),
                         cdi_dir=str(tmp_path / "cdi"), minors={0: 6, 1: 2})
        st.prepare_claim(allocated_claim(device="vtpu-1"))
        edits = spec_of(st, "claim-1")["devices"][0]["containerEdits"]
        assert edits["deviceNodes"][0]["path"] == "/dev/nvidia2"

    def test_device_without_minor_fails_and_writes_nothing(self, tmp_path):
        st = DeviceState("node-1", [fake_chip(0)],
                         base_dir=str(tmp_path / "mgr"),
                         cdi_dir=str(tmp_path / "cdi"))
        with pytest.raises(PrepareError, match="no device-node minor"):
            st.prepare_claim(allocated_claim())
        assert not os.path.exists(os.path.join(st.base_dir, "claim_claim-1"))
        assert not os.path.exists(cdi.spec_path("claim-1", st.cdi_dir))
        assert st.prepared_uids() == set()

    def test_mounts_name_the_callers_node_dirs(self, tmp_path):
        st = DeviceState("node-1", [fake_chip(0)],
                         base_dir=str(tmp_path / "mgr"),
                         cdi_dir=str(tmp_path / "cdi"), minors=MINORS,
                         shim_host_dir=str(tmp_path / "driver"),
                         lock_dir=str(tmp_path / "locks"),
                         vmem_dir=str(tmp_path / "vmem"),
                         watcher_dir=str(tmp_path / "watcher"),
                         real_libcuda_path="/usr/lib/libcuda.so.1")
        st.prepare_claim(allocated_claim())
        edits = spec_of(st, "claim-1")["devices"][0]["containerEdits"]
        mounts = {m["containerPath"]: m for m in edits["mounts"]}
        assert {p: mounts[p]["hostPath"] for p in (
            consts.DRIVER_DIR, consts.LOCK_DIR, consts.VMEM_DIR,
            consts.WATCHER_DIR, consts.LD_SO_PRELOAD)} == {
            consts.DRIVER_DIR: str(tmp_path / "driver"),
            consts.LOCK_DIR: str(tmp_path / "locks"),
            consts.VMEM_DIR: str(tmp_path / "vmem"),
            consts.WATCHER_DIR: str(tmp_path / "watcher"),
            consts.LD_SO_PRELOAD: str(tmp_path / "mgr" / "ld.so.preload")}
        assert mounts[consts.LD_SO_PRELOAD]["options"][0] == "ro"
        with open(tmp_path / "mgr" / "ld.so.preload") as f:
            assert f.read() == interposer_container_path() + "\n"
        assert "VTPU_REAL_CUDA_LIBRARY_PATH=/usr/lib/libcuda.so.1" in \
            edits["env"]

    def test_client_mode_mounts_the_callers_registry_dir(self, tmp_path):
        st = DeviceState("node-1", [fake_chip(0)],
                         base_dir=str(tmp_path / "mgr"),
                         cdi_dir=str(tmp_path / "cdi"), minors=MINORS,
                         node_config=NodeConfig(compat_mode="client"),
                         registry_dir=str(tmp_path / "registry"))
        st.prepare_claim(allocated_claim())
        edits = spec_of(st, "claim-1")["devices"][0]["containerEdits"]
        mounts = {m["containerPath"]: m for m in edits["mounts"]}
        assert mounts[consts.REGISTRY_DIR]["hostPath"] == \
            str(tmp_path / "registry")
        assert mounts[consts.REGISTRY_DIR]["options"][0] == "rw"

    def test_prepare_idempotent(self, state):
        assert state.prepare_claim(allocated_claim()) == \
            state.prepare_claim(allocated_claim())

    def test_unknown_device_rejected(self, state):
        with pytest.raises(PrepareError, match="not on node"):
            state.prepare_claim(allocated_claim(device="vtpu-99"))

    def test_claim_without_our_results_rejected(self, state):
        claim = allocated_claim()
        claim["status"]["allocation"]["devices"]["results"][0]["driver"] = \
            "gpu.example.com"
        with pytest.raises(PrepareError, match="no allocation"):
            state.prepare_claim(claim)

    def test_unprepare_cleans_up(self, state):
        state.prepare_claim(allocated_claim())
        state.unprepare_claim("claim-1")
        assert not os.path.exists(cdi.spec_path("claim-1", state.cdi_dir))
        assert not os.path.exists(os.path.join(state.base_dir,
                                               "claim_claim-1"))
        assert state.prepared_uids() == set()
        state.unprepare_claim("claim-1")   # idempotent

    def test_fractional_slots_merge_on_one_chip(self, state):
        state.prepare_claim(two_slot_claim())
        cfg = vc.read_config(os.path.join(
            state.base_dir, "claim_claim-1", "config", "vtpu.config"))
        assert len(cfg.devices) == 1
        assert cfg.devices[0].hard_core == 20
        assert cfg.devices[0].total_memory == 2 * (16 * GIB // 10)
        edits = spec_of(state, "claim-1")["devices"][0]["containerEdits"]
        assert "VTPU_CORE_LIMIT_0=20" in edits["env"]
        assert len(edits["deviceNodes"]) == 3      # one card, two controls

    def test_opaque_config_beyond_slot_denied(self, state):
        with pytest.raises(PrepareError, match="exceeds allocated"):
            state.prepare_claim(allocated_claim(device="vtpu-0-3", cores=50))

    def test_multi_request_claim_gets_per_request_cdi_devices(self, state):
        assert state.prepare_claim(multi_request_claim()) == \
            ["google.com/vtpu=claim-m-eval", "google.com/vtpu=claim-m-train"]
        by_name = {d["name"]: d["containerEdits"]
                   for d in spec_of(state, "claim-m")["devices"]}
        train, evalc = by_name["claim-m-train"], by_name["claim-m-eval"]
        assert "VTPU_CORE_LIMIT_0=60" in train["env"]
        assert "VTPU_CORE_LIMIT_0=30" in evalc["env"]
        assert "VTPU_CONTAINER_NAME=dra-train" in train["env"]
        assert "VTPU_CONTAINER_NAME=dra-eval" in evalc["env"]
        assert "VTPU_CLAIM_REQUEST=train" in train["env"]
        assert [d["path"] for d in train["deviceNodes"]][0] == "/dev/nvidia0"
        assert [d["path"] for d in evalc["deviceNodes"]][0] == "/dev/nvidia1"
        t_cfg = vc.read_config(os.path.join(
            state.base_dir, "claim_claim-m", "config_train", "vtpu.config"))
        e_cfg = vc.read_config(os.path.join(
            state.base_dir, "claim_claim-m", "config_eval", "vtpu.config"))
        assert (t_cfg.container_name, t_cfg.devices[0].hard_core,
                t_cfg.devices[0].host_index) == ("dra-train", 60, 0)
        assert (e_cfg.container_name, e_cfg.devices[0].hard_core,
                e_cfg.devices[0].host_index) == ("dra-eval", 30, 1)

    def test_multi_request_cross_request_overcommit_denied(self, state):
        claim = multi_request_claim(train_device="vtpu-0",
                                    eval_device="vtpu-0", train_mem=10240,
                                    eval_mem=8192)
        with pytest.raises(PrepareError, match="together"):
            state.prepare_claim(claim)
        assert not os.path.exists(os.path.join(state.base_dir,
                                               "claim_claim-m"))

    def test_multi_request_unprepare_cleans_all_configs(self, state):
        state.prepare_claim(multi_request_claim())
        state.unprepare_claim("claim-m")
        assert not os.path.exists(os.path.join(state.base_dir,
                                               "claim_claim-m"))
        assert not os.path.exists(cdi.spec_path("claim-m", state.cdi_dir))

    @pytest.mark.parametrize("content", [
        '{"checksum": 1, "data": {"version": 2, "claims": {}}}',
        '{"checksum": 1, "data": {"version": 2,'])
    def test_corrupt_checkpoint_quarantined(self, tmp_path, content):
        base = tmp_path / "mgr2"
        base.mkdir()
        ck_path = str(base / "dra_checkpoint.json")
        with open(ck_path, "w") as f:
            f.write(content)
        st = DeviceState("node-1", [fake_chip(0)], base_dir=str(base),
                         cdi_dir=str(tmp_path / "cdi2"))
        assert st.prepared_uids() == set()
        assert os.path.exists(ck_path + ".corrupt")

    def test_claim_uid_env_injected(self, state):
        state.prepare_claim(allocated_claim())
        env = spec_of(state, "claim-1")["devices"][0]["containerEdits"]["env"]
        assert "VTPU_CLAIM_UID=claim-1" in env
        assert f"{consts.ENV_REGISTER_UUID}=claim-1" in env

    def test_checkpoint_survives_restart(self, state, tmp_path):
        state.prepare_claim(allocated_claim())
        again = DeviceState("node-1", [fake_chip(0), fake_chip(1)],
                            base_dir=str(tmp_path / "mgr"),
                            cdi_dir=str(tmp_path / "cdi"), minors=MINORS)
        assert again.prepared_uids() == {"claim-1"}


# --- the driver: messages, gRPC, claim source --------------------------------


def prepare(driver, *refs):
    return driver.node_prepare(api.NodePrepareResourcesRequest(
        [api.Claim(*r) for r in refs]))


class TestDriver:
    def test_multi_request_prepare_response_maps_requests(self, state):
        source = ClaimSource()
        source.local["claim-m"] = multi_request_claim()
        driver = DraDriver("node-1", source, state)
        entry = prepare(driver, ("claim-m", "cm", "ml")).claims["claim-m"]
        assert not entry.error
        by_request = {tuple(d.requests): d.cdi_device_ids
                      for d in entry.devices}
        assert by_request == {("train",): ["google.com/vtpu=claim-m-train"],
                              ("eval",): ["google.com/vtpu=claim-m-eval"]}

    def test_single_request_response_keeps_claim_level_device(self, state):
        source = ClaimSource()
        source.local["claim-1"] = allocated_claim()
        driver = DraDriver("node-1", source, state)
        entry = prepare(driver, ("claim-1", "c1", "ml")).claims["claim-1"]
        assert not entry.error
        assert [(d.requests, d.pool_name, d.device_name, d.cdi_device_ids)
                for d in entry.devices] == [
            ([], "node-1", "vtpu-0", ["google.com/vtpu=claim-1"])]

    def test_one_bad_claim_fails_only_its_entry(self, state):
        source = ClaimSource()
        source.local["good"] = allocated_claim(uid="good")
        source.local["bad"] = allocated_claim(uid="bad", device="vtpu-0-3",
                                              cores=50)
        driver = DraDriver("node-1", source, state)
        resp = prepare(driver, ("bad", "b", "ml"), ("good", "g", "ml"),
                       ("gone", "x", "ml"))
        assert "exceeds allocated" in resp.claims["bad"].error
        assert not resp.claims["good"].error
        assert "not found" in resp.claims["gone"].error
        assert state.prepared_uids() == {"good"}

    def test_recreated_claim_with_another_uid_is_not_found(self):
        client = FakeKubeClient()
        client.add_resourceclaim(allocated_claim(uid="new-uid"))
        assert ClaimSource(client).get("old-uid", "c1", "ml") is None
        assert ClaimSource(client).get("new-uid", "c1", "ml")["metadata"][
            "uid"] == "new-uid"

    def test_prepare_unprepare_over_socket(self, state, tmp_path):
        from vtpu_manager_torch.kubeletplugin.api import dra_pb2 as pb
        source = ClaimSource()
        source.local["claim-1"] = allocated_claim()
        driver = DraDriver("node-1", source, state,
                           plugin_dir=str(tmp_path / "sock"))
        driver.serve()
        try:
            with grpc.insecure_channel(
                    f"unix://{driver.socket_path}") as chan:
                prep = chan.unary_unary(
                    "/v1beta1dra.DRAPlugin/NodePrepareResources",
                    request_serializer=
                    pb.NodePrepareResourcesRequest.SerializeToString,
                    response_deserializer=
                    pb.NodePrepareResourcesResponse.FromString)
                resp = prep(pb.NodePrepareResourcesRequest(claims=[
                    pb.Claim(uid="claim-1", name="c1", namespace="ml")]),
                    timeout=5)
                entry = resp.claims["claim-1"]
                assert not entry.error
                assert list(entry.devices[0].cdi_device_ids) == \
                    ["google.com/vtpu=claim-1"]
                assert entry.devices[0].pool_name == "node-1"
                missing = prep(pb.NodePrepareResourcesRequest(claims=[
                    pb.Claim(uid="nope", name="x", namespace="ml")]),
                    timeout=5)
                assert "not found" in missing.claims["nope"].error
                unprep = chan.unary_unary(
                    "/v1beta1dra.DRAPlugin/NodeUnprepareResources",
                    request_serializer=
                    pb.NodeUnprepareResourcesRequest.SerializeToString,
                    response_deserializer=
                    pb.NodeUnprepareResourcesResponse.FromString)
                uresp = unprep(pb.NodeUnprepareResourcesRequest(claims=[
                    pb.Claim(uid="claim-1")]), timeout=5)
                assert "claim-1" in uresp.claims
                assert not uresp.claims["claim-1"].error
        finally:
            driver.stop()
        assert state.prepared_uids() == set()

    @pytest.mark.parametrize("name", ["dra_pb2", "pluginregistration_pb2"])
    def test_generated_modules_are_the_jax_ones(self, name):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(root, "vtpu_manager", "kubeletplugin", "api",
                               f"{name}.py"), "rb") as f:
            theirs = f.read()
        with open(os.path.join(root, "vtpu_manager_torch", "kubeletplugin",
                               "api", f"{name}.py"), "rb") as f:
            assert f.read() == theirs


class TestClaimSourceResilience:
    class _FlakyClient:
        def __init__(self, steps):
            self.steps = list(steps)   # per call: an exception or a claim
            self.calls = 0

        def get_resourceclaim(self, namespace, name):
            self.calls += 1
            step = self.steps.pop(0)
            if isinstance(step, BaseException):
                raise step
            return step

    @staticmethod
    def _fast(threshold=2):
        return KubeResilience(
            policy=RetryPolicy(max_attempts=2, deadline_s=60.0,
                               rng=Random(1), sleep=lambda s: None),
            breaker=CircuitBreaker(name="dra.claims",
                                   failure_threshold=threshold))

    def test_transient_error_retries_then_succeeds(self):
        claim = allocated_claim()
        client = self._FlakyClient([KubeError(503, "blip"), claim])
        source = ClaimSource(client, resilience=self._fast())
        assert source.get("claim-1", "c1", "ml") is claim
        assert client.calls == 2
        assert source.resilience.breaker.state == "closed"

    def test_404_is_a_result_not_a_breaker_failure(self):
        client = self._FlakyClient([KubeError(404, "gone")] * 5)
        source = ClaimSource(client, resilience=self._fast())
        for _ in range(5):
            assert source.get("claim-1", "c1", "ml") is None
        assert source.resilience.breaker.state == "closed"

    def test_breaker_opens_and_rejects_locally(self):
        client = self._FlakyClient([KubeError(503, "down")] * 10)
        source = ClaimSource(client, resilience=self._fast(threshold=2))
        for _ in range(2):
            with pytest.raises(ClaimLookupError):
                source.get("claim-1", "c1", "ml")
        assert source.resilience.breaker.state == "open"
        calls_before = client.calls
        with pytest.raises(ClaimLookupError):
            source.get("claim-1", "c1", "ml")
        assert client.calls == calls_before

    def test_breaker_open_surfaces_transient_prepare_error(self, state):
        client = self._FlakyClient([KubeError(503, "down")] * 10)
        source = ClaimSource(client, resilience=self._fast(threshold=1))
        driver = DraDriver("node-1", source, state)
        for _ in range(2):
            error = prepare(driver, ("claim-1", "c1", "ml")).claims[
                "claim-1"].error
            assert "transient" in error and "not found" not in error
        assert source.resilience.breaker.state == "open"


@pytest.mark.parametrize("events", [
    "ffffff", "fffsfff", "ff", "fffwffs", "fffwfwfs", "fffwwfs"])
def test_circuit_breaker_moves_as_jax(events):
    """The same calls and clock through both breakers: the same state
    after each event (f failure, s success, w the reset timeout passes)."""
    now = [0.0]
    mine = CircuitBreaker(failure_threshold=3, reset_timeout_s=10,
                          clock=lambda: now[0])
    theirs = jpolicy.CircuitBreaker(failure_threshold=3, reset_timeout_s=10,
                                    clock=lambda: now[0])
    for event in events:
        if event == "w":
            now[0] += 10
        else:
            allowed = mine.allow()
            assert allowed == theirs.allow()
            if allowed:
                for b in (mine, theirs):
                    (b.record_failure if event == "f"
                     else b.record_success)()
        assert mine.state == theirs.state


class TestClaimOwnership:
    def test_claim_uids_for_pod_via_reserved_for(self, state):
        claim = allocated_claim()
        claim["status"]["reservedFor"] = [
            {"resource": "pods", "name": "p1", "uid": "pod-owner"}]
        source = ClaimSource()
        source.local["claim-1"] = claim
        state.prepare_claim(claim)
        driver = DraDriver("node-1", source, state)
        assert driver.claim_uids_for_pod("pod-owner") == ["claim-1"]
        assert driver.claim_uids_for_pod("pod-owner", "claim-1") == \
            ["claim-1"]
        assert driver.claim_uids_for_pod("pod-owner", "other") == []
        assert driver.claim_uids_for_pod("someone-else") == []


# --- claim resolution, ResourceSlice ------------------------------------------


class TestClaimResolve:
    def test_resolve_partitions(self):
        assert resolve_claim_partitions(allocated_claim()) == \
            [PartitionKey("vtpu-0", 50, 2048, request="tpu")]

    def test_pod_partitions(self):
        pod = {"metadata": {"namespace": "ml"},
               "spec": {"resourceClaims": [
                   {"name": "tpu", "resourceClaimName": "c1"}]},
               "status": {"resourceClaimStatuses": [
                   {"name": "gen", "resourceClaimName": "c1"}]}}
        claims = {("ml", "c1"): allocated_claim()}
        assert pod_partitions(pod, claims) == \
            [PartitionKey("vtpu-0", 50, 2048, request="tpu")]

    def test_foreign_driver_ignored(self):
        claim = allocated_claim()
        claim["status"]["allocation"]["devices"]["results"][0]["driver"] = \
            "gpu.example.com"
        assert resolve_claim_partitions(claim) == []

    @pytest.mark.parametrize("name", sorted(CLAIMS))
    def test_partitions_equal_jax(self, name):
        claim = CLAIMS[name]()
        assert [astuple(p) for p in resolve_claim_partitions(claim)] == \
            [astuple(p) for p in jresolve.resolve_claim_partitions(claim)]


class TestResourceSlice:
    def test_slice_shape(self):
        rs = build_resource_slice("node-1", [fake_chip(0), fake_chip(1)])
        assert rs["spec"]["driver"] == DRIVER
        devices = rs["spec"]["devices"]
        assert len(devices) == 2 * 10
        cap = devices[0]["basic"]["capacity"]
        assert cap["coreRatio"]["value"] == "10"
        assert cap["memoryMiB"]["value"] == str(16 * 1024 // 10)
        counters = rs["spec"]["sharedCounters"]
        assert counters[0]["name"] == "chip-0"
        assert counters[0]["counters"]["coreRatio"]["value"] == "100"

    @pytest.mark.parametrize("split,healthy", [(4, True), (10, False),
                                               (1, True)])
    def test_slice_equals_jax(self, split, healthy):
        from vtpu_manager_torch.tpu.discovery import FakeBackend
        chips = [ChipSpec(**{**vars(c), "split_count": split,
                             "healthy": healthy if c.index else True})
                 for c in FakeBackend(2).discover().chips]
        assert build_resource_slice("n1", chips, 3) == \
            jalloc.build_resource_slice("n1", jax_chips(chips), 3)

    def test_published_through_the_fake_client(self):
        client = FakeKubeClient()
        rs = build_resource_slice("n1", [fake_chip(0)])
        assert publish_resource_slice(client, rs)
        assert client.resourceslices["n1-vtpu"] == rs
        assert not publish_resource_slice(object(), rs)


# --- side by side with the JAX plugin ------------------------------------------

JAX_ONLY_ENV = {jc.ENV_TPU_VISIBLE_DEVICES, jc.ENV_TPU_LIBRARY_PATH,
                jc.ENV_PJRT_PLUGIN_LIBRARY_PATH, jc.ENV_VTPU_REAL_PLUGIN_PATH}
PORT_ONLY_ENV = {consts.ENV_NVIDIA_VISIBLE_DEVICES,
                 consts.ENV_REAL_CUDA_LIBRARY_PATH, consts.ENV_POD_UID,
                 consts.ENV_CONTAINER_NAME}


def _both(tmp_path, chips=None):
    chips = chips or [fake_chip(0), fake_chip(1)]
    mine = DeviceState("node-1", chips, base_dir=str(tmp_path / "port"),
                       cdi_dir=str(tmp_path / "port-cdi"), minors=MINORS)
    theirs = JaxDeviceState("node-1", jax_chips(chips),
                            base_dir=str(tmp_path / "jax"),
                            cdi_dir=str(tmp_path / "jax-cdi"))
    return mine, theirs


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith((".lock", "ld.so.preload")):
                continue
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("name", sorted(CLAIMS))
def test_config_and_checkpoint_byte_identical_to_jax(tmp_path, name):
    mine, theirs = _both(tmp_path)
    assert mine.prepare_claim(CLAIMS[name]()) == \
        theirs.prepare_claim(CLAIMS[name]())
    mine_files, their_files = _files(mine.base_dir), _files(theirs.base_dir)
    assert sorted(mine_files) == sorted(their_files)
    assert "dra_checkpoint.json" in mine_files
    assert any(k.endswith("vtpu.config") for k in mine_files)
    for rel, data in mine_files.items():
        assert data == their_files[rel], rel
    # each loads the other's checkpoint
    for reader, path in ((Checkpoint, theirs.checkpoint.path),
                         (jckpt.Checkpoint, mine.checkpoint.path)):
        ck = reader(path)
        ck.load()
        assert {u: c.to_doc() for u, c in ck.claims.items()} == \
            {u: c.to_doc() for u, c in mine.checkpoint.claims.items()}


@pytest.mark.parametrize("name", sorted(CLAIMS))
def test_cdi_spec_differs_from_jax_only_by_cuda_and_identity(tmp_path, name):
    mine, theirs = _both(tmp_path)
    claim = CLAIMS[name]()
    uid = claim["metadata"]["uid"]
    mine.prepare_claim(claim)
    theirs.prepare_claim(claim)
    with open(cdi.spec_path(uid, mine.cdi_dir)) as f:
        m_spec = json.load(f)
    with open(jcdi.spec_path(uid, theirs.cdi_dir)) as f:
        t_spec = json.load(f)
    assert os.path.basename(cdi.spec_path(uid)) == \
        os.path.basename(jcdi.spec_path(uid))
    assert (m_spec["cdiVersion"], m_spec["kind"]) == \
        (t_spec["cdiVersion"], t_spec["kind"])
    assert [d["name"] for d in m_spec["devices"]] == \
        [d["name"] for d in t_spec["devices"]]
    for m_dev, t_dev in zip(m_spec["devices"], t_spec["devices"]):
        m_ed, t_ed = m_dev["containerEdits"], t_dev["containerEdits"]
        m_env = dict(e.split("=", 1) for e in m_ed["env"])
        t_env = dict(e.split("=", 1) for e in t_ed["env"])
        shared = set(m_env) & set(t_env)
        assert {k: m_env[k] for k in shared} == {k: t_env[k] for k in shared}
        assert set(t_env) - shared == JAX_ONLY_ENV
        assert set(m_env) - shared == PORT_ONLY_ENV
        cfg = vc.read_config(os.path.join(
            m_ed["mounts"][0]["hostPath"], "vtpu.config"))
        assert (m_env[consts.ENV_POD_UID],
                m_env[consts.ENV_CONTAINER_NAME]) == \
            (cfg.pod_uid, cfg.container_name)
        assert m_env[consts.ENV_NVIDIA_VISIBLE_DEVICES] == ",".join(
            d.uuid for d in cfg.devices)
        # device nodes: the cards by NVML minor, then the control nodes
        indices = [int(i) for i in t_env[jc.ENV_TPU_VISIBLE_DEVICES].split(",")]
        assert [n["path"] for n in t_ed["deviceNodes"]] == \
            [f"/dev/accel{i}" for i in indices]
        assert [n["path"] for n in m_ed["deviceNodes"]] == \
            [f"/dev/nvidia{MINORS[i]}" for i in indices] + \
            ["/dev/nvidiactl", "/dev/nvidia-uvm"]
        # mounts: the JAX ones (the node's default dirs) and the preload file
        rel = [{**m, "hostPath": os.path.relpath(m["hostPath"], tmp_path)
                if m["hostPath"].startswith(str(tmp_path)) else m["hostPath"]}
               for m in m_ed["mounts"]]
        t_rel = [{**m, "hostPath": os.path.relpath(m["hostPath"], tmp_path)
                  if m["hostPath"].startswith(str(tmp_path))
                  else m["hostPath"]} for m in t_ed["mounts"]]
        t_rel[0]["hostPath"] = t_rel[0]["hostPath"].replace("jax", "port", 1)
        assert rel == t_rel + [{"hostPath": "port/ld.so.preload",
                                "containerPath": consts.LD_SO_PRELOAD,
                                "options": ["ro", "rbind"]}]


def _normal(resp_claims):
    return {uid: (e.error, [(tuple(d.requests), d.pool_name, d.device_name,
                             tuple(d.cdi_device_ids)) for d in e.devices])
            for uid, e in resp_claims.items()}


def test_node_prepare_responses_equal_jax(tmp_path):
    mine, theirs = _both(tmp_path)
    claims = [CLAIMS[n]() for n in sorted(CLAIMS)]
    claims.append(allocated_claim(uid="over", name="over",
                                  device="vtpu-0-3", cores=50))
    m_src, t_src = ClaimSource(), JaxClaimSource()
    for claim in claims:
        # prepared one by one in both: claims share chip 0's slots
        m_src.local[claim["metadata"]["uid"]] = claim
        t_src.local[claim["metadata"]["uid"]] = claim
    refs = [(c["metadata"]["uid"], c["metadata"]["name"], "ml")
            for c in claims] + [("nope", "x", "ml")]
    m_drv = DraDriver("node-1", m_src, mine)
    t_drv = JaxDraDriver("node-1", [], t_src, state=theirs)
    m_resp = prepare(m_drv, *refs)
    t_resp = t_drv.node_prepare(jpb.NodePrepareResourcesRequest(claims=[
        jpb.Claim(uid=u, name=n, namespace=ns) for u, n, ns in refs]))
    assert _normal(m_resp.claims) == _normal(t_resp.claims)
    assert sum(1 for e in m_resp.claims.values() if not e.error) >= 4
    m_un = m_drv.node_unprepare(api.NodeUnprepareResourcesRequest(
        [api.Claim(u) for u, _, _ in refs]))
    t_un = t_drv.node_unprepare(jpb.NodeUnprepareResourcesRequest(claims=[
        jpb.Claim(uid=u) for u, _, _ in refs]))
    assert {u: e.error for u, e in m_un.claims.items()} == \
        {u: e.error for u, e in t_un.claims.items()}
    assert mine.prepared_uids() == theirs.prepared_uids() == set()


# --- health, readiness, registration -----------------------------------------


class TestDraHealth:
    def test_flip_republishes_slice(self):
        chips = [fake_chip(0), fake_chip(1)]
        published = []
        bad: set[str] = set()
        watcher = DraHealthWatcher(
            chips, probe=lambda c: c.uuid not in bad,
            on_change=lambda cs: published.append(
                build_resource_slice("node-1", cs)))
        assert watcher.check_once() == []
        assert published == []
        bad.add(chips[0].uuid)
        for _ in range(watcher._watcher.flip_after - 1):
            assert watcher.check_once() == []
        assert published == []
        assert [c.uuid for c in watcher.check_once()] == [chips[0].uuid]
        health = [d["basic"]["attributes"]["healthy"]["bool"]
                  for d in published[-1]["spec"]["devices"]]
        assert health.count(False) == 10 and health.count(True) == 10
        bad.clear()
        watcher.check_once()
        assert all(d["basic"]["attributes"]["healthy"]["bool"]
                   for d in published[-1]["spec"]["devices"])

    def test_probe_exception_is_unhealthy(self):
        chips = [fake_chip(0)]
        seen = []
        watcher = DraHealthWatcher(
            chips, probe=lambda c: (_ for _ in ()).throw(OSError("io")),
            on_change=seen.append)
        for _ in range(watcher._watcher.flip_after):
            watcher.check_once()
        assert not chips[0].healthy and seen

    def test_failed_republish_retried_next_poll(self):
        chips = [fake_chip(0)]
        calls = []

        def flaky_publish(cs):
            calls.append(len(cs))
            return len(calls) > 1

        watcher = DraHealthWatcher(chips, probe=lambda c: False,
                                   on_change=flaky_publish)
        for _ in range(watcher._watcher.flip_after - 1):
            watcher.check_once()
        assert calls == []
        watcher.check_once()
        assert calls == [1] and watcher._dirty
        watcher.check_once()
        assert calls == [1, 1] and not watcher._dirty
        watcher.check_once()
        assert calls == [1, 1]

    def test_default_probe_reads_the_nvidia_device_node(self):
        chip = fake_chip(0)
        assert device_node_probe({0: 4095})(chip) is False
        with pytest.raises(KeyError):
            device_node_probe({})(chip)


def test_readyz_flips_on_component_failure():
    r = Readiness()
    r.set("driver", True)
    srv = ReadinessServer(r, port=0)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/readyz") as resp:
            assert resp.status == 200
        r.set("registration", False, "registration socket: EACCES")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url + "/readyz")
        assert err.value.code == 503
        assert "registration" in json.loads(err.value.read())["components"]
        with urllib.request.urlopen(url + "/healthz") as resp:
            assert resp.status == 200
        r.set("registration", True)
        with urllib.request.urlopen(url + "/readyz") as resp:
            assert resp.status == 200
    finally:
        srv.stop()


@pytest.fixture
def short_dir():
    """A directory with a short path: a unix socket's path has at most 107
    bytes, and the registration socket's name alone takes 33."""
    path = tempfile.mkdtemp(prefix="reg-")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def test_registration_socket_answers_kubelet(short_dir):
    from vtpu_manager_torch.kubeletplugin.api import \
        pluginregistration_pb2 as pb
    reg = RegistrationServer("/plugins/dra.sock", registry_dir=short_dir)
    reg.serve()
    try:
        assert os.path.basename(reg.socket_path) == f"{DRIVER}-reg.sock"
        with grpc.insecure_channel(f"unix://{reg.socket_path}") as chan:
            info = chan.unary_unary(
                "/pluginregistration.Registration/GetInfo",
                request_serializer=pb.InfoRequest.SerializeToString,
                response_deserializer=pb.PluginInfo.FromString)(
                    pb.InfoRequest(), timeout=5)
            assert (info.type, info.name, info.endpoint,
                    list(info.supported_versions)) == (
                "DRAPlugin", DRIVER, "/plugins/dra.sock", ["v1beta1"])
            chan.unary_unary(
                "/pluginregistration.Registration/NotifyRegistrationStatus",
                request_serializer=pb.RegistrationStatus.SerializeToString,
                response_deserializer=
                pb.RegistrationStatusResponse.FromString)(
                    pb.RegistrationStatus(plugin_registered=False,
                                          error="version"), timeout=5)
        assert reg.last_status == (False, "version")
    finally:
        reg.stop()
    assert not os.path.exists(reg.socket_path)


def test_fake_client_resourceclaims():
    client = FakeKubeClient()
    client.add_resourceclaim(allocated_claim())
    got = client.get_resourceclaim("ml", "c1")
    got["metadata"]["uid"] = "changed"            # a copy
    assert client.get_resourceclaim("ml", "c1")["metadata"]["uid"] == \
        "claim-1"
    with pytest.raises(KubeError) as err:
        client.get_resourceclaim("ml", "missing")
    assert err.value.status == 404


# --- the tenant identity, on the fake driver ----------------------------------


def _cdi_harness_env(tmp_path, identity=True):
    """The environment of one claim's CDI device (25 % / 2 GiB on a fake
    H100 split 4) as the container runtime gives it, with the fake driver
    behind the interposer the spec's preload file names."""
    from vtpu_manager_torch.tpu.discovery import FakeBackend
    result = FakeBackend(1).discover()
    chips = [ChipSpec(**{**vars(c), "split_count": 4})
             for c in result.chips]
    node = {"shim_host_dir": str(tmp_path / "driver"),
            "lock_dir": str(tmp_path / "locks"),
            "vmem_dir": str(tmp_path / "vmem"),
            "watcher_dir": str(tmp_path / "watcher")}
    install_interposer(str(build.build_shim()), node["shim_host_dir"])
    VmemLedger(str(tmp_path / "vmem" / "vmem_node.config"),
               create=True).close()
    st = DeviceState("n1", chips, base_dir=str(tmp_path / "dra"),
                     cdi_dir=str(tmp_path / "cdi"), minors=result.minors,
                     **node)
    claim = bench_dra.allocated_claim("c1", 0, {"gpu": [1]}, 25, 2048)
    st.prepare_claim(claim)
    (device,) = bench_dra.read_spec(str(tmp_path / "cdi"), "uid-c1").values()
    env = bench_dra.cdi_env(device)
    if not identity:
        env = bench_dra.without_identity(env)
    env = {k: v for k, v in env.items()
           if not k.startswith(("FAKE_", "SHIM_"))}
    env.update({"SHIM_PATH": env["LD_PRELOAD"],
                "VTPU_REAL_CUDA_LIBRARY_PATH": str(build.build_fake_driver())})
    return env


def _alloc(env, nbytes, hold_file=None):
    env = dict(env, SHIM_TEST_ALLOCS=str(nbytes))
    if hold_file:
        env["SHIM_TEST_HOLD_FILE"] = hold_file
    return subprocess.Popen([str(build.build_shim_test()), "--alloc"],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("identity", [True, False],
                         ids=["port_env", "jax_env"])
def test_processes_of_one_claim_share_its_cap(tmp_path, identity):
    """Two processes of one claim's CDI device, a 2 GiB cap: the first
    holds 1.5 GiB, the second asks 1 GiB. With the port's environment
    they are one tenant and the second is refused; with the environment
    the JAX package writes (no VTPU_POD_UID / VTPU_CONTAINER_NAME), each
    process is a tenant of its own and the second is granted."""
    env = _cdi_harness_env(tmp_path, identity)
    assert (consts.ENV_POD_UID in env) == identity
    release = str(tmp_path / "release")
    first = _alloc(env, 3 * GIB // 2, release)
    try:
        verdicts = []
        for line in first.stdout:
            if line.startswith("VERDICT"):
                verdicts.append(int(line.split()[2]))
            if line.startswith("HELD"):
                break
        assert verdicts == [0], first.stderr.read()
        second = _alloc(env, GIB)
        out, err = second.communicate(timeout=60)
        assert second.returncode == 0, out + err
        got = bench_quota.parse_harness(out)["verdicts"]
        assert got == {"alloc0": 2 if identity else 0}, out + err
    finally:
        open(release, "w").close()
        first.communicate(timeout=30)
