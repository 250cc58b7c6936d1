"""The port's claims, registry, names, node config, retries and gates,
against the JAX package's on the same inputs.

The scheduler (JAX package) and the port's device plugin exchange claims
and the node registry as annotation strings: each side must write what
the other reads, and the names must be the same strings.
"""

import json
import sys

import pytest

from vtpu_manager.client.kube import KubeError as JaxKubeError
from vtpu_manager.config import node_config as jnc
from vtpu_manager.device import claims as jcl
from vtpu_manager.device import types as jty
from vtpu_manager.resilience import policy as jpol
from vtpu_manager.util import consts as jc
from vtpu_manager.util import featuregates as jfg
from vtpu_manager_torch.client.kube import KubeError
from vtpu_manager_torch.config import node_config as tnc
from vtpu_manager_torch.device import claims as tcl
from vtpu_manager_torch.device import types as tty
from vtpu_manager_torch.resilience import policy as tpol
from vtpu_manager_torch.tpu.discovery import FakeBackend
from vtpu_manager_torch.util import consts as tc
from vtpu_manager_torch.util import featuregates as tfg

GIB = 2**30

# (container, uuid, host_index, cores, memory) rows of one pod's claims
CLAIM_SETS = {
    "one": [("main", "GPU-aaaa", 0, 50, 16 * GIB)],
    "memory_0": [("main", "GPU-aaaa", 0, 25, 0)],
    "cores_0": [("main", "GPU-aaaa", 1, 0, 8 * GIB)],
    "two_devices": [("main", "GPU-aaaa", 0, 30, GIB),
                    ("main", "GPU-bbbb", 1, 70, 2 * GIB)],
    "two_containers": [("side", "GPU-bbbb", 1, 20, GIB),
                       ("main", "GPU-aaaa", 0, 10, 3 * GIB)],
}


def _claims(mod, rows):
    out = mod.PodDeviceClaims()
    for cont, uuid, index, cores, memory in rows:
        out.add(cont, mod.DeviceClaim(uuid, index, cores, memory))
    return out


def _rows(claims):
    return [(cont, c.uuid, c.host_index, c.cores, c.memory)
            for cont, cs in claims.containers.items() for c in cs]


@pytest.mark.parametrize("name", sorted(CLAIM_SETS))
def test_claims_encode_equal_and_decode_across(name):
    rows = CLAIM_SETS[name]
    port, jax = _claims(tcl, rows), _claims(jcl, rows)
    assert port.encode() == jax.encode()
    assert _rows(tcl.PodDeviceClaims.decode(jax.encode())) == rows
    assert _rows(jcl.PodDeviceClaims.decode(port.encode())) == rows
    assert _rows(tcl.try_decode(jax.encode())) == rows


@pytest.mark.parametrize("raw", ["", None, "v2:{}", "v1:[1]", "v1:{bad",
                                 'v1:{"c":[["u",0,1]]}'])
def test_try_decode_rejects_what_jax_rejects(raw):
    assert tcl.try_decode(raw) is None
    assert jcl.try_decode(raw) is None


def test_claims_copy_is_independent():
    shared = tcl.try_decode(_claims(tcl, CLAIM_SETS["one"]).encode())
    mine = shared.copy()
    mine.add("main", tcl.DeviceClaim("GPU-bbbb", 1, 1, 1))
    assert len(shared.container_claims("main")) == 1
    assert len(mine.all_claims()) == 2 and not mine.is_empty()


def _chips(mod, n, **kw):
    return [mod.ChipSpec(uuid=f"GPU-{i:04d}", index=i,
                         chip_type="nvidia-h100-sxm", memory=80 * GIB - i,
                         core_count=132, split_count=4, coords=(0, i, 0),
                         healthy=i != 1, **kw) for i in range(n)]


@pytest.mark.parametrize("n,domain", [(1, ""), (2, "nvl-domain-7"),
                                      (4, "")])
def test_registry_encode_equal_and_decode_across(n, domain):
    port = tty.NodeDeviceRegistry(chips=_chips(tty, n),
                                  mesh=tty.MeshSpec((1, n, 1)),
                                  mesh_domain=domain)
    jax = jty.NodeDeviceRegistry(chips=_chips(jty, n),
                                 mesh=jty.MeshSpec((1, n, 1)),
                                 mesh_domain=domain)
    assert port.encode() == jax.encode()
    back = jty.NodeDeviceRegistry.decode(port.encode())
    assert [c.to_wire() for c in back.chips] == \
        [c.to_wire() for c in port.chips]
    assert back.mesh_domain == domain and back.mesh.shape == (1, n, 1)
    mine = tty.NodeDeviceRegistry.decode(jax.encode())
    assert mine == port
    assert sorted(mine.chip_by_uuid()) == sorted(jax.chip_by_uuid())


def test_registry_rejects_unknown_encoding():
    with pytest.raises(ValueError):
        tty.NodeDeviceRegistry.decode("v9:{}")


ANNOTATIONS = ["pre_allocated_annotation", "predicate_node_annotation",
               "real_allocated_annotation", "allocation_status_annotation",
               "compute_policy_annotation", "memory_oversold_annotation",
               "node_device_register_annotation",
               "node_device_heartbeat_annotation", "vtpu_number_resource"]
NAMES = ["ENV_STEP_TELEMETRY", "ENV_STEP_RING_PATH", "TELEMETRY_SUBDIR",
         "STEP_RING_NAME", "DEVICES_JSON_NAME", "PIDS_CONFIG_NAME",
         "COMPAT_HOST", "COMPAT_CGROUP", "COMPAT_CLIENT",
         "COMPAT_OPEN_KERNEL", "ALLOC_STATUS_SUCCEED", "ALLOC_STATUS_FAILED",
         "COMPUTE_POLICY_FIXED", "COMPUTE_POLICY_BALANCE",
         "COMPUTE_POLICY_NONE", "ENV_POD_NAME", "ENV_POD_NAMESPACE",
         "ENV_POD_UID", "ENV_CONTAINER_NAME", "ENV_TRACE_ID",
         "ENV_VISIBLE_DEVICES", "ENV_COMPAT_MODE", "ENV_MEM_LIMIT",
         "ENV_CORE_LIMIT", "ENV_CORE_SOFT_LIMIT", "REGISTRY_DIR",
         "MANAGER_BASE_DIR", "DRIVER_DIR", "WATCHER_DIR", "LOCK_DIR",
         "VMEM_DIR"]


@pytest.mark.parametrize("name", ANNOTATIONS)
def test_annotation_keys_equal_jax(name):
    assert getattr(tc, name)() == getattr(jc, name)()


@pytest.mark.parametrize("name", NAMES)
def test_names_equal_jax(name):
    assert getattr(tc, name) == getattr(jc, name)


NODE_CONFIGS = {
    "default": {},
    "split": {"device_split_count": 4},
    "scaled": {"memory_scaling": 1.5, "core_scaling": 2.0},
    "exclude_index": {"exclude_devices": ("1",)},
    "exclude_uuid": {"exclude_devices": ("fake-2", "3")},
}


@pytest.mark.parametrize("name", sorted(NODE_CONFIGS))
@pytest.mark.parametrize("with_store", [False, True])
def test_shape_chips_equal_jax(name, with_store, tmp_path):
    kw = NODE_CONFIGS[name]
    chips = FakeBackend(4).discover().chips
    jax_chips = [jty.ChipSpec.from_wire(c.to_wire()) for c in chips]
    port = tnc.shape_chips(
        chips, tnc.NodeConfig(**kw), "node-1",
        tnc.DeviceIDStore(str(tmp_path / "p.json")) if with_store else None)
    jax = jnc.shape_chips(
        jax_chips, jnc.NodeConfig(**kw), "node-1",
        jnc.DeviceIDStore(str(tmp_path / "j.json")) if with_store else None)
    assert [c.to_wire() for c in port] == [c.to_wire() for c in jax]
    if with_store:
        assert json.loads((tmp_path / "p.json").read_text()) == \
            json.loads((tmp_path / "j.json").read_text())


def test_id_store_keeps_ids_across_restarts(tmp_path):
    path = str(tmp_path / "ids.json")
    assert tnc.DeviceIDStore(path).uuid_for("n1", 2) == "n1-chip-2"
    assert tnc.DeviceIDStore(path).uuid_for("other", 2) == "n1-chip-2"
    assert tnc.DeviceIDStore(path).uuid_for("n1", 3, "GPU-x") == "GPU-x"


YAML_DOC = """\
default:
  deviceSplitCount: 6
  memoryScaling: 1.25
nodes:
  - name: "gpu-*"
    excludeDevices: 3
    compatMode: cgroup
  - name: gpu-node-1
    deviceSplitCount: 2
    excludeDevices: ["0", "GPU-x"]
"""


@pytest.mark.parametrize("node", ["gpu-node-1", "gpu-node-9", "cpu-1"])
def test_yaml_node_config_equal_jax(node, tmp_path):
    path = tmp_path / "node.yaml"
    path.write_text(YAML_DOC)
    assert tnc.load_node_config(str(path), node).__dict__ == \
        jnc.load_node_config(str(path), node).__dict__


def test_json_node_config_needs_no_yaml(tmp_path, monkeypatch):
    path = tmp_path / "node.json"
    path.write_text(json.dumps({"default": {"deviceSplitCount": 3},
                                "nodes": [{"name": "n1",
                                           "excludeDevices": [1]}]}))
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = tnc.load_node_config(str(path), "n1")
    assert cfg.device_split_count == 3 and cfg.exclude_devices == ("1",)


def test_yaml_node_config_without_yaml_names_the_file(tmp_path,
                                                      monkeypatch):
    path = tmp_path / "node.yaml"
    path.write_text(YAML_DOC)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match=str(path)):
        tnc.load_node_config(str(path), "gpu-node-1")


@pytest.mark.parametrize("bad", [{"deviceSplitCount": 0},
                                 {"memoryScaling": 0},
                                 {"compatMode": "mig"}])
def test_invalid_node_config_raises_as_jax(bad, tmp_path):
    path = tmp_path / "node.json"
    path.write_text(json.dumps({"default": bad}))
    with pytest.raises(ValueError):
        jnc.load_node_config(str(path), "n1")
    with pytest.raises(ValueError):
        tnc.load_node_config(str(path), "n1")


@pytest.mark.parametrize("status", [0, 404, 409, 429, 500, 503, 422])
def test_is_retryable_equal_jax(status):
    assert tpol.is_retryable(KubeError(status, "x")) == \
        jpol.is_retryable(JaxKubeError(status, "x"))


def test_retry_policy_retries_transient_and_honours_retry_after():
    sleeps = []
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise KubeError(503, "busy", retry_after=0.5)
        return "ok"

    policy = tpol.RetryPolicy(max_attempts=5, sleep=sleeps.append)
    assert policy.run(flaky) == "ok"
    assert len(calls) == 3 and all(s >= 0.5 for s in sleeps)
    with pytest.raises(KubeError):
        tpol.RetryPolicy(sleep=sleeps.append).run(
            lambda: (_ for _ in ()).throw(KubeError(404, "gone")))


@pytest.mark.parametrize("spec", ["", "StepTelemetry=true",
                                  "HonorPreAllocatedDeviceIDs=true, "
                                  "TCWatcher=true,VMemoryNode=false"])
def test_feature_gates_parse_as_jax(spec):
    port, jax = tfg.FeatureGates(), jfg.FeatureGates()
    port.parse(spec)
    jax.parse(spec)
    for name in port.known():
        assert port.enabled(name) == jax.enabled(name)


@pytest.mark.parametrize("spec", ["ICILinkAware=true",
                                  "StepTelemetry=yes",
                                  "StepTelemetry"])
def test_feature_gates_refuse_what_the_port_lacks(spec):
    gates = tfg.FeatureGates()
    with pytest.raises(ValueError):
        gates.parse(spec)
    assert not gates.enabled(tfg.STEP_TELEMETRY)
