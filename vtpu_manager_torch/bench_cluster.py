"""A pod in a cluster reaches its slice of the card: the checks of
chip_smoke.py's `cluster` phase.

The DRA path of `bench_dra.py` with the cluster's two parts that phase
plays itself put back: the API server, reached by the port's in-cluster
client over TLS, and the container runtime's NRI hook. On a private node
(`bench_allocate.Node`: NVML discovery split 4 ways, the interposer
installed, locks, ledger and the NVML-fed watcher in directories of
their own):

- the API server is `client.apistub.ApiStub` on 127.0.0.1, over TLS with
  the test CA and server pair under tests/data/kube-stub. It holds the
  node, two pods and their ResourceClaims, whose reservedFor names each
  claim's pod, and records every request;
- the kubelet plugin's driver is built as its command builds it, with
  `InClusterClient` pointed at the stub (the card machine has no grpc, so
  kubelet's calls are made directly, as in the `dra` phase);
- the container runtime is a mux-mode ttrpc server on a unix socket, to
  which the port's `NriPlugin` registers, and which sends it
  CreateContainer.

Checks, each a record with an `ok` verdict:

1. slice: the ResourceSlice reaches the stub as PUT (404) then POST and
   names the card NVML sees;
2. prepare: NodePrepareResources for both claims fetches each from the
   stub and answers its CDI device;
3. nri: the plugin registers; CreateContainer for claim A's container (its
   CDI environment) is adjusted with VTPU_REGISTER_UUID and the claim's
   config mount, a container of pod B whose environment names claim A is
   refused, and a container that names no claim is left untouched; the
   ownership checks went to the stub;
4. tenants: claims A (50 %, 16 GiB) and B (25 %, 8 GiB) run together,
   each started from nothing but its CDI environment and its NRI
   adjustment (the config mount taken from the adjustment, resolved to its
   host path), beside an unthrottled tenant alone for t_solo: shares
   within SHARE_BAND of 50 and 25 and in order, caps exact;
5. allocate: the device plugin's `VnumPlugin.allocate` for a pod the
   scheduler committed, listed through the in-cluster client, answers what
   it answers with the fake client, and its annotations reach the stub.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from pathlib import Path

from vtpu_manager_torch import bench_allocate as ba
from vtpu_manager_torch import bench_dra as bd
from vtpu_manager_torch import bench_quota as bq
from vtpu_manager_torch.build import REPO
from vtpu_manager_torch.util import consts

GIB = 2**30
SHARE_BAND = 15.0
CERTS = REPO / "tests" / "data" / "kube-stub"
TOKEN = "cluster-phase-token"
# claim: (its pod, {request: [slot, ...]}, cores %, memory GiB per result)
CLAIMS = {"claim-a": ("pod-a", {"gpu": [0, 1]}, 25, 8),
          "claim-b": ("pod-b", {"gpu": [2]}, 25, 8)}
ALLOCATE_POD = "pod-c"          # the device plugin's pod, slot 3


def owned_claim(name: str, index: int) -> dict:
    """bench_dra's allocated claim, reserved for its pod."""
    pod, requests, cores, gib = CLAIMS[name]
    claim = bd.allocated_claim(name, index, requests, cores, gib * 1024)
    claim["status"]["reservedFor"] = [{"resource": "pods", "name": pod,
                                       "uid": f"uid-{pod}"}]
    return claim


def apply_adjustment(device: dict, adjust) -> dict:
    """The environment a runtime gives a tenant from its CDI device and the
    NRI adjustment: the adjustment's env added, its mounts in place of the
    CDI mounts at the same container paths, resolved to host paths."""
    from vtpu_manager_torch.deviceplugin.api import messages as api
    resp = bd.as_response(device)
    resp.envs.update({kv.key: kv.value for kv in adjust.env})
    replaced = {m.destination for m in adjust.mounts}
    resp.mounts = [m for m in resp.mounts
                   if m.container_path not in replaced] + [
        api.Mount(container_path=m.destination, host_path=m.source,
                  read_only="ro" in m.options) for m in adjust.mounts]
    return ba.container_env(resp)


class Phase:
    def __init__(self, torch, shim: str, root: str):
        from vtpu_manager_torch.client.apistub import ApiStub
        from vtpu_manager_torch.client.kube import InClusterClient
        self.node = ba.Node(root, shim)
        uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        self.chip = next((c for c in self.node.manager.chips
                          if c.uuid == uuid), None)
        if self.chip is None:
            raise RuntimeError(f"NVML's devices do not include torch's "
                               f"{uuid}")
        self.shim = shim
        self.root = Path(root)
        self.stub = ApiStub(str(CERTS / "server.crt"),
                            str(CERTS / "server.key"), token=TOKEN)
        store = self.stub.store
        store.add_node({"metadata": {"name": ba.NODE, "annotations": {}}})
        for name in CLAIMS:
            claim = owned_claim(name, self.chip.index)
            store.add_resourceclaim(claim)
            pod = CLAIMS[name][0]
            store.add_pod({"metadata": {"name": pod,
                                        "namespace": bd.NAMESPACE,
                                        "uid": f"uid-{pod}"},
                           "spec": {"nodeName": ba.NODE}})
        self.stub.start()
        token = self.root / "token"
        token.write_text(TOKEN)
        self.client = InClusterClient(self.stub.url, str(token),
                                      str(CERTS / "ca.crt"))
        self.driver = self._driver()
        self.sock_dir = tempfile.mkdtemp(prefix="nri-")   # a short path
        self.runtime_server = None
        self.session = None
        self.adjustments: dict[str, object] = {}
        self.runs: dict[str, dict] = {}

    def close(self) -> None:
        if self.session is not None:
            self.session.close()
        if self.runtime_server is not None:
            self.runtime_server.stop()
        shutil.rmtree(self.sock_dir, ignore_errors=True)
        self.stub.stop()
        self.node.close()

    def _driver(self):
        """The kubelet plugin's driver, as its command builds it, with the
        in-cluster client as its claim source."""
        from vtpu_manager_torch.kubeletplugin.device_state import DeviceState
        from vtpu_manager_torch.kubeletplugin.driver import (ClaimSource,
                                                             DraDriver)
        node = self.node
        state = DeviceState(
            ba.NODE, node.manager.chips, base_dir=str(self.root / "dra"),
            cdi_dir=str(self.root / "cdi"),
            node_config=node.manager.node_config, minors=node.manager.minors,
            shim_host_dir=node.driver_dir, lock_dir=node.lock_dir,
            vmem_dir=node.vmem_dir, watcher_dir=node.watcher_dir,
            registry_dir=str(self.root / "registry"))
        return DraDriver(ba.NODE, ClaimSource(self.client), state,
                         plugin_dir=str(self.root / "plugins"))

    def _requests(self, method: str, prefix: str) -> list[str]:
        return [r["path"] for r in self.stub.requests_to(method, prefix)]

    # --- 1. the ResourceSlice through the API -----------------------------

    def check_slice(self) -> dict:
        from vtpu_manager_torch.kubeletplugin.allocatable import \
            build_resource_slice
        from vtpu_manager_torch.kubeletplugin.registration import \
            publish_resource_slice
        published = publish_resource_slice(
            self.client, build_resource_slice(ba.NODE,
                                              self.node.manager.chips))
        name = f"{ba.NODE}-vtpu"
        doc = self.stub.store.resourceslices.get(name, {})
        attrs = [d["basic"]["attributes"]
                 for d in doc.get("spec", {}).get("devices", [])]
        calls = [(r["method"], r["path"]) for r in self.stub.requests
                 if "resourceslices" in r["path"]]
        rec = {"published": published, "calls": calls,
               "devices": len(attrs),
               "uuids": sorted({a["uuid"]["string"] for a in attrs}),
               "nvml_uuid": self.chip.uuid}
        base = "/apis/resource.k8s.io/v1beta1/resourceslices"
        rec["ok"] = bool(
            published and calls == [("PUT", f"{base}/{name}"),
                                    ("POST", base)]
            and rec["devices"] == ba.SPLIT
            and rec["uuids"] == [self.chip.uuid]
            and doc["spec"]["nodeName"] == ba.NODE)
        return rec

    # --- 2. prepare, the claims fetched through the API -------------------

    def check_prepare(self) -> dict:
        from vtpu_manager_torch.kubeletplugin import cdi
        from vtpu_manager_torch.kubeletplugin.api import messages as api
        resp = self.driver.node_prepare(api.NodePrepareResourcesRequest([
            api.Claim(f"uid-{n}", n, bd.NAMESPACE) for n in CLAIMS]))
        out = {"errors": {u: e.error for u, e in resp.claims.items()},
               "cdi": {u: [list(d.cdi_device_ids) for d in e.devices]
                       for u, e in resp.claims.items()},
               "fetched": self._requests("GET", "/apis/resource.k8s.io")}
        out["ok"] = (
            not any(out["errors"].values())
            and all(out["cdi"][f"uid-{n}"] == [[cdi.cdi_device_name(
                f"uid-{n}")]] for n in CLAIMS)
            and all(any(p.endswith(f"/resourceclaims/{n}")
                        for p in out["fetched"]) for n in CLAIMS))
        return out

    # --- 3. the NRI hook ----------------------------------------------------

    def _create(self, pod: str, env: list[str], name: str = "main"):
        from vtpu_manager_torch.kubeletplugin import nri_transport as nt
        from vtpu_manager_torch.kubeletplugin.api import nri_messages as nm
        from vtpu_manager_torch.util import ttrpc
        req = nm.CreateContainerRequest(
            pod=nm.PodSandbox(uid=f"uid-{pod}", name=pod,
                              namespace=bd.NAMESPACE),
            container=nm.Container(name=name, env=env))
        try:
            raw = self.runtime.call(nt.PLUGIN_SERVICE, "CreateContainer",
                                    req.encode())
        except ttrpc.TtrpcError as e:
            return None, e.message
        return nm.CreateContainerResponse.decode(raw).adjust, ""

    def check_nri(self) -> dict:
        from vtpu_manager_torch.kubeletplugin import nri_transport as nt
        from vtpu_manager_torch.kubeletplugin.api import nri_messages as nm
        from vtpu_manager_torch.kubeletplugin.nri import RuntimeHook
        from vtpu_manager_torch.util import ttrpc
        registered = []

        def register(raw: bytes) -> bytes:
            req = nm.RegisterPluginRequest.decode(raw)
            registered.append((req.plugin_name, req.plugin_idx))
            return nm.Empty().encode()

        sock = os.path.join(self.sock_dir, "nri.sock")
        self.runtime_server = ttrpc.TtrpcServer(sock, {
            (nt.RUNTIME_SERVICE, "RegisterPlugin"): register}, mux=True)
        self.session = nt.NriPlugin(
            RuntimeHook(self.driver.state),
            claim_uids_for_pod=self.driver.claim_uids_for_pod).run(sock)
        self.runtime = self.runtime_server.wait_for_connection()
        configured = nm.ConfigureResponse.decode(self.runtime.call(
            nt.PLUGIN_SERVICE, "Configure", nm.ConfigureRequest(
                runtime_name="cluster-phase").encode())).events
        fetched_before = len(self._requests("GET", "/apis/resource.k8s.io"))
        envs = {n: bd.read_spec(self.driver.state.cdi_dir, f"uid-{n}")[
            f"uid-{n}"]["containerEdits"]["env"] for n in CLAIMS}
        for name in CLAIMS:
            adjust, _ = self._create(CLAIMS[name][0], envs[name])
            self.adjustments[name] = adjust
        spoofed, spoof_error = self._create("pod-b", envs["claim-a"])
        plain, plain_error = self._create("pod-b", ["PATH=/usr/bin"],
                                          name="sidecar")
        owned = self.adjustments["claim-a"]
        config = f"{self.driver.state.base_dir}/claim_uid-claim-a/config"
        out = {"registered": registered, "events": configured,
               "owned": dataclasses.asdict(owned) if owned else None,
               "spoofed": {"adjusted": spoofed is not None,
                           "error": spoof_error},
               "plain": {"adjust": dataclasses.asdict(plain) if plain
                         else None, "error": plain_error},
               "ownership_lookups": len(self._requests(
                   "GET", "/apis/resource.k8s.io")) - fetched_before}
        out["ok"] = bool(
            registered == [("vtpu-manager", "10")]
            and configured == nt.EVENT_CREATE_CONTAINER
            | nt.EVENT_STOP_CONTAINER
            and all(self.adjustments[n] is not None for n in CLAIMS)
            and [(kv.key, kv.value) for kv in owned.env]
            == [(consts.ENV_REGISTER_UUID, "uid-claim-a")]
            and [(m.source, m.destination, m.options) for m in owned.mounts]
            == [(config, f"{consts.MANAGER_BASE_DIR}/config",
                 ["ro", "rbind"])]
            and spoofed is None and "does not own" in spoof_error
            and plain == nm.ContainerAdjustment() and not plain_error
            and out["ownership_lookups"] >= 3)
        return out

    # --- 4. tenants from the CDI environment and the NRI adjustment -------

    def check_tenants(self) -> dict:
        if not all(self.adjustments.get(n) for n in CLAIMS):
            return {"ok": False, "error": "no NRI adjustment to start from"}
        self.runs.update(bq.run_tenants(self.node, [
            ("solo", bd.TENANT_ARGS, bq.tenant_env(self.shim, 100))]))
        cdi_dir = self.driver.state.cdi_dir
        self.runs.update(bq.run_tenants(self.node, [
            (name, bd.TENANT_ARGS, apply_adjustment(
                bd.read_spec(cdi_dir, f"uid-{name}")[f"uid-{name}"],
                self.adjustments[name])) for name in CLAIMS]))
        solo = self.runs["solo"]["ms_per_step"]
        out = {"solo": self.runs["solo"]}
        for name, memory in (("claim-a", 16 * GIB), ("claim-b", 8 * GIB)):
            r = dict(self.runs[name])
            r["share"] = 100.0 * solo / r["ms_per_step"]
            r["ok"] = (r["source"] == "config-file" and r["claim"] == memory
                       and r["total"] == memory and r["over_claim"] == "oom"
                       and r["kernel_launches_delta"] == 1
                       and r["kernel_shim_launches_delta"] >= 1
                       and r["vtpu_fail_open_total"] == 0)
            out[name] = r
        a, b = out["claim-a"]["share"], out["claim-b"]["share"]
        out["shares_ok"] = (abs(a - 50) <= SHARE_BAND
                            and abs(b - 25) <= SHARE_BAND and a > b)
        out["ok"] = (out["shares_ok"] and out["claim-a"]["ok"]
                     and out["claim-b"]["ok"])
        return out

    # --- 5. the device plugin over the in-cluster client ------------------

    def check_allocate(self) -> dict:
        from vtpu_manager_torch.client.fake import FakeKubeClient
        from vtpu_manager_torch.deviceplugin.api import messages as api
        from vtpu_manager_torch.deviceplugin.vnum import VnumPlugin, device_id
        pod = ba.committed_pod(ALLOCATE_POD, self.chip, 25, 8 * GIB)
        self.stub.store.add_pod(pod)
        fake = FakeKubeClient()
        fake.add_pod(pod)
        node = self.node
        responses = {}
        for tag, client in (("in_cluster", self.client), ("fake", fake)):
            plugin = VnumPlugin(node.manager, client, ba.NODE,
                                node_config=node.manager.node_config,
                                base_dir=node.base_dir,
                                shim_host_dir=node.driver_dir,
                                lock_dir=node.lock_dir,
                                vmem_dir=node.vmem_dir,
                                watcher_dir=node.watcher_dir)
            (responses[tag],) = plugin.allocate(api.AllocateRequest([
                api.ContainerAllocateRequest(
                    [device_id(self.chip.uuid, 3)])])).container_responses
        anns = self.stub.store.get_pod("default", ALLOCATE_POD)["metadata"][
            "annotations"]
        out = {"in_cluster": dataclasses.asdict(responses["in_cluster"]),
               "equal": responses["in_cluster"] == responses["fake"],
               "listed": self._requests("GET", "/api/v1/pods"),
               "status": anns.get(consts.allocation_status_annotation())}
        out["ok"] = bool(
            out["equal"] and out["listed"]
            and out["status"] == consts.ALLOC_STATUS_SUCCEED
            and responses["in_cluster"].envs.get(
                f"{consts.ENV_MEM_LIMIT}_0") == str(8 * GIB))
        return out
