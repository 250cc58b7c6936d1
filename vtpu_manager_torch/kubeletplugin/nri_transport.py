"""The NRI plugin: the ttrpc stub around the runtime hook's policy.

The port of the JAX package's `kubeletplugin/nri_transport.py:48-191`
(`NriPlugin`, `NriSession`), on the port's ttrpc and its own proto3
codec (`api/nri_messages.py`), so it runs where protobuf is not
installed. The plugin dials the runtime's NRI socket, registers
(Runtime.RegisterPlugin) and serves the Plugin service (Configure,
Synchronize, CreateContainer, StopContainer, StateChange, Shutdown) on the
same mux-framed socket. It subscribes to CreateContainer and
StopContainer.

CreateContainer is where the hook runs. A container that names a claim
is checked against the claims its pod owns, which the resolver gives
(`DraDriver.claim_uids_for_pod`, by the claim's reservedFor through the
API server); a container that names none never reaches the resolver, so a
resolver failure fails only tenant containers. A rejection fails the call
outright, and the runtime does not create the container.
"""

from __future__ import annotations

import logging
import socket

from vtpu_manager_torch.kubeletplugin.api import nri_messages as nri
from vtpu_manager_torch.kubeletplugin.nri import RuntimeHook
from vtpu_manager_torch.util import ttrpc

log = logging.getLogger(__name__)

PLUGIN_SERVICE = "nri.pkg.api.v1alpha1.Plugin"
RUNTIME_SERVICE = "nri.pkg.api.v1alpha1.Runtime"
DEFAULT_SOCKET = "/var/run/nri/nri.sock"

# EventMask bits: upstream's 1-based Event enum, bit = 1 << (event - 1)
# (CREATE_CONTAINER = 4, STOP_CONTAINER = 10)
EVENT_CREATE_CONTAINER = 1 << 3
EVENT_STOP_CONTAINER = 1 << 9


def _container_to_dict(c) -> dict:
    return {"name": c.name, "env": list(c.env)}


class NriPlugin:
    """Decodes the runtime's requests, runs the hook, encodes its
    adjustments."""

    def __init__(self, hook: RuntimeHook, claim_uids_for_pod=None,
                 plugin_name: str = "vtpu-manager", plugin_idx: str = "10"):
        self.hook = hook
        # (pod uid, claimed uid) -> the claim uids the pod owns; bounded to
        # the one claim the container names
        self.claim_uids_for_pod = claim_uids_for_pod or (
            lambda pod_uid, claim_uid: [])
        self.plugin_name = plugin_name
        self.plugin_idx = plugin_idx
        self.configured = False
        # (pods, containers) from the runtime's Synchronize
        self.synchronized: tuple[list[dict], list[dict]] | None = None
        self.events_seen: list[int] = []

    def handlers(self) -> dict:
        return {
            (PLUGIN_SERVICE, "Configure"): self._configure,
            (PLUGIN_SERVICE, "Synchronize"): self._synchronize,
            (PLUGIN_SERVICE, "CreateContainer"): self._create_container,
            (PLUGIN_SERVICE, "StopContainer"): self._stop_container,
            (PLUGIN_SERVICE, "StateChange"): self._state_change,
            (PLUGIN_SERVICE, "Shutdown"): self._shutdown,
        }

    def _configure(self, raw: bytes) -> bytes:
        req = nri.ConfigureRequest.decode(raw)
        log.info("NRI configure from %s %s", req.runtime_name,
                 req.runtime_version)
        self.configured = True
        return nri.ConfigureResponse(
            events=EVENT_CREATE_CONTAINER | EVENT_STOP_CONTAINER).encode()

    def _synchronize(self, raw: bytes) -> bytes:
        # existing containers are observed, never adjusted after the fact
        req = nri.SynchronizeRequest.decode(raw)
        self.synchronized = (
            [{"uid": p.uid, "name": p.name, "namespace": p.namespace}
             for p in req.pods],
            [_container_to_dict(c) for c in req.containers])
        return nri.SynchronizeResponse().encode()

    def _create_container(self, raw: bytes) -> bytes:
        req = nri.CreateContainerRequest.decode(raw)
        pod = req.pod or nri.PodSandbox()
        container = _container_to_dict(req.container or nri.Container())
        # tenants only reach the resolver, which may call the API server
        claim_uids: list[str] = []
        claimed = RuntimeHook._claimed_uid(container)
        if claimed is not None:
            try:
                claim_uids = self.claim_uids_for_pod(pod.uid, claimed)
            except Exception as e:  # noqa: BLE001 - fails this tenant only
                raise ttrpc.TtrpcError(
                    ttrpc.CODE_UNKNOWN,
                    f"vtpu-manager: claim ownership lookup failed for pod "
                    f"{pod.uid}: {e}") from e
        adj = self.hook.create_container(
            {"uid": pod.uid, "name": pod.name, "namespace": pod.namespace,
             "claim_uids": claim_uids}, container)
        if adj.rejected:
            raise ttrpc.TtrpcError(ttrpc.CODE_UNKNOWN,
                                   f"vtpu-manager: {adj.reason}")
        return nri.CreateContainerResponse(adjust=nri.ContainerAdjustment(
            env=[nri.KeyValue(key=k, value=v) for k, v in adj.env.items()],
            mounts=[nri.Mount(source=m.get("source", ""),
                              destination=m.get("destination", ""),
                              type=m.get("type", "bind"),
                              options=list(m.get("options", [])))
                    for m in adj.mounts])).encode()

    def _stop_container(self, raw: bytes) -> bytes:
        nri.StopContainerRequest.decode(raw)
        return nri.StopContainerResponse().encode()

    def _state_change(self, raw: bytes) -> bytes:
        self.events_seen.append(nri.StateChangeEvent.decode(raw).event)
        return nri.Empty().encode()

    def _shutdown(self, raw: bytes) -> bytes:
        log.info("NRI shutdown requested by runtime")
        return nri.Empty().encode()

    def run(self, socket_path: str = DEFAULT_SOCKET) -> "NriSession":
        """Dials the runtime, registers and serves until it hangs up. The
        Plugin service is served on one mux channel while RegisterPlugin
        goes out on the other. Returns the live session; reconnecting is
        the caller's policy."""
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(socket_path)
        except OSError:
            sock.close()
            raise
        mux = ttrpc.Mux(sock)
        serve_conn = ttrpc.Connection(mux.channel(ttrpc.MUX_PLUGIN_CONN),
                                      self.handlers(), initiator=False)
        call_conn = ttrpc.Connection(mux.channel(ttrpc.MUX_RUNTIME_CONN),
                                     initiator=True)
        try:
            call_conn.call(RUNTIME_SERVICE, "RegisterPlugin",
                           nri.RegisterPluginRequest(
                               plugin_name=self.plugin_name,
                               plugin_idx=self.plugin_idx).encode())
        except Exception:
            mux.close()
            raise
        log.info("registered with NRI runtime at %s", socket_path)
        return NriSession(mux, serve_conn, call_conn)


class NriSession:
    """The plugin's live attachment: the mux and both directions."""

    def __init__(self, mux: ttrpc.Mux, serve_conn: ttrpc.Connection,
                 call_conn: ttrpc.Connection):
        self.mux = mux
        self.serve_conn = serve_conn
        self.call_conn = call_conn

    def close(self) -> None:
        self.mux.close()
