"""Kubelet's plugin-watcher registration, and ResourceSlice publication.

The port of the JAX package's `kubeletplugin/registration.py:28-103`.
Kubelet finds DRA drivers by watching its plugins_registry directory for
sockets that serve pluginregistration.Registration (GetInfo,
NotifyRegistrationStatus). `grpc` and the generated module are imported
only when the socket is served.
"""

from __future__ import annotations

import logging
import os

from vtpu_manager_torch.util import consts

log = logging.getLogger(__name__)

PLUGINS_REGISTRY_DIR = "/var/lib/kubelet/plugins_registry"
DRA_PLUGIN_TYPE = "DRAPlugin"
SUPPORTED_VERSIONS = ("v1beta1",)


class RegistrationServer:
    """Serves pluginregistration.Registration in the watcher's directory,
    pointing kubelet at the DRA service's socket (`endpoint`)."""

    def __init__(self, endpoint: str,
                 registry_dir: str = PLUGINS_REGISTRY_DIR):
        self.endpoint = endpoint
        self.registry_dir = registry_dir
        self.socket_path = os.path.join(
            registry_dir, f"{consts.DRA_DRIVER_NAME}-reg.sock")
        self._server = None
        self.last_status: tuple[bool, str] | None = None

    def _handlers(self):
        import grpc

        from vtpu_manager_torch.deviceplugin.base import unary
        from vtpu_manager_torch.kubeletplugin.api import \
            pluginregistration_pb2 as pb

        def get_info(request, context):
            return pb.PluginInfo(type=DRA_PLUGIN_TYPE,
                                 name=consts.DRA_DRIVER_NAME,
                                 endpoint=self.endpoint,
                                 supported_versions=list(SUPPORTED_VERSIONS))

        def notify(request, context):
            self.last_status = (request.plugin_registered, request.error)
            if request.plugin_registered:
                log.info("kubelet accepted registration of %s",
                         consts.DRA_DRIVER_NAME)
            else:
                log.error("kubelet rejected registration: %s", request.error)
            return pb.RegistrationStatusResponse()

        return grpc.method_handlers_generic_handler(
            "pluginregistration.Registration", {
                "GetInfo": unary(get_info, pb.InfoRequest, pb.PluginInfo),
                "NotifyRegistrationStatus": unary(
                    notify, pb.RegistrationStatus,
                    pb.RegistrationStatusResponse),
            })

    def serve(self) -> None:
        from concurrent import futures

        import grpc
        os.makedirs(self.registry_dir, exist_ok=True)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        self._server.add_generic_rpc_handlers((self._handlers(),))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        log.info("plugin registration socket: %s", self.socket_path)

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1)
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass


def publish_resource_slice(client, slice_doc: dict) -> bool:
    """Applies the slice through the API client (best effort): False when
    the client cannot, or the apply failed."""
    apply = getattr(client, "apply_resourceslice", None)
    if apply is None:
        log.warning("client cannot publish ResourceSlices")
        return False
    try:
        apply(slice_doc)
        return True
    except Exception:  # noqa: BLE001 - logged; the health loop retries
        log.exception("ResourceSlice publication failed")
        return False
