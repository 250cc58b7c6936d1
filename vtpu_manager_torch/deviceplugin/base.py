"""The device plugin's gRPC side: serving, kubelet registration, restarts.

The port of the JAX package's `deviceplugin/base.py:30-194`. A
`DevicePluginServicer` speaks the plain messages of `api/messages.py`;
`PluginServer` serves it on a unix socket under kubelet's plugin
directory, converting between those messages and the generated protobuf
ones at the boundary, registers it with kubelet, and registers it again
when kubelet's socket is recreated. This module, the generated one and
the entry point are the only ones that need `grpc` and `protobuf`, and
this one imports them only when a server is made: the plugin subclasses
`DevicePluginServicer` on a machine without them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time

from vtpu_manager_torch.deviceplugin.api import messages as api

log = logging.getLogger(__name__)

KUBELET_DIR = "/var/lib/kubelet/device-plugins"
API_VERSION = "v1beta1"


class DevicePluginServicer:
    """Override per plugin. The defaults advertise nothing."""

    resource_name = "example.com/none"
    socket_name = "vtpu-none.sock"
    pre_start_required = False
    preferred_allocation_available = False

    def list_devices(self) -> list[api.Device]:
        return []

    def watch_devices(self):
        """Yields device lists: at least once, then on changes."""
        yield self.list_devices()
        while True:
            time.sleep(5)
            yield self.list_devices()

    def get_preferred_allocation(self, request: api.PreferredAllocationRequest
                                 ) -> api.PreferredAllocationResponse:
        return api.PreferredAllocationResponse()

    def allocate(self, request: api.AllocateRequest) -> api.AllocateResponse:
        return api.AllocateResponse()

    def pre_start_container(self, request: api.PreStartContainerRequest
                            ) -> api.PreStartContainerResponse:
        return api.PreStartContainerResponse()


def to_proto(message, pb_cls):
    """The generated message for a dataclass of `api.messages`."""
    from google.protobuf import json_format
    return json_format.ParseDict(dataclasses.asdict(message), pb_cls())


def unary(fn, req_cls, resp_cls):
    """A unary gRPC handler over generated request/response classes."""
    import grpc
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString)


def allocate_request(msg) -> api.AllocateRequest:
    return api.AllocateRequest([api.ContainerAllocateRequest(
        list(c.devicesIDs)) for c in msg.container_requests])


def preferred_request(msg) -> api.PreferredAllocationRequest:
    return api.PreferredAllocationRequest([
        api.ContainerPreferredAllocationRequest(
            list(c.available_deviceIDs), list(c.must_include_deviceIDs),
            c.allocation_size) for c in msg.container_requests])


def prestart_request(msg) -> api.PreStartContainerRequest:
    return api.PreStartContainerRequest(list(msg.devicesIDs))


class PluginServer:
    """Serves one DevicePluginServicer on a unix socket and keeps it
    registered with kubelet."""

    def __init__(self, servicer: DevicePluginServicer,
                 plugin_dir: str = KUBELET_DIR,
                 kubelet_socket: str | None = None):
        self.servicer = servicer
        self.plugin_dir = plugin_dir
        self.kubelet_socket = kubelet_socket or os.path.join(
            plugin_dir, "kubelet.sock")
        self.socket_path = os.path.join(plugin_dir, servicer.socket_name)
        self._server = None
        self._stop = threading.Event()

    def _options(self):
        from vtpu_manager_torch.deviceplugin.api import deviceplugin_pb2 as pb
        s = self.servicer
        return pb.DevicePluginOptions(
            pre_start_required=s.pre_start_required,
            get_preferred_allocation_available=
            s.preferred_allocation_available)

    def _handlers(self):
        import grpc

        from vtpu_manager_torch.deviceplugin.api import deviceplugin_pb2 as pb
        s = self.servicer

        def list_and_watch(request, context):
            for devices in s.watch_devices():
                if self._stop.is_set():
                    return
                yield to_proto(api.ListAndWatchResponse(devices),
                               pb.ListAndWatchResponse)

        handlers = {
            "GetDevicePluginOptions": unary(
                lambda req, ctx: self._options(), pb.Empty,
                pb.DevicePluginOptions),
            "ListAndWatch": grpc.unary_stream_rpc_method_handler(
                list_and_watch, request_deserializer=pb.Empty.FromString,
                response_serializer=pb.ListAndWatchResponse.SerializeToString),
            "GetPreferredAllocation": unary(
                lambda req, ctx: to_proto(
                    s.get_preferred_allocation(preferred_request(req)),
                    pb.PreferredAllocationResponse),
                pb.PreferredAllocationRequest,
                pb.PreferredAllocationResponse),
            "Allocate": unary(
                lambda req, ctx: to_proto(s.allocate(allocate_request(req)),
                                          pb.AllocateResponse),
                pb.AllocateRequest, pb.AllocateResponse),
            "PreStartContainer": unary(
                lambda req, ctx: to_proto(
                    s.pre_start_container(prestart_request(req)),
                    pb.PreStartContainerResponse),
                pb.PreStartContainerRequest, pb.PreStartContainerResponse),
        }
        return grpc.method_handlers_generic_handler("v1beta1.DevicePlugin",
                                                    handlers)

    def serve(self) -> None:
        from concurrent import futures

        import grpc
        os.makedirs(self.plugin_dir, exist_ok=True)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((self._handlers(),))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        log.info("%s serving on %s", self.servicer.resource_name,
                 self.socket_path)

    def register(self) -> None:
        """Announces the plugin to kubelet."""
        import grpc

        from vtpu_manager_torch.deviceplugin.api import deviceplugin_pb2 as pb
        with grpc.insecure_channel(f"unix://{self.kubelet_socket}") as chan:
            stub = chan.unary_unary(
                "/v1beta1.Registration/Register",
                request_serializer=pb.RegisterRequest.SerializeToString,
                response_deserializer=pb.Empty.FromString)
            stub(pb.RegisterRequest(
                version=API_VERSION, endpoint=self.servicer.socket_name,
                resource_name=self.servicer.resource_name,
                options=self._options()), timeout=10)
        log.info("registered %s with kubelet", self.servicer.resource_name)

    def watch_kubelet_restarts(self, poll_s: float = 2.0) -> None:
        """Registers again when kubelet.sock is recreated (polling, so no
        inotify is needed)."""
        import grpc

        # latch the socket's identity now: a restart before the thread's
        # first poll must not pass unseen
        try:
            st = os.stat(self.kubelet_socket)
            initial_id = (st.st_ino, st.st_ctime_ns)
        except OSError:
            initial_id = None

        def loop():
            last_id = initial_id
            while not self._stop.wait(poll_s):
                try:
                    st = os.stat(self.kubelet_socket)
                except OSError:
                    continue
                # a recreated socket can reuse the inode number: the
                # creation time tells them apart
                sock_id = (st.st_ino, st.st_ctime_ns)
                if last_id is None:
                    last_id = sock_id
                    continue
                if sock_id != last_id:
                    log.warning("kubelet restarted; re-registering")
                    try:
                        self.register()
                        # only once it took: a kubelet not serving yet is
                        # tried again at the next poll
                        last_id = sock_id
                    except grpc.RpcError:
                        log.error("re-registration failed; will retry")

        threading.Thread(target=loop, daemon=True,
                         name="vtpu-kubelet-watch").start()

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop(grace=1)
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
