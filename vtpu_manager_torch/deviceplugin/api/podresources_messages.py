"""Kubelet's pod-resources `v1alpha1` messages with their proto3 wire format,
without protobuf.

The card machine has no `protobuf`. This is the port's counterpart of the
JAX package's generated `deviceplugin/api/podresources_pb2.py`, with the
field numbers of its `podresources.proto` (kubelet's
`pkg/apis/podresources/v1alpha1/api.proto`), on the codec of
`kubeletplugin/api/nri_messages.py`: unknown fields are skipped, so a newer
kubelet's reply still decodes.
"""

from __future__ import annotations

from vtpu_manager_torch.kubeletplugin.api.nri_messages import _m, _message, _s

LIST_METHOD = "/v1alpha1.PodResources/List"

ListPodResourcesRequest = _message("ListPodResourcesRequest")
ContainerDevices = _message("ContainerDevices", _s("resource_name", 1),
                            _s("device_ids", 2, repeated=True))
ContainerResources = _message("ContainerResources", _s("name", 1),
                              _m("devices", 2, ContainerDevices,
                                 repeated=True))
PodResources = _message("PodResources", _s("name", 1), _s("namespace", 2),
                        _m("containers", 3, ContainerResources,
                           repeated=True))
ListPodResourcesResponse = _message(
    "ListPodResourcesResponse",
    _m("pod_resources", 1, PodResources, repeated=True))
