"""Kubelet's device-plugin API, v1beta1.

`messages` holds plain dataclasses with the proto's message and field
names, which the plugin speaks and which need no protobuf;
`deviceplugin_pb2` is the generated module, a byte-identical copy of the
JAX package's (identical bytes register the same descriptors in
protobuf's default pool, so both packages load in one process). Only the
gRPC binding (`deviceplugin/base.py`) imports it.
"""
