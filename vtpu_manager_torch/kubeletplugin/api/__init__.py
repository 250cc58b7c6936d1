"""Kubelet's DRA plugin API (v1beta1) and plugin-registration API.

`messages` holds plain dataclasses with the protos' message and field
names, which the driver speaks and which need no protobuf; `dra_pb2` and
`pluginregistration_pb2` are the generated modules, byte-identical copies
of the JAX package's (identical bytes register the same descriptors in
protobuf's default pool, so both packages load in one process). Only the
gRPC side (`kubeletplugin/driver.py`, `registration.py`, when serving)
imports them.
"""
