"""NRI and ttrpc messages with their proto3 wire format, without protobuf.

The card machine has no `protobuf`, and the NRI runtime hook speaks
protobuf bytes over its socket. This module is the port's counterpart of
the JAX package's generated `api/nri_pb2.py` and `api/ttrpc_pb2.py`: each
message is a dataclass with the proto's field names (upstream
containerd/nri v0.12 `pkg/api/api.proto` and containerd/ttrpc
`request.proto`, the subset the JAX package declares), and `encode()` /
`decode()` give and read the proto3 wire format:

- varint scalars (int32, int64, bool), written only when not zero, a
  negative int as its 64-bit two's complement;
- length-delimited strings, bytes and sub-messages; a sub-message field is
  None when absent and written when set, even empty;
- repeated fields one record per element; a map<string, string> as
  repeated entry messages (key = 1, value = 2);
- decoding skips fields it does not name (containerd sends fields this
  subset leaves out) and merges a sub-message that appears twice.

ttrpc's KeyValue has the same shape as NRI's, so one class serves both.
"""

from __future__ import annotations

from dataclasses import dataclass, field, make_dataclass
from typing import Any, ClassVar

_DEFAULTS = {"string": str, "bytes": bytes, "int32": int, "int64": int,
             "bool": bool}
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class Field:
    """One field: `kind` is string, bytes, int32, int64, bool, message or
    map (map<string, string>)."""
    name: str
    number: int
    kind: str
    repeated: bool = False
    message: type | None = None

    def default(self) -> Any:
        if self.kind == "map":
            return {}
        if self.repeated:
            return []
        if self.kind == "message":
            return None
        return _DEFAULTS[self.kind]()

    @property
    def wire_type(self) -> int:
        return _VARINT if self.kind in ("int32", "int64", "bool") else _LEN


def _varint(value: int) -> bytes:
    value &= _MASK64
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(data) or shift > 63:
            raise ValueError("truncated or overlong varint")
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _record(number: int, wire_type: int, payload: bytes) -> bytes:
    head = _varint(number << 3 | wire_type)
    if wire_type == _LEN:
        return head + _varint(len(payload)) + payload
    return head + payload


def _scalar(kind: str, value) -> bytes:
    if kind == "string":
        return value.encode()
    if kind == "bytes":
        return bytes(value)
    return _varint(int(value))


def _signed(value: int, bits: int) -> int:
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def _from_wire(kind: str, raw):
    if kind == "string":
        return bytes(raw).decode()
    if kind == "bytes":
        return bytes(raw)
    if kind == "bool":
        return raw != 0
    return _signed(raw, 32 if kind == "int32" else 64)


class Message:
    """The codec. A subclass is a dataclass whose FIELDS name its fields."""
    FIELDS: ClassVar[tuple[Field, ...]] = ()

    def encode(self) -> bytes:
        out = bytearray()
        for f in self.FIELDS:
            value = getattr(self, f.name)
            if f.kind == "map":
                for k, v in value.items():
                    entry = (_record(1, _LEN, k.encode())
                             + _record(2, _LEN, v.encode()))
                    out += _record(f.number, _LEN, entry)
            elif f.kind == "message":
                for item in (value if f.repeated else
                             [] if value is None else [value]):
                    out += _record(f.number, _LEN, item.encode())
            elif f.repeated:
                for item in value:
                    out += _record(f.number, f.wire_type,
                                   _scalar(f.kind, item))
            elif value:
                out += _record(f.number, f.wire_type, _scalar(f.kind, value))
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes):
        by_number = {f.number: f for f in cls.FIELDS}
        values = {f.name: f.default() for f in cls.FIELDS}
        nested: dict[str, bytearray] = {}
        pos = 0
        while pos < len(data):
            key, pos = _read_varint(data, pos)
            number, wire_type = key >> 3, key & 7
            if wire_type == _VARINT:
                raw, pos = _read_varint(data, pos)
            elif wire_type == _LEN:
                size, pos = _read_varint(data, pos)
                if pos + size > len(data):
                    raise ValueError("truncated length-delimited field")
                raw, pos = data[pos:pos + size], pos + size
            elif wire_type in (_I64, _I32):
                pos += 8 if wire_type == _I64 else 4
                if pos > len(data):
                    raise ValueError("truncated fixed-width field")
                continue        # no field of this subset is fixed-width
            else:
                raise ValueError(f"unsupported wire type {wire_type}")
            f = by_number.get(number)
            if f is None or f.wire_type != wire_type:
                continue        # a field this subset does not name
            if f.kind == "map":
                entry = _MapEntry.decode(raw)
                values[f.name][entry.key] = entry.value
            elif f.kind == "message" and f.repeated:
                values[f.name].append(f.message.decode(raw))
            elif f.kind == "message":
                nested.setdefault(f.name, bytearray()).extend(raw)
            elif f.repeated:
                values[f.name].append(_from_wire(f.kind, raw))
            else:
                values[f.name] = _from_wire(f.kind, raw)
        for name, raw in nested.items():
            values[name] = next(f for f in cls.FIELDS
                                if f.name == name).message.decode(bytes(raw))
        return cls(**values)


def _message(name: str, *fields: Field) -> type:
    cls = make_dataclass(
        name, [(f.name, Any, field(default_factory=f.default))
               for f in fields],
        bases=(Message,), namespace={"__module__": __name__})
    cls.FIELDS = tuple(sorted(fields, key=lambda f: f.number))
    return cls


def _s(name, number, repeated=False):
    return Field(name, number, "string", repeated)


def _m(name, number, message, repeated=False):
    return Field(name, number, "message", repeated, message)


_MapEntry = _message("_MapEntry", _s("key", 1), _s("value", 2))

# -- NRI (nri.pkg.api.v1alpha1) --------------------------------------------------

RegisterPluginRequest = _message("RegisterPluginRequest", _s("plugin_name", 1),
                                 _s("plugin_idx", 2))
Empty = _message("Empty")
ConfigureRequest = _message(
    "ConfigureRequest", _s("config", 1), _s("runtime_name", 2),
    _s("runtime_version", 3), Field("registration_timeout", 4, "int64"),
    Field("request_timeout", 5, "int64"))
ConfigureResponse = _message("ConfigureResponse",
                             Field("events", 1, "int32"))
Mount = _message("Mount", _s("destination", 1), _s("type", 2),
                 _s("source", 3), _s("options", 4, repeated=True))
KeyValue = _message("KeyValue", _s("key", 1), _s("value", 2))
PodSandbox = _message(
    "PodSandbox", _s("id", 1), _s("name", 2), _s("uid", 3),
    _s("namespace", 4), Field("labels", 5, "map"),
    Field("annotations", 6, "map"))
Container = _message(
    "Container", _s("id", 1), _s("pod_sandbox_id", 2), _s("name", 3),
    Field("state", 4, "int32"), Field("labels", 5, "map"),
    Field("annotations", 6, "map"), _s("args", 7, repeated=True),
    _s("env", 8, repeated=True), _m("mounts", 9, Mount, repeated=True))
CreateContainerRequest = _message("CreateContainerRequest",
                                  _m("pod", 1, PodSandbox),
                                  _m("container", 2, Container))
# upstream ContainerAdjustment has no field 1
ContainerAdjustment = _message(
    "ContainerAdjustment", Field("annotations", 2, "map"),
    _m("mounts", 3, Mount, repeated=True),
    _m("env", 4, KeyValue, repeated=True))
ContainerUpdate = _message("ContainerUpdate", _s("container_id", 1))
CreateContainerResponse = _message(
    "CreateContainerResponse", _m("adjust", 1, ContainerAdjustment),
    _m("update", 2, ContainerUpdate, repeated=True),
    _m("evict", 3, ContainerUpdate, repeated=True))
SynchronizeRequest = _message(
    "SynchronizeRequest", _m("pods", 1, PodSandbox, repeated=True),
    _m("containers", 2, Container, repeated=True), Field("more", 3, "bool"))
SynchronizeResponse = _message(
    "SynchronizeResponse", _m("update", 1, ContainerUpdate, repeated=True),
    Field("more", 2, "bool"))
StateChangeEvent = _message("StateChangeEvent", Field("event", 1, "int32"),
                            _m("pod", 2, PodSandbox),
                            _m("container", 3, Container))
StopContainerRequest = _message("StopContainerRequest",
                                _m("pod", 1, PodSandbox),
                                _m("container", 2, Container))
StopContainerResponse = _message(
    "StopContainerResponse", _m("update", 1, ContainerUpdate, repeated=True))

NRI_MESSAGES = (RegisterPluginRequest, Empty, ConfigureRequest,
                ConfigureResponse, Mount, KeyValue, PodSandbox, Container,
                CreateContainerRequest, ContainerAdjustment, ContainerUpdate,
                CreateContainerResponse, SynchronizeRequest,
                SynchronizeResponse, StateChangeEvent, StopContainerRequest,
                StopContainerResponse)

# -- ttrpc (the envelope every NRI message rides in) -----------------------------

Request = _message(
    "Request", _s("service", 1), _s("method", 2), Field("payload", 3, "bytes"),
    Field("timeout_nano", 4, "int64"),
    _m("metadata", 5, KeyValue, repeated=True))
Status = _message("Status", Field("code", 1, "int32"), _s("message", 2))
Response = _message("Response", _m("status", 1, Status),
                    Field("payload", 2, "bytes"))

TTRPC_MESSAGES = (KeyValue, Request, Status, Response)
