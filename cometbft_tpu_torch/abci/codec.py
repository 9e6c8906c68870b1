"""Wire codec for the ABCI socket protocol.

The reference frames length-prefixed protobuf ``Request``/``Response``
oneofs over a unix/tcp socket (abci/client/socket_client.go,
abci/server/socket_server.go). Here the framing is identical (uvarint
length prefix, libs/protoio) but the payload is self-describing JSON:
dataclasses carry a ``__t`` type tag, bytes are hex-tagged. The codec is
an internal boundary between this framework's node and app processes —
swapping in a protobuf payload for Go-app interop only touches this module.
"""

from __future__ import annotations

import dataclasses
import json
from enum import IntEnum

from ..types import proto
from . import types as abci

# Registry of every dataclass the protocol can carry, by class name.
# RequestInitChain/ResponseFinalizeBlock embed the consensus-params types.
from ..types import params as _params  # noqa: E402

_TYPES = {
    name: obj
    for mod in (abci, _params)
    for name, obj in vars(mod).items()
    if dataclasses.is_dataclass(obj)
}


def _to_jsonable(v):
    """Tagged-JSON encoding of registered dataclasses. Shared by every
    process-boundary codec (ABCI socket/gRPC, privval socket)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        d = {"__t": type(v).__name__}
        for f in dataclasses.fields(v):
            d[f.name] = _to_jsonable(getattr(v, f.name))
        return d
    if isinstance(v, bytes):
        return {"__b": v.hex()}
    if isinstance(v, IntEnum):
        return int(v)
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    raise TypeError(f"cannot encode {type(v).__name__} over ABCI socket")


def _from_jsonable(v, types=None):
    """Inverse of :func:`_to_jsonable` against a type registry
    (defaults to the ABCI message set)."""
    if types is None:
        types = _TYPES
    if isinstance(v, dict):
        if "__b" in v:
            return bytes.fromhex(v["__b"])
        if "__t" in v:
            cls = types[v["__t"]]
            kwargs = {
                k: _from_jsonable(x, types) for k, x in v.items() if k != "__t"
            }
            obj = cls(**kwargs)
            # Restore enum types declared on the dataclass.
            for f in dataclasses.fields(cls):
                cur = getattr(obj, f.name)
                if isinstance(f.type, str) and isinstance(cur, int):
                    enum_cls = getattr(abci, f.type, None)
                    if isinstance(enum_cls, type) and issubclass(
                        enum_cls, IntEnum
                    ):
                        setattr(obj, f.name, enum_cls(cur))
            return obj
        raise ValueError(f"unknown tagged value {v.keys()}")
    if isinstance(v, list):
        return [_from_jsonable(x, types) for x in v]
    return v


def encode_frame(method: str, msg) -> bytes:
    """One protocol frame: uvarint length + JSON {method, msg}."""
    payload = json.dumps(
        {"method": method, "msg": _to_jsonable(msg)}, separators=(",", ":")
    ).encode()
    return proto.delimited(payload)


# Frames beyond this are protocol corruption or abuse, not real traffic
# (the reference caps reads the same way — libs/protoio reader limit).
MAX_FRAME_BYTES = 64 * 1024 * 1024


def read_frame(sock_file) -> tuple[str, object] | None:
    """Read one frame from a file-like socket; None on clean EOF."""
    first = sock_file.read(1)
    if not first:
        return None  # clean EOF between frames
    buffered = [first]

    def read_exact(n: int) -> bytes:
        out = buffered.pop() if (buffered and n) else b""
        while len(out) < n:
            chunk = sock_file.read(n - len(out))
            if not chunk:
                raise EOFError("truncated ABCI frame")
            out += chunk
        return out

    payload = proto.read_delimited(read_exact, MAX_FRAME_BYTES)
    obj = json.loads(payload)
    return obj["method"], _from_jsonable(obj["msg"])
