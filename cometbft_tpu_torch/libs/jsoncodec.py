"""Tagged-JSON codec for persisting/transporting framework types.

The reference serializes everything with generated protobuf
(proto/tendermint/*, 34k LoC). This framework keeps consensus-critical
byte strings hand-encoded (types/proto.py — those must be byte-exact) and
uses this self-describing JSON codec for storage records and non-canonical
wire payloads, where only round-trip fidelity matters.

Encoding rules: dataclasses carry a ``__t`` class tag; bytes are hex under
``__b``; IntEnums are ints (re-coerced from the declared field type on
decode); adapters cover non-dataclass types (key objects, ValidatorSet).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from enum import IntEnum
from typing import Any, Callable


class Codec:
    def __init__(self) -> None:
        self._types: dict[str, type] = {}
        self._hints: dict[type, dict[str, Any]] = {}
        # cls -> (tag, enc, dec); tag -> (cls, enc, dec)
        self._adapters_by_cls: dict[type, tuple[str, Callable, Callable]] = {}
        self._adapters_by_tag: dict[str, tuple[type, Callable, Callable]] = {}

    def register(self, *classes: type) -> None:
        for cls in classes:
            if not dataclasses.is_dataclass(cls):
                raise TypeError(f"{cls.__name__} is not a dataclass")
            self._types[cls.__name__] = cls

    def register_adapter(
        self,
        cls: type,
        tag: str,
        enc: Callable[[Any], Any],
        dec: Callable[[Any], Any],
    ) -> None:
        """enc(obj) -> jsonable payload; dec(payload) -> obj."""
        self._adapters_by_cls[cls] = (tag, enc, dec)
        self._adapters_by_tag[tag] = (cls, enc, dec)

    # -- encode ------------------------------------------------------------

    def encode(self, v: Any) -> Any:
        adapter = self._adapters_by_cls.get(type(v))
        if adapter is not None:
            tag, enc, _ = adapter
            return {"__a": tag, "v": self.encode(enc(v))}
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            name = type(v).__name__
            if name not in self._types:
                raise TypeError(f"unregistered dataclass {name}")
            d: dict[str, Any] = {"__t": name}
            for f in dataclasses.fields(v):
                # Underscore fields are in-memory caches (e.g. Commit._hash)
                # — serializing them breaks canonical byte equality.
                if f.name.startswith("_"):
                    continue
                d[f.name] = self.encode(getattr(v, f.name))
            return d
        if isinstance(v, bytes):
            return {"__b": v.hex()}
        if isinstance(v, bool) or v is None:
            return v
        if isinstance(v, IntEnum):
            return int(v)
        if isinstance(v, (int, float, str)):
            return v
        if isinstance(v, (list, tuple)):
            return [self.encode(x) for x in v]
        if isinstance(v, dict):
            return {"__d": [[self.encode(k), self.encode(x)] for k, x in v.items()]}
        raise TypeError(f"cannot encode {type(v).__name__}")

    # -- decode ------------------------------------------------------------

    def _field_hints(self, cls: type) -> dict[str, Any]:
        if cls not in self._hints:
            try:
                self._hints[cls] = typing.get_type_hints(cls)
            except Exception:
                self._hints[cls] = {}
        return self._hints[cls]

    def decode(self, v: Any, hint: Any = None) -> Any:
        if isinstance(v, dict):
            if "__a" in v:
                _, _, dec = self._adapters_by_tag[v["__a"]]
                return dec(self.decode(v["v"]))
            if "__b" in v:
                return bytes.fromhex(v["__b"])
            if "__d" in v:
                return {
                    self.decode(k): self.decode(x) for k, x in v["__d"]
                }
            if "__t" in v:
                cls = self._types[v["__t"]]
                hints = self._field_hints(cls)
                kwargs = {
                    k: self.decode(x, hints.get(k))
                    for k, x in v.items()
                    if k != "__t"
                }
                return cls(**kwargs)
            raise ValueError(f"unknown tagged object: {list(v)}")
        if isinstance(v, list):
            out = [self.decode(x) for x in v]
            if typing.get_origin(hint) is tuple:
                return tuple(out)
            return out
        if (
            isinstance(v, int)
            and not isinstance(v, bool)
            and isinstance(hint, type)
            and issubclass(hint, IntEnum)
        ):
            return hint(v)
        return v

    # -- bytes round-trip --------------------------------------------------

    def dumps(self, obj: Any) -> bytes:
        return json.dumps(self.encode(obj), separators=(",", ":")).encode()

    def loads(self, data: bytes) -> Any:
        return self.decode(json.loads(data))
