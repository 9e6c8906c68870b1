"""Minimal deterministic protobuf wire-format writer.

The consensus-critical byte strings (vote/proposal sign bytes, canonical
block IDs) are protobuf messages whose encoding must be byte-exact
(reference: types/canonical.go + gogoproto marshaling). Rather than depend
on a codegen toolchain, the handful of message shapes involved are encoded
directly with these primitives, following proto3 + gogoproto rules:

* fields appear in ascending field-number order;
* scalar fields equal to their zero value are omitted;
* non-nullable embedded messages (gogoproto.nullable=false) are ALWAYS
  emitted, even when empty;
* sfixed64 for canonical height/round (fixed-width: canonicalization
  requires size-independent encoding — proto/tendermint/types/canonical.proto).

Also the uvarint length-delimited framing of protoio.MarshalDelimited
(libs/protoio/writer.go) used for all sign bytes, and its reader
(``read_delimited``) for the ABCI frames.
"""

from __future__ import annotations

# Wire types
VARINT = 0
FIXED64 = 1
BYTES = 2
FIXED32 = 5

# Unix-epoch offset of time.Time's zero value (year 1, UTC) in seconds;
# gogoproto stdtime encodes Go's zero time as this many seconds.
ZERO_TIME_SECONDS = -62135596800
ZERO_TIME_NS = ZERO_TIME_SECONDS * 1_000_000_000


def uvarint(n: int) -> bytes:
    if n < 0:
        raise ValueError("uvarint requires n >= 0")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint(n: int) -> bytes:
    """Signed int64 as protobuf varint (two's complement, 10 bytes if <0)."""
    return uvarint(n & 0xFFFFFFFFFFFFFFFF)


def tag(field: int, wire: int) -> bytes:
    return uvarint(field << 3 | wire)


def field_varint(field: int, value: int, emit_zero: bool = False) -> bytes:
    if value == 0 and not emit_zero:
        return b""
    return tag(field, VARINT) + varint(value)


def field_sfixed64(field: int, value: int, emit_zero: bool = False) -> bytes:
    if value == 0 and not emit_zero:
        return b""
    return tag(field, FIXED64) + (value & 0xFFFFFFFFFFFFFFFF).to_bytes(
        8, "little"
    )


def field_bytes(field: int, value: bytes, emit_empty: bool = False) -> bytes:
    if not value and not emit_empty:
        return b""
    return tag(field, BYTES) + uvarint(len(value)) + value


def field_string(field: int, value: str, emit_empty: bool = False) -> bytes:
    return field_bytes(field, value.encode(), emit_empty)


def field_message(field: int, encoded: bytes, always: bool = False) -> bytes:
    """Embedded message; ``always=True`` = gogoproto nullable=false."""
    if not encoded and not always:
        return b""
    return tag(field, BYTES) + uvarint(len(encoded)) + encoded


def timestamp(ns: int) -> bytes:
    """google.protobuf.Timestamp message body from ns since Unix epoch."""
    seconds, nanos = divmod(ns, 1_000_000_000)
    return field_varint(1, seconds) + field_varint(2, nanos)


def delimited(msg: bytes) -> bytes:
    """protoio.MarshalDelimited framing: uvarint byte-length prefix."""
    return uvarint(len(msg)) + msg


def read_delimited(read_exact, max_bytes: int) -> bytes:
    """Read one uvarint-length-prefixed frame through ``read_exact(n)``,
    which returns exactly n bytes or raises (EOFError on a closed
    stream): protoio.Reader with a hard size cap."""
    length = 0
    shift = 0
    while True:
        b = read_exact(1)
        length |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            break
        shift += 7
        if shift > 35:
            raise ValueError("frame length uvarint overflow")
    if length > max_bytes:
        raise ValueError(f"frame of {length} bytes exceeds limit")
    return read_exact(length)
