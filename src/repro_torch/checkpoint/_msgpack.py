"""The one msgpack shape a checkpoint holds: a map of ``str`` to ``bytes``.

``repro/checkpoint/ckpt.py`` writes ``msgpack.packb({path: raw bytes})``;
this module writes the same bytes without the ``msgpack`` package and
without building the payload in memory: ``write_map`` streams each key's
header and each leaf's bytes to the file.  The encodings are msgpack's
smallest for each length, as ``packb`` picks them:

  map  fixmap 0x80|n (n < 16), map16 0xde, map32 0xdf
  str  fixstr 0xa0|n (n < 32), str8 0xd9, str16 0xda, str32 0xdb
  bin  bin8 0xc4, bin16 0xc5, bin32 0xc6

lengths big-endian.  ``read_map`` parses such a map from one buffer and
returns each value as a zero-copy ``memoryview`` slice of it; any other
msgpack type raises ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Dict, Sequence, Tuple

_U8, _U16, _U32 = struct.Struct(">B"), struct.Struct(">H"), struct.Struct(">I")


def _header(n: int, fix: int, fix_limit: int, codes: Tuple[int, int, int],
            what: str) -> bytes:
    c8, c16, c32 = codes
    if fix_limit and n < fix_limit:
        return bytes([fix | n])
    if c8 is not None and n < 1 << 8:
        return bytes([c8]) + _U8.pack(n)
    if n < 1 << 16:
        return bytes([c16]) + _U16.pack(n)
    if n < 1 << 32:
        return bytes([c32]) + _U32.pack(n)
    raise ValueError(f"msgpack {what} of {n} entries/bytes does not fit 32 bits")


def map_header(n: int) -> bytes:
    return _header(n, 0x80, 16, (None, 0xde, 0xdf), "map")


def str_header(n: int) -> bytes:
    return _header(n, 0xa0, 32, (0xd9, 0xda, 0xdb), "str")


def bin_header(n: int) -> bytes:
    return _header(n, 0, 0, (0xc4, 0xc5, 0xc6), "bin")


def packed_size(entries: Sequence[Tuple[str, int]]) -> int:
    """Bytes of the map of ``(key, value length)`` entries."""
    total = len(map_header(len(entries)))
    for key, n in entries:
        k = key.encode()
        total += len(str_header(len(k))) + len(k) + len(bin_header(n)) + n
    return total


def write_map(f: BinaryIO, entries: Sequence[Tuple[str, memoryview]]) -> None:
    """Stream ``{key: value}`` (values: byte buffers) to ``f`` as
    ``msgpack.packb`` encodes it."""
    f.write(map_header(len(entries)))
    for key, value in entries:
        k = key.encode()
        v = memoryview(value).cast("B")
        for part in (str_header(len(k)), k, bin_header(v.nbytes), v):
            f.write(part)


def _length(buf: memoryview, pos: int, kind: str) -> Tuple[int, int]:
    """-> (length, position after the header) of the str / bin / map
    header at ``pos``."""
    b = buf[pos]
    tables = {
        "map": ((0x80, 0x8f), {0xde: _U16, 0xdf: _U32}),
        "str": ((0xa0, 0xbf), {0xd9: _U8, 0xda: _U16, 0xdb: _U32}),
        "bin": (None, {0xc4: _U8, 0xc5: _U16, 0xc6: _U32}),
    }
    fix, sized = tables[kind]
    if fix is not None and fix[0] <= b <= fix[1]:
        return b - fix[0], pos + 1
    if b in sized:
        s = sized[b]
        return s.unpack_from(buf, pos + 1)[0], pos + 1 + s.size
    raise ValueError(f"msgpack byte 0x{b:02x} at offset {pos} is not a {kind} "
                     "header: a checkpoint payload is a map of str to bytes")


def read_map(data) -> Dict[str, memoryview]:
    """Parse a msgpack map of str to bytes from ``data`` (any buffer);
    the values are zero-copy slices of it."""
    buf = memoryview(data).cast("B")
    n, pos = _length(buf, 0, "map")
    out: Dict[str, memoryview] = {}
    for _ in range(n):
        kn, pos = _length(buf, pos, "str")
        key = bytes(buf[pos:pos + kn]).decode()
        pos += kn
        vn, pos = _length(buf, pos, "bin")
        if pos + vn > buf.nbytes:
            raise ValueError(f"msgpack value of {key!r} runs past the end "
                             f"({pos + vn} > {buf.nbytes} bytes)")
        out[key] = buf[pos:pos + vn]
        pos += vn
    if pos != buf.nbytes:
        raise ValueError(f"{buf.nbytes - pos} bytes after the msgpack map")
    return out
