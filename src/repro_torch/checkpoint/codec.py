"""The subset of MessagePack that checkpoints use: maps, str, bin, int
and arrays of these. ``packb`` gives the bytes ``msgpack.packb`` gives
for such an object (smallest encoding of each value; str as str, bytes
as bin), so the port needs no msgpack package.
"""
from __future__ import annotations

import struct
from typing import Any, Iterator, List, Tuple, Union

Buffer = Union[bytes, bytearray, memoryview]


def _head(n: int, fix: Tuple[int, int], wide: List[Tuple[int, int, str]]
          ) -> bytes:
    """The header of a length-``n`` container: a fix form (base, limit)
    or the first wide form (limit, code, struct format) that fits."""
    base, limit = fix
    if n < limit:
        return bytes([base | n])
    for lim, code, fmt in wide:
        if n < lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for lim, code, fmt in ((1 << 8, 0xcc, ">B"), (1 << 16, 0xcd, ">H"),
                               (1 << 32, 0xce, ">I"), (1 << 64, 0xcf, ">Q")):
            if n < lim:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for lim, code, fmt in ((1 << 7, 0xd0, ">b"), (1 << 15, 0xd1, ">h"),
                               (1 << 31, 0xd2, ">i"), (1 << 63, 0xd3, ">q")):
            if n >= -lim:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} out of msgpack range")



def pack_chunks(obj: Any) -> Iterator[Buffer]:
    """The encoding of ``obj`` as a sequence of byte chunks; a bin's
    payload is yielded as it is, never copied."""
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"not in the checkpoint subset: {obj!r}")
    if isinstance(obj, int):
        yield _int(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        yield _head(len(b), (0xa0, 32),
                    [(1 << 8, 0xd9, ">B"), (1 << 16, 0xda, ">H"),
                     (1 << 32, 0xdb, ">I")])
        yield b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        yield _head(n, (0, 0), [(1 << 8, 0xc4, ">B"), (1 << 16, 0xc5, ">H"),
                                (1 << 32, 0xc6, ">I")])
        yield obj
    elif isinstance(obj, (list, tuple)):
        yield _head(len(obj), (0x90, 16),
                    [(1 << 16, 0xdc, ">H"), (1 << 32, 0xdd, ">I")])
        for v in obj:
            yield from pack_chunks(v)
    elif isinstance(obj, dict):
        yield _head(len(obj), (0x80, 16),
                    [(1 << 16, 0xde, ">H"), (1 << 32, 0xdf, ">I")])
        for k, v in obj.items():
            yield from pack_chunks(k)
            yield from pack_chunks(v)
    else:
        raise TypeError(f"not in the checkpoint subset: {type(obj)}")


def packb(obj: Any) -> bytes:
    return b"".join(bytes(c) for c in pack_chunks(obj))


class _Reader:
    def __init__(self, buf: Buffer) -> None:
        self.mv = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        c = self.num(">B")
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c < 0x90:
            return self.map(c & 0x0f)
        if 0x90 <= c < 0xa0:
            return [self.obj() for _ in range(c & 0x0f)]
        if 0xa0 <= c < 0xc0:
            return str(self.take(c & 0x1f), "utf-8")
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if c in ints:
            return self.num(ints[c])
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
                0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}
        if c not in lens:
            raise ValueError(f"msgpack type 0x{c:02x} is not in the "
                             "checkpoint subset")
        n = self.num(lens[c])
        if c <= 0xc6:
            return self.take(n)            # bin: a view into the buffer
        if c <= 0xdb:
            return str(self.take(n), "utf-8")
        if c <= 0xdd:
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(buf: Buffer) -> Any:
    """Decode one object. A bin comes back as a ``memoryview`` into
    ``buf`` (writable when ``buf`` is a bytearray), not a copy."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.mv):
        raise ValueError("trailing bytes after msgpack object")
    return out
