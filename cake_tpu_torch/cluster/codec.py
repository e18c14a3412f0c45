"""A pure-Python MessagePack encoder and decoder for the subset the
cluster protocol uses (cluster/proto.py), so the port needs no `msgpack`
package: nil, bool, int, float64, str, bin, array and map.

`packb(obj)` gives the bytes of `msgpack.packb(obj, use_bin_type=True)`:
every int in its smallest encoding (positive fixint, uint8-64 above 127,
negative fixint, int8-64 below -32), a Python float as float64, str as
UTF-8 in fixstr / str8 / str16 / str32, bytes as bin8 / bin16 / bin32,
lists and tuples as arrays and dicts as maps in their insertion order.
`unpackb(data)` reads the same subset (and float32) back as
`msgpack.unpackb(data, raw=False)` does: str to str, bin to bytes,
arrays to lists. Anything else (ext types, other Python objects)
raises ValueError rather than being guessed at.
"""
from __future__ import annotations

import struct

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


def _int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(_B.pack(n))
    elif n >= 0:
        if n <= 0xFF:
            out.append(b"\xcc" + _B.pack(n))
        elif n <= 0xFFFF:
            out.append(b"\xcd" + _H.pack(n))
        elif n <= 0xFFFFFFFF:
            out.append(b"\xce" + _I.pack(n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _Q.pack(n))
        else:
            raise ValueError(f"int {n} does not fit msgpack")
    elif n >= -32:
        out.append(_B.pack(n & 0xFF))
    elif n >= -0x80:
        out.append(b"\xd0" + _b.pack(n))
    elif n >= -0x8000:
        out.append(b"\xd1" + _h.pack(n))
    elif n >= -0x80000000:
        out.append(b"\xd2" + _i.pack(n))
    elif n >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(n))
    else:
        raise ValueError(f"int {n} does not fit msgpack")


def _len(n: int, fix: int | None, fix_max: int, codes: tuple,
         out: list) -> None:
    """A length header: fix | n below fix_max, else the 8/16/32-bit form
    (codes[0] None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(_B.pack(fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(codes[0] + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(codes[1] + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(codes[2] + _I.pack(n))
    else:
        raise ValueError(f"length {n} does not fit msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + _d.pack(obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _len(len(data), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _len(len(data), None, 0, (b"\xc4", b"\xc5", b"\xc6"), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _len(len(obj), 0x90, 16, (None, b"\xdc", b"\xdd"), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _len(len(obj), 0x80, 16, (None, b"\xde", b"\xdf"), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, int):          # bool is handled above
        _int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(float(obj)))
    else:
        raise ValueError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def obj(self):
        c = self.unpack(_B)
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self._str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b, 0xD1: _h,
                0xD2: _i, 0xD3: _q, 0xCA: _f, 0xCB: _d}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xC4: _B, 0xC5: _H, 0xC6: _I, 0xD9: _B, 0xDA: _H, 0xDB: _I,
                0xDC: _H, 0xDD: _I, 0xDE: _H, 0xDF: _I}
        if c not in lens:
            raise ValueError(f"msgpack type 0x{c:02x} is not taken")
        n = self.unpack(lens[c])
        if c <= 0xC6:
            return bytes(self.take(n))
        if c <= 0xDB:
            return self._str(n)
        if c <= 0xDD:
            return [self.obj() for _ in range(n)]
        return self._map(n)

    def _str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if isinstance(k, list):
                raise ValueError("msgpack map key is an array")
            out[k] = self.obj()
        return out


def unpackb(data) -> object:
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.mv):
        raise ValueError(f"extra data after msgpack object "
                         f"({len(r.mv) - r.pos} bytes)")
    return obj
