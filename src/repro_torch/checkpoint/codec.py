"""The checkpoint manifest's codec: a small msgpack encoder and decoder and
the reference's framing (``repro.checkpoint.ckpt``), so that the port needs
no ``msgpack`` module.

``packb`` gives the bytes of ``msgpack.packb(x)`` (msgpack's defaults:
``use_bin_type=True``, float64, the smallest encoding of every int) for what
a manifest holds: None, bool, int of every width, float, str, bytes, list /
tuple and dict. ``unpackb`` reads what ``msgpack.unpackb`` reads with its
defaults (str decoded as UTF-8, arrays as lists, map keys str or bytes); ext
types raise ``ValueError``.

Framing: one codec byte, then the compressed blob: 0x01 zstd, 0x02 zlib;
0x28 is the first byte of a bare zstd frame (manifests from before the
framing). zlib is written where ``zstandard`` cannot be imported; a zstd
manifest then raises the reference's ``ImportError``.
"""
from __future__ import annotations

import struct
import zlib

try:
    import zstandard
except ImportError:          # the stdlib fallback, as in the reference
    zstandard = None

CODEC_ZSTD = 0x01
CODEC_ZLIB = 0x02
_ZSTD_MAGIC = 0x28


# ------------------------------------------------------------------- packing


def _sized(n: int, fix_base: int | None, fix_max: int, codes: tuple[int, ...]) -> bytes:
    """The header of a str, bin, array or map of length ``n``: the fix form
    up to ``fix_max`` (where the family has one), then 8-, 16- or 32-bit
    lengths (``codes`` the family's header bytes from the smallest length
    field up; array and map have no 8-bit one)."""
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    widths = ((0xff, ">B"), (0xffff, ">H"), (0xffffffff, ">I"))[3 - len(codes):]
    for code, (limit, fmt) in zip(codes, widths):
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} is over msgpack's 32-bit limit")


def _int(x: int) -> bytes:
    if 0 <= x <= 0x7f:
        return bytes([x])
    if -0x20 <= x < 0:
        return struct.pack(">b", x)
    if x > 0:
        for code, fmt, limit in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                                 (0xce, ">I", 0xffffffff), (0xcf, ">Q", 0xffffffffffffffff)):
            if x <= limit:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, limit in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                                 (0xd2, ">i", -0x80000000), (0xd3, ">q", -0x8000000000000000)):
            if x >= limit:
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError("Integer value out of range")


def _pack(x, out: list[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out += [_sized(len(raw), 0xa0, 0x1f, (0xd9, 0xda, 0xdb)), raw]
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        out += [_sized(len(raw), None, -1, (0xc4, 0xc5, 0xc6)), raw]
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), 0x90, 0x0f, (0xdc, 0xdd)))
        for item in x:
            _pack(item, out)
    elif isinstance(x, dict):
        out.append(_sized(len(x), 0x80, 0x0f, (0xde, 0xdf)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def packb(x) -> bytes:
    out: list[bytes] = []
    _pack(x, out)
    return b"".join(out)


# ----------------------------------------------------------------- unpacking

# header byte -> (struct format of the fixed-width value or length, kind)
_FIXED = {0xca: (">f", "float"), 0xcb: (">d", "float"),
          0xcc: (">B", "int"), 0xcd: (">H", "int"), 0xce: (">I", "int"), 0xcf: (">Q", "int"),
          0xd0: (">b", "int"), 0xd1: (">h", "int"), 0xd2: (">i", "int"), 0xd3: (">q", "int"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.body("map", b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.body("array", b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.body("str", b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b not in _FIXED:
            raise ValueError(f"msgpack type byte {b:#x} is not read here (ext or reserved)")
        fmt, kind = _FIXED[b]
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v if kind in ("int", "float") else self.body(kind, v)

    def body(self, kind: str, n: int):
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for map key")
            out[k] = self.value()
        return out


def unpackb(data: bytes):
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("extra data after the msgpack object")
    return out


# ------------------------------------------------------------------- framing


def compress_manifest(payload: bytes) -> bytes:
    if zstandard is not None:
        return bytes([CODEC_ZSTD]) + zstandard.ZstdCompressor().compress(payload)
    return bytes([CODEC_ZLIB]) + zlib.compress(payload, level=6)


def decompress_manifest(blob: bytes) -> bytes:
    if not blob:
        raise ValueError("empty checkpoint manifest")
    codec, body = blob[0], blob[1:]
    if codec == CODEC_ZLIB:
        return zlib.decompress(body)
    if codec in (CODEC_ZSTD, _ZSTD_MAGIC):
        if zstandard is None:
            raise ImportError(
                "checkpoint manifest is zstd-compressed but the 'zstandard' "
                "module is not installed; reinstall it or re-save the "
                "checkpoint on a machine with zstandard available"
            )
        return zstandard.ZstdDecompressor().decompress(blob if codec == _ZSTD_MAGIC else body)
    raise ValueError(f"unknown checkpoint manifest codec byte {codec:#x}")
