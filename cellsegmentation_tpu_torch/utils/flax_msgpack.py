"""Flax's msgpack checkpoint format, read and written without ``msgpack``.

The JAX package writes its checkpoints with
``flax.serialization.msgpack_serialize``: plain msgpack of nested dicts
whose keys are sorted (the tree map it runs first rebuilds every dict in
key order), with three extension types:

- ext 1, an ndarray: the msgpack of ``(shape, dtype name, C-order bytes)``;
- ext 2, a Python complex: the msgpack of ``(real, imag)``;
- ext 3, a numpy scalar: an ext-1 payload of its 0-d array.

An array of more than ``MAX_CHUNK_SIZE`` bytes is written as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
"chunks": {"0": flat chunk, ...}}``, which ``unpackb`` joins again.

``unpackb`` decodes this subset to dicts, lists, Python scalars, bytes,
numpy arrays (views into the buffer, read-only) and numpy scalars;
``bfloat16``, which numpy lacks, comes back as a ``torch.bfloat16`` tensor
(its bits through a ``uint16`` view). Any other byte, a truncated buffer or
trailing bytes raise ``ValueError``: nothing is read "as far as it goes".
``packb`` writes the same subset, byte for byte as ``msgpack_serialize``
would, from dicts (string keys), lists, ``None``, bools, ints, floats,
complex, str, bytes, numpy arrays and scalars and torch tensors.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization's
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack data truncated: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        at = self.pos
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _STR:
            return self.str(self.unpack(_STR[b]))
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _ARRAY:
            return [self.obj() for _ in range(self.unpack(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.unpack(_MAP[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise ValueError(f"msgpack byte 0x{b:02x} at offset {at} is outside "
                         "the subset flax writes")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if out.get(CHUNKED) is True:
            return _unchunk(out)
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
        if code == _EXT_COMPLEX:
            re, im = _whole(data)
            return complex(re, im)
        raise ValueError(f"msgpack extension type {code} is outside the subset "
                         "flax writes")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _whole(data):
    """One msgpack object that fills ``data`` exactly."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return out


def _ndarray(data):
    """An ext-1 payload: a view of its bytes (no copy) as an array of its
    shape."""
    r = _Reader(data)
    if r.unpack("B") != 0x93:
        raise ValueError("an ndarray extension is not (shape, dtype name, bytes)")
    shape, name, b = r.obj(), r.obj(), r.unpack("B")
    if not (isinstance(shape, list) and isinstance(name, str) and b in _BIN):
        raise ValueError("an ndarray extension is not (shape, dtype name, bytes)")
    raw = r.take(r.unpack(_BIN[b]))
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes in an ndarray extension")
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    if set(d) != {CHUNKED, "shape", "chunks"}:
        raise ValueError(f"a chunked array's map holds {sorted(d)}")
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if any(torch.is_tensor(c) for c in chunks):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpackb(data) -> object:
    """The object flax's msgpack in ``data`` (bytes or a buffer) encodes."""
    return _whole(data)


# -- writing -----------------------------------------------------------------


def _head(n: int, fix: int, fix_max: int, wide: tuple) -> bytes:
    """The header of a str / bin / array / map / ext of length ``n``: the
    fix form up to ``fix_max``, else the narrowest of ``wide``'s
    (code, struct format, limit) forms."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, limit in wide:
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack object of length {n} is too long")


_W8, _W16, _W32 = 0xFF, 0xFFFF, 0xFFFFFFFF


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -0x20 <= v < 0:
        return bytes([v & 0xFF])
    if v > 0:
        for code, fmt, limit in ((0xCC, ">B", _W8), (0xCD, ">H", _W16),
                                 (0xCE, ">I", _W32), (0xCF, ">Q", 2**64 - 1)):
            if v <= limit:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                             (0xD2, ">i", -0x80000000), (0xD3, ">q", -2**63)):
        if v >= limit:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _str(s: str, out: list) -> None:
    b = s.encode("utf-8")
    out += [_head(len(b), 0xA0, 31, ((0xD9, ">B", _W8), (0xDA, ">H", _W16),
                                     (0xDB, ">I", _W32))), b]


def _bin_head(n: int) -> bytes:
    return _head(n, None, -1, ((0xC4, ">B", _W8), (0xC5, ">H", _W16), (0xC6, ">I", _W32)))


def _ext(code: int, parts: list, out: list) -> None:
    n = sum(len(p) for p in parts)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixed[n]]) if n in fixed else
            _head(n, None, -1, ((0xC7, ">B", _W8), (0xC8, ">H", _W16), (0xC9, ">I", _W32))))
    out += [head, struct.pack(">b", code), *parts]


def _array_parts(a) -> list:
    """The ext-1 payload of an array: (shape, dtype name, C-order bytes)."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            shape, name = tuple(a.shape), "bfloat16"
            raw = a.contiguous().view(torch.int16).numpy().tobytes()
        else:
            a = a.numpy()
    if isinstance(a, np.ndarray):
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise ValueError(f"arrays of dtype {a.dtype} have no msgpack form")
        shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    parts = [b"\x93", _head(len(shape), 0x90, 15, ((0xDC, ">H", _W16), (0xDD, ">I", _W32)))]
    parts += [_int(int(d)) for d in shape]
    _str(name, parts)
    return parts + [_bin_head(len(raw)), raw]


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if torch.is_tensor(a) else a.nbytes


def _chunked(a, chunk_size: int) -> dict:
    """flax's chunked form of an oversized array."""
    itemsize = a.element_size() if torch.is_tensor(a) else a.dtype.itemsize
    n = max(1, int(chunk_size / itemsize))
    flat = a.reshape(-1)
    size = flat.numel() if torch.is_tensor(flat) else flat.size
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(j): flat[i:i + n] for j, i in enumerate(range(0, size, n))}}


def _pack(obj, out: list, chunk_size: int, chunk: bool) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is complex:
        _ext(_EXT_COMPLEX, [b"\x92\xcb" + struct.pack(">d", obj.real)
                            + b"\xcb" + struct.pack(">d", obj.imag)], out)
    elif type(obj) is str:
        _str(obj, out)
    elif type(obj) is bytes:
        out += [_bin_head(len(obj)), obj]
    elif type(obj) is dict:
        out.append(_head(len(obj), 0x80, 15, ((0xDE, ">H", _W16), (0xDF, ">I", _W32))))
        # flax sorts every dict of the tree; its chunk maps come after that
        for k in (obj if CHUNKED in obj else sorted(obj)):
            if type(k) is not str:
                raise TypeError(f"map key {k!r} is not a str")
            _str(k, out)
            v = obj[k]
            big = (isinstance(v, np.ndarray) or torch.is_tensor(v)) and _nbytes(v) > chunk_size
            _pack(_chunked(v, chunk_size) if chunk and big else v, out, chunk_size, chunk)
    elif type(obj) is list:
        out.append(_head(len(obj), 0x90, 15, ((0xDC, ">H", _W16), (0xDD, ">I", _W32))))
        for v in obj:
            _pack(v, out, chunk_size, False)
    elif isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        _ext(_EXT_NDARRAY, _array_parts(obj), out)
    elif isinstance(obj, np.generic):
        _ext(_EXT_NPSCALAR, _array_parts(np.asarray(obj)), out)
    else:
        raise TypeError(f"{type(obj).__name__} has no msgpack form in flax's subset")


def packb(obj, chunk_size: int = MAX_CHUNK_SIZE) -> bytes:
    """``obj`` as flax's ``msgpack_serialize`` writes it: every dict in key
    order, arrays in dicts over ``chunk_size`` bytes chunked."""
    out: list = []
    _pack(obj, out, chunk_size, True)
    return b"".join(out)
