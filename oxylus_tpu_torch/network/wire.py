"""Binary wire serialization for the network protocol (a copy of
`oxylus_tpu/network/wire.py`; the same bytes for the same value, so a port peer and a
JAX peer read each other).

The zpp_bits analog: a compact, versioned, self-describing value encoding used by the
packet layer (`Oxylus/include/Networking/NetPacket.hpp:20-100` uses
zpp_bits over C++ structs; here values are tagged so RPC variant params round-trip).
Supported: None, bool, int, float, str, bytes, list, dict[str, …], numpy arrays.
No pickling — safe to decode untrusted input.
"""

from __future__ import annotations

import struct

import numpy as np

_T_NONE = 0
_T_BOOL = 1
_T_INT = 2
_T_FLOAT = 3
_T_STR = 4
_T_BYTES = 5
_T_LIST = 6
_T_DICT = 7
_T_NDARRAY = 8
_T_U64 = 9  # ints above i64 range (e.g. 64-bit name hashes)


class WireError(ValueError):
    pass


def pack_value(v, out: bytearray | None = None) -> bytes:
    if out is None:
        out = bytearray()
    _pack(v, out)
    return bytes(out)


def _pack(v, out: bytearray) -> None:
    if v is None:
        out.append(_T_NONE)
    elif isinstance(v, bool):
        out.append(_T_BOOL)
        out.append(1 if v else 0)
    elif isinstance(v, int):
        if -(2**63) <= v < 2**63:
            out.append(_T_INT)
            out += struct.pack("<q", v)
        elif v < 2**64:
            out.append(_T_U64)
            out += struct.pack("<Q", v)
        else:
            raise WireError(f"int out of 64-bit range: {v}")
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out += struct.pack("<d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(_T_STR)
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out.append(_T_BYTES)
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST)
        out += struct.pack("<I", len(v))
        for item in v:
            _pack(item, out)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        out += struct.pack("<I", len(v))
        for k, item in v.items():
            if not isinstance(k, (str, int)):
                raise WireError(f"dict keys must be str|int, got {type(k)}")
            _pack(k, out)
            _pack(item, out)
    elif isinstance(v, np.ndarray):
        b = np.ascontiguousarray(v).tobytes()
        dt = np.dtype(v.dtype).str.encode()
        out.append(_T_NDARRAY)
        out += struct.pack("<B", len(dt))
        out += dt
        out += struct.pack("<B", v.ndim)
        out += struct.pack(f"<{v.ndim}I", *v.shape)
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(v, (np.integer,)):
        _pack(int(v), out)
    elif isinstance(v, (np.floating,)):
        _pack(float(v), out)
    else:
        raise WireError(f"unsupported wire type {type(v)}")


def unpack_value(data: bytes | memoryview, offset: int = 0):
    v, off = _unpack(memoryview(data), offset)
    return v


def _unpack(data: memoryview, off: int):
    if off >= len(data):
        raise WireError("truncated")
    tag = data[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_BOOL:
        return bool(data[off]), off + 1
    if tag == _T_INT:
        return struct.unpack_from("<q", data, off)[0], off + 8
    if tag == _T_U64:
        return struct.unpack_from("<Q", data, off)[0], off + 8
    if tag == _T_FLOAT:
        return struct.unpack_from("<d", data, off)[0], off + 8
    if tag in (_T_STR, _T_BYTES):
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        if off + n > len(data):
            raise WireError("truncated string")
        raw = bytes(data[off : off + n])
        return (raw.decode("utf-8") if tag == _T_STR else raw), off + n
    if tag == _T_LIST:
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        items = []
        for _ in range(n):
            v, off = _unpack(data, off)
            items.append(v)
        return items, off
    if tag == _T_DICT:
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        d = {}
        for _ in range(n):
            k, off = _unpack(data, off)
            v, off = _unpack(data, off)
            d[k] = v
        return d, off
    if tag == _T_NDARRAY:
        (dtlen,) = struct.unpack_from("<B", data, off)
        off += 1
        dt = np.dtype(bytes(data[off : off + dtlen]).decode())
        off += dtlen
        (ndim,) = struct.unpack_from("<B", data, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}I", data, off)
        off += 4 * ndim
        (blen,) = struct.unpack_from("<I", data, off)
        off += 4
        arr = np.frombuffer(bytes(data[off : off + blen]), dt).reshape(shape)
        return arr, off + blen
    raise WireError(f"unknown tag {tag}")
