"""LZF codec of PCD `binary_compressed` files (cupoch io/file_pcd.cu:218,
436-454, liblzf's wire format).

`csrc/lzf.c` builds with the system C compiler into
`_build/liblzf-<hash>.so` at first use and runs through ctypes; a build
that fails raises. `decompress_plain` is the decoder in Python and
numpy, the plain version the tests hold the C decoder to. Nothing here
runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

from .nvcc import BUILD_DIR, CSRC

_SRC = os.path.join(CSRC, "lzf.c")
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"liblzf-{digest}.so")


def _compiler() -> str:
    for cc in ("cc", "gcc", "clang"):
        path = shutil.which(cc)
        if path:
            return path
    raise RuntimeError("no C compiler (cc, gcc or clang) to build "
                       "csrc/lzf.c for PCD binary_compressed files")


def load() -> ctypes.CDLL:
    """The built codec, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        out = subprocess.run(
            [_compiler(), "-O3", "-fPIC", "-shared", "-o", tmp, _SRC],
            capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building csrc/lzf.c failed:\n{out.stdout}"
                               f"{out.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    for fn in (lib.lzf_compress, lib.lzf_decompress):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                       ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compress(data: bytes) -> Optional[bytes]:
    """The LZF stream of `data`, or None when it does not come out
    shorter than `data` (incompressible: the PCD format then stores the
    bytes raw)."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    cap = max(64, int(len(data) * 1.04) + 16)
    dst = np.empty(cap, np.uint8)
    n = lib.lzf_compress(_ptr(src), len(data), _ptr(dst), cap)
    if n == 0 or n >= len(data):
        return None
    return dst[:n].tobytes()


def decompress(data: bytes, expected_size: int) -> bytes:
    """Decode an LZF stream of `expected_size` bytes; raises on a
    malformed stream."""
    lib = load()
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(expected_size, np.uint8)
    n = lib.lzf_decompress(_ptr(src), len(data), _ptr(dst), expected_size)
    if n == 0 and expected_size:
        raise ValueError("lzf_decompress: malformed input")
    return dst[:n].tobytes()


def decompress_plain(data: bytes, expected_size: int) -> bytes:
    """`decompress` in Python and numpy, a token at a time: a control
    byte below 32 starts a literal run of ctrl + 1 bytes; any other is a
    back reference of (ctrl >> 5) + 2 bytes (7 takes a length byte
    more) at the distance in its low 5 bits and the next byte, plus one.
    An overlapping reference repeats its period."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(expected_size, np.uint8)
    ip, op, n = 0, 0, len(src)
    while ip < n:
        ctrl = int(src[ip])
        ip += 1
        if ctrl < 32:
            cnt = ctrl + 1
            if op + cnt > expected_size or ip + cnt > n:
                raise ValueError("lzf: literal run past the end")
            out[op:op + cnt] = src[ip:ip + cnt]
            ip += cnt
            op += cnt
            continue
        length = ctrl >> 5
        if length == 7:
            length += int(src[ip])
            ip += 1
        ref = op - (((ctrl & 0x1F) << 8) + int(src[ip])) - 1
        ip += 1
        length += 2
        if ref < 0 or op + length > expected_size:
            raise ValueError("lzf: back reference out of range")
        period = op - ref
        if period >= length:
            out[op:op + length] = out[ref:ref + length]
        else:
            reps = -(-length // period)
            out[op:op + length] = np.tile(out[ref:op], reps)[:length]
        op += length
    return out[:op].tobytes()
