"""Image file IO (cupoch io/file_format/file_png.cpp, file_jpg.cpp).

PNG is decoded and encoded here with numpy and the standard library's
zlib: 8- and 16-bit grey, grey with alpha, RGB and RGBA, and 8-bit
palette images, non-interlaced, with the five row filters; the writer
uses filter 0 a row. A 16-bit PNG keeps uint16 (depth maps). JPEG
needs PIL and raises a clear error without it.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..geometry.image import Image
from ..utility import console

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (3: palette indices)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(buf: bytes):
    if buf[:8] != _PNG_SIG:
        console.log_error("[ReadPNG] not a PNG file.")
    pos = 8
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        yield kind, buf[pos + 8:pos + 8 + n]
        pos += 12 + n


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """Undo the PNG row filters: raw holds height rows of a filter byte
    and `stride` bytes; bpp is the bytes a pixel (at least 1)."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:          # Sub: a running sum a pixel apart
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64), 0) \
                .astype(np.uint8).reshape(-1)
        elif ft == 2:          # Up
            cur = line + prior
        elif ft in (3, 4):     # Average, Paeth: byte by byte
            cur = bytearray(stride)
            up = prior.tolist()
            src = line.tolist()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if ft == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x],
                                  up[x - bpp] if x >= bpp else 0)
                cur[x] = (src[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            console.log_error(f"[ReadPNG] unknown filter type {ft}.")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """[H, W, C] uint8 or uint16 (big-endian samples become native)."""
    with open(path, "rb") as f:
        buf = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        console.log_error("[ReadPNG] no IHDR chunk.")
    w, h, depth, ctype, _, _, interlace = header
    if interlace or ctype not in _CHANNELS or depth not in (8, 16) \
            or (ctype == 3 and depth != 8):
        console.log_error(f"[ReadPNG] unsupported PNG: colour type {ctype}, "
                          f"bit depth {depth}, interlace {interlace}.")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    data = _unfilter(raw[:h * (w * bpp + 1)], h, w * bpp, bpp)
    if depth == 16:
        arr = data.reshape(h, w * ch * 2).view(">u2").astype(np.uint16) \
            .reshape(h, w, ch)
    else:
        arr = data.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            console.log_error("[ReadPNG] palette image without PLTE.")
        arr = palette[arr[..., 0]]
    return arr


def write_png(path: str, arr: np.ndarray) -> bool:
    """Write uint8 or uint16 [H, W] or [H, W, C] (C = 1-4) as PNG, row
    filter 0."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, ch = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if ctype is None or arr.dtype not in (np.uint8, np.uint16):
        console.log_error(f"[WritePNG] unsupported image: {ch} channels "
                          f"of {arr.dtype}.")
    depth = 16 if arr.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr) \
        .view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
    return True


def _pil():
    try:
        from PIL import Image as PILImage
    except ImportError:
        console.log_error("[ReadImage/WriteImage] JPEG and formats other "
                          "than PNG need PIL, which is not installed.")
    return PILImage


def _ext(path: str) -> str:
    return os.path.splitext(path)[1][1:].lower()


def read_image(path: str, device=None) -> Image:
    """An Image on `device` (None: the card); a 16-bit PNG keeps
    uint16."""
    if _ext(path) == "png":
        arr = read_png(path)
    else:
        arr = np.asarray(_pil().open(path))
        if arr.ndim == 2:
            arr = arr[..., None]
    return Image(arr, device=device)


def write_image(path: str, image, quality: int = 90) -> bool:
    """Write an Image (or array) of any device; float images are scaled
    from [0, 1] to uint8."""
    arr = image.to_numpy() if hasattr(image, "to_numpy") \
        else np.asarray(image)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.dtype in (np.float32, np.float64):
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if _ext(path) == "png":
        return write_png(path, arr)
    _pil().fromarray(arr).save(path, quality=quality)
    return True
