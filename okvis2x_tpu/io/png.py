"""Minimal PNG and binary PGM codec on the standard library (zlib + struct).

Covers what EuRoC-layout datasets hold: non-interlaced grayscale, gray +
alpha, RGB, RGBA and palette images at 8 bits, and grayscale / colour at
16 bits.  The writer emits 8- or 16-bit grayscale (camera frames, depth in
millimetres, class maps) and 8-bit RGB.  The native libpng loader
(io/native_loader.py) is the fast path; this module is its portable
fallback and the renderer's encoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# samples per pixel by PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# ITU-R BT.709 luma, the weights libpng's rgb-to-gray uses by default
_LUMA = np.array([0.2126, 0.7152, 0.0722])


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(arr: np.ndarray, compress_level: int = 1) -> bytes:
    """PNG bytes of a (H, W) uint8/uint16 grayscale or (H, W, 3) uint8 RGB
    array.  Rows are stored unfiltered (filter type 0)."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8 and arr.ndim == 2:
        depth, ctype = 8, 0
    elif arr.dtype == np.uint16 and arr.ndim == 2:
        depth, ctype = 16, 0
    elif arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
        depth, ctype = 8, 2
    else:
        raise ValueError(f"unsupported PNG array {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">")))
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (
        _SIG + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, arr: np.ndarray, compress_level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr, compress_level))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) -> (h, stride) uint8."""
    src = np.frombuffer(data, np.uint8)
    if src.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    src = src[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(src[y, 0]), src[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 2:
            cur = line + prev
        elif ftype == 1:
            cur = (
                np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64) & 0xFF
            ).astype(np.uint8).ravel()
        elif ftype in (3, 4):
            # these predictors read the already-decoded left neighbour, so
            # the row is serial, one pixel (bpp bytes) at a time
            cur = line.astype(np.int32)
            up = prev.astype(np.int32)
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                if ftype == 3:
                    pred = (a + int(up[x])) >> 1
                else:
                    b = int(up[x])
                    c = int(up[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """Decode PNG bytes to (H, W) or (H, W, C) uint8/uint16 samples
    (palette images come back as (H, W, 3) RGB)."""
    if buf[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos + 8 <= len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG (colour {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"unsupported PNG bit depth {depth}")
    bps = depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch * bps, ch * bps)
    if bps == 2:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = rows.reshape(h, w, ch)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        return plte[img[..., 0]]
    return img[..., 0] if ch == 1 else img


def decode_pgm(buf: bytes) -> np.ndarray:
    """Binary (P5) PGM bytes -> (H, W) uint8/uint16."""
    if buf[:2] != b"P5":
        raise ValueError("not a binary PGM file")
    fields, pos = [], 2
    while len(fields) < 3:
        while buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":
            pos = buf.index(b"\n", pos) + 1
            continue
        end = pos
        while not buf[end:end + 1].isspace():
            end += 1
        fields.append(int(buf[pos:end]))
        pos = end
    w, h, maxval = fields
    pos += 1  # single whitespace byte before the raster
    dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    img = np.frombuffer(buf, dt, count=w * h, offset=pos).reshape(h, w)
    return img.astype(np.uint16) if maxval >= 256 else img.copy()


def read_image(path: str) -> np.ndarray:
    """PNG or binary PGM file -> samples as stored (see decode_png)."""
    with open(path, "rb") as f:
        buf = f.read()
    return decode_pgm(buf) if buf[:2] == b"P5" else decode_png(buf)


def to_gray8(img: np.ndarray) -> np.ndarray:
    """Decoded samples -> (H, W) uint8 the way the native libpng loader
    reduces them: 16-bit keeps the high byte, colour goes through BT.709
    luma, alpha is dropped."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 3:
        c = img.shape[2]
        if c in (3, 4):
            img = np.clip(np.rint(img[..., :3] @ _LUMA), 0, 255).astype(np.uint8)
        else:  # gray + alpha
            img = img[..., 0]
    return img
