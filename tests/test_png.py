"""Standard-library PNG / PGM codec (io/png.py): round trips through the
encoder, decoding of files written by other encoders (every PNG row filter),
and the reduction to 8-bit grayscale the image loaders apply."""

import numpy as np
import pytest

from okvis2x_tpu.io import png

RNG = np.random.default_rng(5)

SAMPLES = {
    "gray8": lambda: RNG.integers(0, 256, (37, 53), dtype=np.uint8),
    "gray16": lambda: RNG.integers(0, 65536, (29, 41), dtype=np.uint16),
    "rgb8": lambda: RNG.integers(0, 256, (17, 23, 3), dtype=np.uint8),
}


@pytest.mark.parametrize("kind", sorted(SAMPLES))
def test_png_round_trip(tmp_path, kind):
    arr = SAMPLES[kind]()
    path = str(tmp_path / f"{kind}.png")
    png.write_png(path, arr)
    out = png.read_image(path)
    assert out.dtype == arr.dtype
    np.testing.assert_array_equal(out, arr)


def _smooth_image(shape, dtype):
    """A gradient with noise: adaptive encoders pick every filter type on
    such rows (flat runs, ramps, texture)."""
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 3 + y * 5) % 256 + RNG.integers(0, 7, (h, w))
    if dtype == np.uint16:
        base = base * 251
    img = np.clip(base, 0, np.iinfo(dtype).max).astype(dtype)
    if len(shape) == 3:
        img = np.stack([img, img[::-1], img[:, ::-1]], -1)
    return img


@pytest.mark.parametrize("shape,dtype", [
    ((40, 64), np.uint8),
    ((40, 64), np.uint16),
    ((32, 48, 3), np.uint8),
])
def test_png_decodes_adaptive_filters(tmp_path, shape, dtype):
    Image = pytest.importorskip("PIL.Image")
    arr = _smooth_image(shape, dtype)
    path = str(tmp_path / "pil.png")
    Image.fromarray(arr).save(path, optimize=True)
    np.testing.assert_array_equal(png.read_image(path), arr)


@pytest.mark.parametrize("maxval,dtype", [(255, np.uint8), (4095, np.uint16)])
def test_pgm_decode(tmp_path, maxval, dtype):
    arr = RNG.integers(0, maxval + 1, (24, 30)).astype(dtype)
    path = str(tmp_path / "a.pgm")
    with open(path, "wb") as f:
        f.write(f"P5\n# comment\n30 24\n{maxval}\n".encode())
        f.write(arr.astype(">u2" if maxval > 255 else np.uint8).tobytes())
    np.testing.assert_array_equal(png.read_image(path), arr)


def test_to_gray8():
    g16 = np.array([[0, 255, 256, 65535]], np.uint16)
    np.testing.assert_array_equal(png.to_gray8(g16), [[0, 0, 1, 255]])
    rgb = np.array([[[255, 0, 0], [0, 255, 0], [0, 0, 255]]], np.uint8)
    np.testing.assert_array_equal(png.to_gray8(rgb), [[54, 182, 18]])


def test_png_rejects_unsupported():
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        png.decode_png(b"GIF89a")


def _filtered_png(arr: np.ndarray) -> bytes:
    """Encode with row filters cycling through types 0-4 (forward PNG
    filtering, written out independently of io/png.py's encoder)."""
    import struct
    import zlib

    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    depth = arr.dtype.itemsize * 8
    rows = arr.astype(arr.dtype.newbyteorder(">")).reshape(h, -1).view(np.uint8)
    rows = rows.astype(np.int32)
    bpp = ch * arr.dtype.itemsize
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        ftype = y % 5
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    ctype = {1: 0, 3: 2}[ch]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", sorted(SAMPLES))
def test_png_decodes_every_filter_type(kind):
    arr = SAMPLES[kind]()
    np.testing.assert_array_equal(png.decode_png(_filtered_png(arr)), arr)
