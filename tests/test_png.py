"""The standard-library PNG codec (mcpt/io/image.py): committed images
decode as Pillow decodes them, every row filter round-trips, and the save
and load paths need no Pillow."""
import glob
import os
import struct
import sys
import zlib

import numpy as np
import pytest

from mcpt.io.image import load_png, read_png, save_png, write_png

ROOT = os.path.join(os.path.dirname(__file__), "..")
COMMITTED = sorted(glob.glob(os.path.join(ROOT, "results", "*.png"))
                   + glob.glob(os.path.join(ROOT, "scenes", "*.png")))


@pytest.mark.parametrize("path", COMMITTED, ids=os.path.basename)
def test_committed_png_decodes_like_pillow(path):
    img = read_png(path)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    Image = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(img, np.asarray(Image.open(path)))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_roundtrip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (19, 23, channels), dtype=np.uint8)
    p = write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(read_png(p), img)
    rgb = load_png(p)
    assert rgb.shape == (19, 23, 3) and rgb.dtype == np.float32
    np.testing.assert_array_equal(rgb[..., 0] * 255.0, img[..., 0])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_row(ft, row, prev, bpp):
    """PNG spec filter, one byte at a time (the reference for the decoder)."""
    out = bytearray()
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ft]
        out.append((x - pred) % 256)
    return bytes([ft]) + bytes(out)


def test_all_five_row_filters(tmp_path):
    rng = np.random.default_rng(0)
    H, W, C = 10, 7, 3
    img = np.cumsum(rng.integers(0, 40, (H, W, C)), axis=1).astype(np.uint8)
    rows = img.reshape(H, W * C).tolist()
    raw, prev = b"", [0] * (W * C)
    for y, row in enumerate(rows):
        raw += _encode_row(y % 5, row, prev, C)
        prev = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    p = tmp_path / "filters.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n"
                  + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                  + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(read_png(str(p)), img)


def test_save_and_load_without_pillow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)  # `import PIL` now fails
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    acc = np.full((4, 5, 3), 0.25, np.float32)
    p = save_png(str(tmp_path / "t.png"), acc, 1.0)
    got = load_png(p)
    np.testing.assert_allclose(got, 127 / 255.0)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
