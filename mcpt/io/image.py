"""PNG input/output matching the reference's tonemap + save pipeline.

Reference: src/Scene.cpp:23-53 — mean over spp, clamp [0,1], gamma 1/2
(not 1/2.2), x255.99 to u8, vertical flip, PNG.

The PNG codec is the standard library's zlib plus numpy: 8-bit gray, RGB
and RGBA, non-interlaced, all five row filters on read.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (8-bit only)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def tonemap(accum: np.ndarray, spp: np.ndarray | float) -> np.ndarray:
    """accum f32[H,W,3], spp broadcastable -> u8[H,W,3]."""
    rgb = np.asarray(accum, np.float32) / np.maximum(np.asarray(spp, np.float32), 1e-30)
    rgb = np.clip(rgb, 0.0, 1.0) ** 0.5  # gamma 1/2 (Scene.cpp:26-29)
    return (rgb * 255.99).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> str:
    """u8[H,W] (gray) or u8[H,W,C] with C in {1,3,4} -> PNG file.

    Every row is stored with the Up filter (row minus the row above),
    which suits smooth rendered images.
    """
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[C]
    rows = img.reshape(H, W * C)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
    return path


def _unfilter_seq(ft: int, cur: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) rows, which chain along the row."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ft == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def read_png(path: str) -> np.ndarray:
    """PNG file -> u8[H,W,C] (C = 1, 3 or 4), top row first."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace}); 8-bit gray/RGB/RGBA only"
        )
    C = _CHANNELS[ctype]
    stride = W * C
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: H * (stride + 1)].reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        ft, cur = int(raw[y, 0]), raw[y, 1:]
        if ft == 0:
            row = cur.copy()
        elif ft == 1:  # Sub: running sum per channel, mod 256
            row = np.cumsum(cur.reshape(W, C), axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:  # Up
            row = cur + prev
        elif ft in (3, 4):
            buf = bytearray(cur.tobytes())
            _unfilter_seq(ft, buf, prev.tobytes(), C)
            row = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ft} in row {y}")
        out[y] = row
        prev = out[y]
    return out.reshape(H, W, C)


def save_png(path: str, accum: np.ndarray, spp, flip: bool = True) -> str:
    img = tonemap(accum, spp)
    if flip:
        img = img[::-1]  # vertical flip (Scene.cpp:40-45)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_png(path, img)


def load_png(path: str) -> np.ndarray:
    """Load a PNG to float RGB [0,1], top row first (no flip). Gray is
    replicated to three channels; alpha is dropped."""
    img = read_png(path)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return img[..., :3].astype(np.float32) / 255.0


def load_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) decoder -> linear f32[H,W,3].

    Parity with the reference's HDR texture path (src/model.cpp:8-23, which
    uses stbi_loadf): components decode as c * 2^(e-136) (stb_image
    semantics), supporting both new-style RLE scanlines and flat RGBE.
    Pure numpy + a per-scanline host loop — runs once at scene load.
    """
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance RGBE file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n"):
                break
            if line == b"":
                raise ValueError(f"{path}: truncated header")
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"{path}: unsupported resolution line {dims!r}")
        H, W = int(dims[1]), int(dims[3])
        data = np.frombuffer(f.read(), np.uint8)

    img = np.zeros((H, W, 4), np.uint8)
    pos = 0
    for y in range(H):
        if (
            8 <= W < 32768
            and pos + 4 <= len(data)
            and data[pos] == 2
            and data[pos + 1] == 2
            and ((int(data[pos + 2]) << 8) | int(data[pos + 3])) == W
        ):
            pos += 4  # new-style RLE: 4 per-component runs
            for ch in range(4):
                x = 0
                while x < W:
                    n = int(data[pos]); pos += 1
                    if n > 128:  # run of one repeated byte
                        img[y, x : x + n - 128, ch] = data[pos]
                        pos += 1
                        x += n - 128
                    else:  # literal run
                        img[y, x : x + n, ch] = data[pos : pos + n]
                        pos += n
                        x += n
        else:  # flat RGBE scanline
            img[y] = data[pos : pos + 4 * W].reshape(W, 4)
            pos += 4 * W

    e = img[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0).astype(np.float32)
    return img[..., :3].astype(np.float32) * scale[..., None]
