"""Minimal dependency-free image IO: PNG (zlib) encode / write / read,
PFM and Radiance HDR write / read.

A copy of `restir_tpu.utils.image_io` (numpy only), so the port's scene
loader reads textures without importing the JAX package.

Replaces the reference's stb_image_write usage (image.cpp:41-82). The
horizontal mirror at save time matches saveImage (main.cpp:127) so our
raster convention (ruv = 1 - 2*uv) produces upright, un-mirrored files.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(rgb_u8: np.ndarray, level: int = 6) -> bytes:
    """[H, W, 3] uint8 -> the bytes of an 8-bit RGB PNG file (`level`:
    zlib's compression level)."""
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PNG of {img.dtype} {img.shape}: need [H, W, 3] "
                         "uint8")
    h, w = img.shape[:2]
    # filter type 0 (none) in front of every row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, level))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """rgb_u8: [H, W, 3] uint8."""
    data = encode_png(rgb_u8)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own files (8-bit RGB, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", chunk[:10])
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += chunk
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3
    img = np.empty((h, w, 3), np.uint8)
    prev = np.zeros(stride, np.uint8)
    p = 0
    for row in range(h):
        ftype = raw[p]
        line = np.frombuffer(raw[p + 1 : p + 1 + stride], np.uint8).copy()
        p += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # sub
            for i in range(3, stride):
                line[i] = (line[i] + line[i - 3]) & 0xFF
        elif ftype == 2:  # up
            line = (line + prev) & 0xFF
        elif ftype == 3:  # average
            for i in range(stride):
                a = line[i - 3] if i >= 3 else 0
                line[i] = (line[i] + ((int(a) + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = int(line[i - 3]) if i >= 3 else 0
                b = int(prev[i])
                c = int(prev[i - 3]) if i >= 3 else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported filter {ftype}")
        img[row] = line.reshape(w, 3)
        prev = line
    return img


def write_pfm(path: str, rgb_f32: np.ndarray) -> None:
    """Radiance float image (PFM, little-endian)."""
    img = np.asarray(rgb_f32, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(img[::-1].tobytes())  # PFM stores bottom-up


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        assert f.readline().strip() == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, 3)[::-1].copy()


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE .hdr reader (the inverse of write_hdr; covers what
    stbi_loadf covers for .hdr, image.cpp:14-29): flat scanlines AND the
    adaptive-RLE encoding every external tool emits. Returns linear
    float32 [h, w, 3], top-down."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#?"):
            raise ValueError(f"not a Radiance file: {path}")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n"):
                break
            if not line:
                raise ValueError(f"truncated .hdr header: {path}")
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"unsupported .hdr orientation: {dims}")
        h, w = int(dims[1]), int(dims[3])
        data = f.read()

    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for row in range(h):
        # new-style RLE scanline: 0x02 0x02 then 16-bit width
        if (w >= 8 and w < 32768 and pos + 4 <= len(data)
                and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[row, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[row, x:x + count, c] = np.frombuffer(
                            data, np.uint8, count, pos)
                        pos += count
                        x += count
        else:  # flat scanline (also covers old-style RLE-free files)
            rgbe[row] = np.frombuffer(
                data, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def mirror_for_save(img: np.ndarray) -> np.ndarray:
    """Horizontal mirror matching saveImage (main.cpp:127)."""
    return img[:, ::-1]

def write_hdr(path: str, rgb_f32: np.ndarray) -> None:
    """Radiance RGBE .hdr writer (Image::saveHDR, image.cpp:70-82 uses
    stb's; this is the same flat-RLE-free RGBE encoding)."""
    img = np.asarray(rgb_f32, np.float32)
    h, w = img.shape[0], img.shape[1]
    m = img.max(axis=-1)
    exp = np.zeros(m.shape, np.int32)
    mant = np.zeros(m.shape, np.float32)
    nz = m >= 1e-32
    mant_nz, exp_nz = np.frexp(m[nz])
    mant[nz] = mant_nz
    exp[nz] = exp_nz
    scale = np.zeros_like(m)
    scale[nz] = mant_nz * 256.0 / m[nz]
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
