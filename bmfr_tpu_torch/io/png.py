"""PNG reading: the native reader, and a pure-Python cross-check.

Port of :mod:`bmfr_tpu.io.png`. The fidelity harness compares denoised
output against the OpenCL reference implementation's tone-mapped PNGs
(written by opencl/bmfr.cpp:521-547 via OpenImageIO). :func:`read_png`
covers everything such files use — 8/16-bit gray/RGB/RGBA, all five
scanline filters, no interlace, no palette — with the standard library's
zlib only. :func:`read_png_rgb01` reads through the native library
(:mod:`.native`, built at first use; a failed build raises, naming it),
and :func:`read_png_rgb01_py` is its independent twin, reachable by name.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native

_SIG = b"\x89PNG\r\n\x1a\n"

#: samples per pixel for each PNG color type
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw, height, stride, bpp):
    """Undo per-scanline filtering (PNG spec §6). Returns bytes of
    ``height * stride`` unfiltered image data."""
    out = bytearray(height * stride)
    pos = 0
    prev_row = bytearray(stride)
    for y in range(height):
        ftype = raw[pos]
        pos += 1
        row = bytearray(raw[pos:pos + stride])
        pos += stride
        if ftype == 1:  # Sub
            for i in range(bpp, stride):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            for i in range(stride):
                row[i] = (row[i] + prev_row[i]) & 0xFF
        elif ftype == 3:  # Average
            for i in range(stride):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev_row[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = prev_row[i]
                c = prev_row[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"png: unknown filter type {ftype}")
        out[y * stride:(y + 1) * stride] = row
        prev_row = row
    return bytes(out)


def read_png(path):
    """Read a PNG file into ``uint8[H, W, C]`` (or uint16 for 16-bit
    files). Raises ValueError on malformed/unsupported input."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError("png: bad signature")
    pos = 8
    width = height = None
    bitdepth = ctype = None
    idat = []
    while pos + 8 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        if len(data) != length:
            raise ValueError("png: truncated chunk")
        pos += 12 + length  # length + tag + data + crc
        if tag == b"IHDR":
            width, height, bitdepth, ctype, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", data)
            if interlace:
                raise ValueError("png: interlaced files not supported")
            if ctype not in _CHANNELS:
                raise ValueError(f"png: unsupported color type {ctype}")
            if bitdepth not in (8, 16):
                raise ValueError(f"png: unsupported bit depth {bitdepth}")
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if width is None or not idat:
        raise ValueError("png: missing IHDR/IDAT")
    channels = _CHANNELS[ctype]
    bpp = channels * (bitdepth // 8)
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError("png: short image data")
    data = _unfilter(raw, height, stride, bpp)
    dtype = np.dtype(">u2") if bitdepth == 16 else np.uint8
    img = np.frombuffer(data, dtype=dtype).reshape(height, width, channels)
    return img.astype(np.uint16 if bitdepth == 16 else np.uint8)


def read_png_rgb01(path):
    """Read a PNG as float32 RGB in [0, 1] (alpha dropped, gray
    broadcast) — the comparison domain for reference-output PNGs —
    through the native reader."""
    return native.read_png_rgb01(str(path))


def read_png_rgb01_py(path):
    """Pure-Python twin of :func:`read_png_rgb01` (the cross-check)."""
    img = read_png(path)
    maxv = 65535.0 if img.dtype == np.uint16 else 255.0
    img = img.astype(np.float32) / maxv
    c = img.shape[-1]
    if c == 1:
        img = np.repeat(img, 3, axis=-1)
    elif c == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    elif c == 4:
        img = img[..., :3]
    return img
