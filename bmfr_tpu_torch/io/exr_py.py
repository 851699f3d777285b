"""Pure-Python scanline EXR reader and writers, numpy array code.

Port of :mod:`bmfr_tpu.io.exr_py`: single-part scanline files, NONE / RLE
/ ZIPS / ZIP / PIZ / PXR24 / B44 / B44A compression, HALF and FLOAT
channels, written against the OpenEXR file-format spec independently of
the C++ implementation in ``native/bmfr_io.cpp``. The writers
(:func:`write_exr_py` for PIZ and PXR24, :func:`write_exr_b44` for B44 and
B44A) give the same bytes as the JAX package's for the same input and are
what :mod:`.staging` writes those codecs with; the native library writes
NONE/RLE/ZIPS/ZIP. :func:`read_exr_py` is the independent cross-check of
the native reader, reachable by name only: nothing in the port falls back
to it.

The B44 encoder evaluates the 14 shifts of every 4x4 block of a file at
once, and the B44 decoder unpacks every block of a channel at once.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import piz

_MAGIC = 20000630


class _Cursor:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, n):
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise IOError("truncated EXR")
        self.pos += n
        return b

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def u8(self):
        return self.read(1)[0]

    def cstr(self):
        end = self.buf.index(b"\0", self.pos)
        s = self.buf[self.pos : end].decode("latin-1")
        self.pos = end + 1
        return s


def _rle_decompress(data: bytes, out_size: int) -> bytes:
    """EXR RLE: signed count byte; negative = literals, else repeat."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < out_size:
        count = data[i]
        i += 1
        if count > 127:  # negative int8 -> literal run
            ln = 256 - count
            out += data[i : i + ln]
            i += ln
        else:
            out += bytes([data[i]]) * (count + 1)
            i += 1
    if len(out) != out_size:
        raise IOError("corrupt RLE EXR chunk")
    return bytes(out)


def _unfilter(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8).astype(np.int16)
    arr = (np.cumsum(arr - 128, dtype=np.int64) + 128) % 256
    arr = arr.astype(np.uint8)
    # re-interleave the two halves
    half = (len(arr) + 1) // 2
    out = np.empty(len(arr), np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _unfilter_pxr24(data: bytes) -> np.ndarray:
    """PXR24 predictor: plain running sum over the whole buffer (no
    ZIP-style two-half interleave)."""
    arr = np.frombuffer(data, np.uint8).astype(np.int64)
    if arr.size:
        arr = np.cumsum(arr - 128) + 128
    return (arr % 256).astype(np.uint8)


def _float_to_float24(v: np.ndarray) -> np.ndarray:
    """OpenEXR's floatToFloat24, vectorized (ImfPxr24Compressor.cpp).

    Finite values round the significand to 15 bits with round-half-up on
    exact ties: ((e|m) + (m & 0x80) + 0x3f) >> 8 — the carry may
    propagate into the exponent; if it overflows into the infinity
    exponent the significand is truncated instead. NaNs keep their top
    15 significand bits but force at least one bit set so they never
    collapse to infinity; infinities pass through.
    """
    u32 = np.ascontiguousarray(v, np.float32).view(np.uint32)
    s = (u32 & 0x80000000) >> np.uint32(8)
    e = u32 & 0x7F800000
    m = u32 & 0x007FFFFF
    m24 = m >> np.uint32(8)
    nan_i24 = (e >> np.uint32(8)) | m24 | (m24 == 0).astype(np.uint32)
    rounded = ((e | m) + (m & 0x80) + np.uint32(0x3F)) >> np.uint32(8)
    fin_i24 = np.where(rounded >= 0x7F8000, (e | m) >> np.uint32(8),
                       rounded)
    i24 = np.where(e == 0x7F800000,
                   np.where(m != 0, nan_i24, e >> np.uint32(8)),
                   fin_i24)
    return (s | i24).astype(np.uint32)


def _decode_pxr24(chunk: bytes, channels, W: int, nlines: int) -> bytes:
    """PXR24 chunk -> the standard per-line-per-channel raw layout.

    FLOAT channels are stored as 3 MSB-first byte planes of a 24-bit
    float (f32 with the low 8 mantissa bits dropped; decode is exact:
    shift left 8). HALF channels as 2 byte planes."""
    raw = _unfilter_pxr24(zlib.decompress(chunk))
    out = bytearray()
    p = 0
    for _ in range(nlines):
        for cn, ptype in channels:
            if ptype == 1:  # HALF: 2 planes
                hi = raw[p : p + W].astype(np.uint16)
                lo = raw[p + W : p + 2 * W].astype(np.uint16)
                p += 2 * W
                out += ((hi << 8) | lo).astype("<u2").tobytes()
            elif ptype == 2:  # FLOAT: 3 planes of the top 24 bits
                b0 = raw[p : p + W].astype(np.uint32)
                b1 = raw[p + W : p + 2 * W].astype(np.uint32)
                b2 = raw[p + 2 * W : p + 3 * W].astype(np.uint32)
                p += 3 * W
                u = ((b0 << 24) | (b1 << 16) | (b2 << 8)).astype("<u4")
                out += u.tobytes()
            else:
                raise IOError("UINT EXR channels not supported")
    return bytes(out)


# ---------------------------------------------------------------- B44

#: B44's delta chains, (sample, the sample it is coded against), in the
#: order the format decodes them (row-major 4x4 sample indices)
_B44_CHAINS = ((4, 0), (8, 4), (12, 8),
               (1, 0), (5, 4), (9, 8), (13, 12),
               (2, 1), (6, 5), (10, 9), (14, 13),
               (3, 2), (7, 6), (11, 10), (15, 14))
#: the four 3-byte groups of a 14-byte block (bytes 2-4, 5-7, 8-10,
#: 11-13): the 6-bit field in each group's top bits, then three samples'
#: 6-bit deltas. The first group's top field is the shift, the others'
#: are the deltas of samples 1, 2, 3.
_B44_GROUPS = ((None, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
               (3, 7, 11, 15))
#: B44A's flat-block marker (byte 2 of a 3-byte block)
_B44A_FLAT = 0xFC


def _b44_transform(s):
    """B44's order-preserving half transform (encode side), on uint16
    arrays."""
    s = np.asarray(s, np.int64)
    return np.where((s & 0x7C00) == 0x7C00, 0x8000,  # inf/nan collapse
                    np.where(s & 0x8000, (~s) & 0xFFFF, s | 0x8000))


def _b44_untransform(t):
    """Invert the order-preserving half transform of B44."""
    t = np.asarray(t, np.int64)
    return np.where(t & 0x8000, t & 0x7FFF, (~t) & 0xFFFF)


def _b44_encode_blocks(t: np.ndarray) -> np.ndarray:
    """Pack blocks of 16 transformed samples ``[N, 16]`` (row-major 4x4)
    into ``[N, 14]`` bytes.

    JAX's encoder takes the smallest shift whose quantized chain deltas
    reproduce the block exactly, else the smallest whose deltas all fit
    6 bits, else shift 13 with its deltas clamped. That is the smallest
    feasible shift, else 13: a block exact at some shift has every delta
    ``t[i] - t[p]`` a multiple of it, so at each smaller shift it is
    exact or a delta overflows; and an exact chain needs no clamping. The
    shifts are tried in turn for every undecided block at once."""
    t = np.ascontiguousarray(np.asarray(t, np.int32).T)  # [16, N]
    n = t.shape[1]
    e_best = np.zeros((16, n), np.int32)
    shift_best = np.full(n, 13, np.int32)
    decided = np.zeros(n, bool)
    rec = np.empty_like(t)
    e = np.zeros_like(t)
    for shift in range(14):
        bias = 0x20 << shift
        rec[0] = t[0]
        feasible = np.ones(n, bool)
        for i, p in _B44_CHAINS:
            ei = (t[i] - rec[p] + bias) >> shift
            feasible &= (ei >= 0) & (ei <= 63)
            np.clip(ei, 0, 63, out=e[i])
            rec[i] = (rec[p] + (e[i] << shift) - bias) & 0xFFFF
        take = ~decided & (feasible | (shift == 13))
        e_best[:, take] = e[:, take]
        shift_best[take] = shift
        decided |= take
        if decided.all():
            break
    out = np.empty((14, n), np.int32)
    out[0] = t[0] >> 8
    out[1] = t[0] & 0xFF
    for g, (top, x, y, z) in enumerate(_B44_GROUPS):
        hi = shift_best if top is None else e_best[top]
        ex, ey, ez = e_best[x], e_best[y], e_best[z]
        out[2 + 3 * g] = (hi << 2) | (ex >> 4)
        out[3 + 3 * g] = ((ex & 0xF) << 4) | (ey >> 2)
        out[4 + 3 * g] = ((ey & 3) << 6) | ez
    return out.T.astype(np.uint8)


def _b44_decode_blocks(b: np.ndarray) -> np.ndarray:
    """Unpack ``[N, 14]`` block bytes into ``[N, 16]`` transformed
    samples (row-major 4x4)."""
    b = np.asarray(b, np.int64)
    t = np.empty((b.shape[0], 16), np.int64)
    t[:, 0] = (b[:, 0] << 8) | b[:, 1]
    field = {}
    for g, (top, x, y, z) in enumerate(_B44_GROUPS):
        b0, b1, b2 = b[:, 2 + 3 * g], b[:, 3 + 3 * g], b[:, 4 + 3 * g]
        field["shift" if top is None else top] = b0 >> 2
        field[x] = ((b0 << 4) | (b1 >> 4)) & 0x3F
        field[y] = ((b1 << 2) | (b2 >> 6)) & 0x3F
        field[z] = b2 & 0x3F
    shift = field["shift"]
    bias = 0x20 << shift
    for i, p in _B44_CHAINS:
        t[:, i] = t[:, p] + (field[i] << shift) - bias
    return t & 0xFFFF


def _decode_b44(chunk: bytes, channels, W: int, nlines: int,
                b44a: bool) -> bytes:
    """B44/B44A chunk -> the standard per-line-per-channel raw layout.

    HALF channels are 4x4 blocks of 14 packed bytes (3 for B44A flat
    blocks, marker b[2] == 0xfc); FLOAT channels are stored raw."""
    data = np.frombuffer(chunk, np.uint8)
    nby, nbx = (nlines + 3) // 4, (W + 3) // 4
    lines = []
    pos = 0
    for cn, pt in channels:
        if pt != 1:  # FLOAT/UINT stored raw, line by line
            nb = 4 * W * nlines
            if pos + nb > data.size:
                raise IOError("corrupt B44 EXR chunk")
            lines.append(data[pos : pos + nb].reshape(nlines, 4 * W))
            pos += nb
            continue
        nblk = nby * nbx
        if b44a:
            starts, flat = np.empty(nblk, np.int64), np.zeros(nblk, bool)
            for k in range(nblk):
                starts[k] = pos
                flat[k] = pos + 3 <= len(chunk) and chunk[pos + 2] == \
                    _B44A_FLAT
                pos += 3 if flat[k] else 14
        else:
            starts = pos + 14 * np.arange(nblk)
            flat = np.zeros(nblk, bool)
            pos += 14 * nblk
        if pos > data.size:
            raise IOError("corrupt B44 EXR chunk")
        padded = np.concatenate([data, np.zeros(14, np.uint8)])
        blk = padded[starts[:, None] + np.arange(14)]
        t = _b44_decode_blocks(blk)
        t[flat] = ((blk[flat, 0].astype(np.int64) << 8)
                   | blk[flat, 1])[:, None]
        vals = _b44_untransform(t).reshape(nby, nbx, 4, 4).transpose(
            0, 2, 1, 3).reshape(4 * nby, 4 * nbx)[:nlines, :W]
        lines.append(vals.astype("<u2").view(np.uint8).reshape(nlines,
                                                               2 * W))
    return np.concatenate(lines, axis=1).tobytes()


def _decode_piz(chunk: bytes, channels, W: int, nlines: int) -> bytes:
    """PIZ chunk -> the standard per-line-per-channel raw layout."""
    shapes = []
    for cn, ptype in channels:
        size = 2 if ptype == 2 else 1
        shapes.append((nlines, W, size))
    bufs = piz.piz_uncompress(chunk, shapes)
    out = bytearray()
    for line in range(nlines):
        for (cn, ptype), buf in zip(channels, bufs):
            out += buf[line].astype("<u2").tobytes()
    return bytes(out)


# ---------------------------------------------------------------- writers


def _header(comp_id: int, W: int, H: int, half: bool) -> bytearray:
    """The header of a 3-channel scanline file (B, G, R: EXR requires
    alphabetical order, as the native writer, native/bmfr_io.cpp:742-756)
    up to its end-of-header byte."""
    out = bytearray()
    out += struct.pack("<II", _MAGIC, 2)

    def attr(name, typ, data):
        out.extend(name.encode() + b"\0" + typ.encode() + b"\0")
        out.extend(struct.pack("<I", len(data)))
        out.extend(data)

    chl = bytearray()
    for cn in ("B", "G", "R"):
        chl += cn.encode() + b"\0"
        chl += struct.pack("<iBBBBii", 1 if half else 2, 0, 0, 0, 0, 1, 1)
    chl += b"\0"
    attr("channels", "chlist", bytes(chl))
    attr("compression", "compression", bytes([comp_id]))
    dw = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    attr("dataWindow", "box2i", dw)
    attr("displayWindow", "box2i", dw)
    attr("lineOrder", "lineOrder", b"\0")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    out += b"\0"
    return out


def _write_chunks(path: str, head: bytearray, lpb: int, H: int, payloads):
    """Write ``head``, the chunk offset table and the chunks: chunk ``b``
    holds lines ``b * lpb ...`` and the bytes ``payloads[b]``."""
    out = head
    table_pos = len(out)
    out += b"\0" * (8 * len(payloads))
    offsets = []
    for b, payload in enumerate(payloads):
        offsets.append(len(out))
        out += struct.pack("<iI", b * lpb, len(payload))
        out += payload
    out[table_pos : table_pos + 8 * len(offsets)] = struct.pack(
        f"<{len(offsets)}Q", *offsets)
    with open(path, "wb") as f:
        f.write(bytes(out))


def _check_rgb(img_hwc, who):
    img = np.asarray(img_hwc, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{who}: only 3 channels supported")
    return img


def write_exr_py(path: str, img_hwc: np.ndarray, half: bool = True,
                 compression: str = "piz"):
    """Scanline EXR writer for PIZ / PXR24 files (the native writer
    covers NONE/RLE/ZIPS/ZIP). Channels are written B, G, R."""
    comp_id = {"piz": 4, "pxr24": 5}[compression]
    lpb = {4: 32, 5: 16}[comp_id]
    img = _check_rgb(img_hwc, "write_exr_py")
    H, W, _ = img.shape
    # [H, 3, W] in file channel order B, G, R
    src = np.ascontiguousarray(img[:, :, ::-1].transpose(0, 2, 1))
    payloads = []
    for ylo in range(0, H, lpb):
        rows = src[ylo : ylo + lpb]
        nlines = rows.shape[0]
        if comp_id == 4:
            if half:
                chans = [(rows[:, c].astype(np.float16).view(np.uint16), 1)
                         for c in range(3)]
            else:
                chans = [(np.ascontiguousarray(rows[:, c]).view(
                    np.uint16).reshape(nlines, 2 * W), 2) for c in range(3)]
            payload = piz.piz_compress(chans)
        else:  # PXR24: per line and channel, MSB-first byte planes
            if half:
                h16 = rows.astype(np.float16).view(np.uint16)
                planes = np.stack([h16 >> 8, h16 & 0xFF], axis=2)
            else:
                u = _float_to_float24(rows)
                planes = np.stack([u >> 16, (u >> 8) & 0xFF, u & 0xFF],
                                  axis=2)
            arr = planes.astype(np.int64).ravel()
            d = np.empty_like(arr)
            d[0] = arr[0]
            d[1:] = arr[1:] - arr[:-1] + 128
            payload = zlib.compress((d % 256).astype(np.uint8).tobytes())
        raw_size = (2 if half else 4) * W * 3 * nlines
        if len(payload) >= raw_size:
            # store raw (decoder takes the packed >= unpacked path)
            payload = rows.astype("<f2" if half else "<f4").tobytes()
        payloads.append(payload)
    _write_chunks(path, _header(comp_id, W, H, half), lpb, H, payloads)


def write_exr_b44(path: str, img_hwc: np.ndarray, b44a: bool = False):
    """B44/B44A EXR writer (HALF channels only). Each chunk's channel
    planes are edge-padded to whole 4x4 blocks, like the reference
    encoder; B44A stores a block of 16 equal samples in 3 bytes."""
    img = _check_rgb(img_hwc, "write_exr_b44")
    H, W, _ = img.shape
    lpb = 32
    src = img[:, :, ::-1].astype(np.float16).view(np.uint16)
    pw = (W + 3) // 4 * 4
    blocks, counts = [], []
    for ylo in range(0, H, lpb):
        h16 = src[ylo : ylo + lpb].transpose(2, 0, 1)  # [3, nlines, W]
        nlines = h16.shape[1]
        ph = (nlines + 3) // 4 * 4
        pad = np.zeros((3, ph, pw), np.uint16)
        pad[:, :nlines, :W] = h16
        pad[:, nlines:, :W] = h16[:, -1:]
        pad[:, :, W:] = pad[:, :, W - 1 : W]
        blk = pad.reshape(3, ph // 4, 4, pw // 4, 4).transpose(0, 1, 3, 2, 4)
        blocks.append(_b44_transform(blk.reshape(-1, 16)))
        counts.append(blocks[-1].shape[0])
    t = np.concatenate(blocks)
    packed = _b44_encode_blocks(t)
    keep = np.ones(packed.shape, bool)
    if b44a:
        flat = (t == t[:, :1]).all(axis=1)
        packed[flat, 2] = _B44A_FLAT
        keep[flat, 3:] = False
    ends = np.cumsum(counts)
    payloads = [packed[e - c : e][keep[e - c : e]].tobytes()
                for c, e in zip(counts, ends)]
    _write_chunks(path, _header(7 if b44a else 6, W, H, True), lpb, H,
                  payloads)


# ---------------------------------------------------------------- reader


def read_exr_py(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    c = _Cursor(buf)
    if c.u32() != _MAGIC:
        raise IOError(f"{path}: not an EXR file")
    version = c.u32()
    if version & 0x200:
        raise IOError(f"{path}: tiled EXR unsupported")

    channels = []
    compression = 0
    dw = (0, 0, 0, 0)
    while True:
        name = c.cstr()
        if not name:
            break
        typ = c.cstr()
        size = c.u32()
        payload_end = c.pos + size
        if name == "channels" and typ == "chlist":
            while True:
                cn = c.cstr()
                if not cn:
                    break
                ptype = c.i32()
                c.read(4 + 8)  # pLinear+reserved, x/y sampling
                channels.append((cn, ptype))
        elif name == "compression":
            compression = c.u8()
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", c.read(16))
        c.pos = payload_end

    W = dw[2] - dw[0] + 1
    H = dw[3] - dw[1] + 1
    lpb = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16, 6: 32, 7: 32}.get(
        compression)
    if lpb is None:
        raise IOError(f"{path}: unsupported compression {compression}")

    nch = len(channels)
    order = {"R": 0, "G": 1, "B": 2}
    chan_out = [order.get(cn, i) for i, (cn, _) in enumerate(channels)]
    dtypes = [np.float16 if pt == 1 else np.float32 for _, pt in channels]
    line_bytes = sum(np.dtype(d).itemsize * W for d in dtypes)

    nblocks = (H + lpb - 1) // lpb
    offsets = [c.u64() for _ in range(nblocks)]

    out = np.zeros((H, W, min(nch, 3) if nch >= 3 else nch), np.float32)
    for off in offsets:
        y0, packed = struct.unpack("<iI", buf[off : off + 8])
        ylo = y0 - dw[1]
        nlines = min(lpb, H - ylo)
        chunk = buf[off + 8 : off + 8 + packed]
        raw_size = line_bytes * nlines
        if compression == 0 or packed >= raw_size:
            raw = chunk
        elif compression == 1:
            raw = _unfilter(_rle_decompress(chunk, raw_size))
        elif compression == 4:
            raw = _decode_piz(chunk, channels, W, nlines)
        elif compression == 5:
            raw = _decode_pxr24(chunk, channels, W, nlines)
        elif compression in (6, 7):
            raw = _decode_b44(chunk, channels, W, nlines,
                              b44a=compression == 7)
        else:
            raw = _unfilter(zlib.decompress(chunk))
        p = 0
        for line in range(nlines):
            y = ylo + line
            for ci, dt in enumerate(dtypes):
                nb = np.dtype(dt).itemsize * W
                vals = np.frombuffer(raw[p : p + nb], dt).astype(np.float32)
                oc = chan_out[ci]
                if oc < out.shape[2]:
                    out[y, :, oc] = vals
                p += nb
    return out
