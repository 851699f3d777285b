"""PIZ (wavelet + Huffman) EXR compression codec, numpy array code.

Port of :mod:`bmfr_tpu.io.piz`, written from the OpenEXR file-format
specification: the same public names, and the same bytes out for the same
input. The native C++ reader (``native/bmfr_io.cpp``) carries an
independent decoder; this module is the encoder the staging writer uses
(:mod:`.exr_py`) and a second, pure-Python decoder to cross-check it.

A PIZ chunk covers up to 32 scanlines and stores, per channel, a
contiguous plane of uint16 samples (FLOAT channels contribute two
interleaved uint16 planes). The pipeline is:

  compress:   bitmap/forward-LUT -> 2-D wavelet -> canonical Huffman
  uncompress: Huffman -> inverse wavelet -> reverse-LUT

Wavelet: per 2x2 quad, average/difference transform, hierarchical by
power-of-two levels; exact integer versions with 14-bit (plain int16)
and 16-bit (mod-2^16 with offset) arithmetic, chosen by the LUT's max
value. Huffman: canonical codes up to 58 bits, code lengths packed in
6-bit fields with zero-run escapes (59..63), a run-length pseudo-symbol
(index ``iM``) followed by an 8-bit repeat count, bits MSB-first.

The encoder works on whole arrays: the Huffman tree is built one weight
level at a time (:func:`_build_lengths`), the code table and the data
become token arrays (a value and a bit count each; the run-length choice
is made for every repeated sample at once), and :func:`_pack_bits`
places every token at its ``cumsum`` offset in 64-bit words. The decoder
stays a sequential, table-driven loop: a Huffman stream is inherently
serial.
"""

from __future__ import annotations

import struct

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3

# ---------------------------------------------------------------- bitmap/LUT


def bitmap_from_data(data: np.ndarray) -> np.ndarray:
    present = np.bincount(np.asarray(data, np.uint16).ravel(),
                          minlength=USHORT_RANGE) > 0
    present[0] = False  # zero is never stored explicitly
    return np.packbits(present, bitorder="little")


def forward_lut(bitmap: np.ndarray):
    """lut mapping data values -> compact indices; returns (lut, maxValue)."""
    present = np.zeros(USHORT_RANGE, bool)
    bits = np.unpackbits(bitmap, bitorder="little")
    present[: bits.size] = bits.astype(bool)
    present[0] = True
    lut = np.zeros(USHORT_RANGE, np.uint16)
    idx = np.flatnonzero(present)
    lut[idx] = np.arange(idx.size, dtype=np.uint16)
    return lut, idx.size - 1


def reverse_lut(bitmap: np.ndarray):
    """lut mapping compact indices -> data values; returns (lut, maxValue)."""
    present = np.zeros(USHORT_RANGE, bool)
    bits = np.unpackbits(bitmap, bitorder="little")
    present[: bits.size] = bits.astype(bool)
    present[0] = True
    idx = np.flatnonzero(present).astype(np.uint16)
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[: idx.size] = idx
    return lut, idx.size - 1


# ------------------------------------------------------------------ wavelet

_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


def _wenc14(a, b):
    a_s = a.astype(np.int16).astype(np.int32)
    b_s = b.astype(np.int16).astype(np.int32)
    m = (a_s + b_s) >> 1
    d = a_s - b_s
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec14(lo, hi):
    ls = lo.astype(np.int16).astype(np.int32)
    hs = hi.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (a.astype(np.int32) - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    m = (ao + b.astype(np.int32)) >> 1
    d = ao - b.astype(np.int32)
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec16(lo, hi):
    m = lo.astype(np.int32)
    d = hi.astype(np.int32)
    b = (m - (d >> 1)) & _MOD_MASK
    a = (d + b - _A_OFFSET) & _MOD_MASK
    return a.astype(np.uint16), b.astype(np.uint16)


def _wav2_level(a, p, p2, fn, encode):
    """One level of the 2-D wavelet at spacing ``p``: every complete
    ``p2``-quad, then the odd remainder column (paired vertically) and
    row (paired horizontally). The quads are strided views of ``a``; each
    is read before any is written."""
    ny, nx = a.shape
    ey, ex = ny - p2 + 1, nx - p2 + 1  # stops of the quads' corners
    ys, xs = slice(0, ey, p2), slice(0, ex, p2)
    ysp, xsp = slice(p, ey + p, p2), slice(p, ex + p, p2)
    if ey > 0 and ex > 0:
        q00, q01, q10, q11 = a[ys, xs], a[ys, xsp], a[ysp, xs], a[ysp, xsp]
        if encode:
            i00, i01 = fn(q00, q01)
            i10, i11 = fn(q10, q11)
            r00, r10 = fn(i00, i10)
            r01, r11 = fn(i01, i11)
        else:
            i00, i10 = fn(q00, q10)
            i01, i11 = fn(q01, q11)
            r00, r01 = fn(i00, i01)
            r10, r11 = fn(i10, i11)
        a[ys, xs], a[ys, xsp], a[ysp, xs], a[ysp, xsp] = r00, r01, r10, r11
    if nx & p and ey > 0:
        x = (ex - 1) // p2 * p2 + p2  # one past the last quad
        a[ys, x], a[ysp, x] = fn(a[ys, x], a[ysp, x])
    if ny & p and ex > 0:
        y = (ey - 1) // p2 * p2 + p2
        a[y, xs], a[y, xsp] = fn(a[y, xs], a[y, xsp])


def wav2_encode(plane: np.ndarray, max_value: int) -> np.ndarray:
    """In-place-style 2-D wavelet encode of a [ny, nx] uint16 plane."""
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    a = plane.copy()
    n = min(a.shape)
    p, p2 = 1, 2
    while p2 <= n:
        _wav2_level(a, p, p2, enc, True)
        p = p2
        p2 <<= 1
    return a


def wav2_decode(plane: np.ndarray, max_value: int) -> np.ndarray:
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    a = plane.copy()
    n = min(a.shape)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        _wav2_level(a, p, p2, dec, False)
        p2 = p
        p >>= 1
    return a


# ------------------------------------------------------------------ Huffman

_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6
_LONGEST_LONG_RUN = 255 + _SHORTEST_LONG_RUN  # 261
_HUF_ENCSIZE = USHORT_RANGE + 1  # one pseudo-symbol slot past 16 bits
_MAX_CODE_LENGTH = 58


def _pack_bits(values: np.ndarray, nbits: np.ndarray):
    """Concatenate tokens MSB-first: token ``k`` is ``values[k]``, which
    fits its ``nbits[k]`` (1..64) bits. Returns ``(bytes, total bits)``,
    the last byte zero-padded. Each token lands at its ``cumsum`` offset
    in big-endian 64-bit words; a token crossing a word boundary spills
    its low bits into the next word."""
    nbits = np.asarray(nbits, np.int64)
    if nbits.size == 0:
        return b"", 0
    values = np.asarray(values, np.uint64)
    ends = np.cumsum(nbits)
    total = int(ends[-1])
    starts = ends - nbits
    word = starts >> 6
    shift = 64 - (starts & 63) - nbits  # < 0: the token spills
    head = (values >> np.maximum(-shift, 0).astype(np.uint64)) << np.maximum(
        shift, 0).astype(np.uint64)
    words = np.zeros(total // 64 + 2, np.uint64)
    first = np.flatnonzero(np.r_[True, word[1:] != word[:-1]])
    words[word[first]] = np.bitwise_or.reduceat(head, first)
    spill = np.flatnonzero(shift < 0)
    words[word[spill] + 1] |= values[spill] << (64 + shift[spill]).astype(
        np.uint64)
    return words.astype(">u8").tobytes()[: (total + 7) // 8], total


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.n = 0

    def get(self, nbits: int) -> int:
        while self.n < nbits:
            if self.pos >= len(self.data):
                raise IOError("truncated PIZ bit stream")
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.n += 8
        self.n -= nbits
        v = (self.acc >> self.n) & ((1 << nbits) - 1)
        self.acc &= (1 << self.n) - 1
        return v

    def align(self):
        self.acc = 0
        self.n = 0


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """OpenEXR canonical code assignment: count codes per length, first
    code per length computed longest-to-shortest, codes assigned in
    increasing symbol order within each length. Returns int64 codes."""
    lengths = np.asarray(lengths, np.int64)
    sym = np.flatnonzero(lengths > 0)
    ls = lengths[sym]
    n = np.bincount(ls, minlength=_MAX_CODE_LENGTH + 1)
    c = 0
    first = np.zeros(_MAX_CODE_LENGTH + 1, np.int64)
    for i in range(_MAX_CODE_LENGTH, 0, -1):
        first[i] = c
        c = (c + int(n[i])) >> 1
    # rank of each symbol among the symbols of its length, in symbol order
    order = np.argsort(ls, kind="stable")
    starts = np.cumsum(n) - n
    rank = np.empty(sym.size, np.int64)
    rank[order] = np.arange(sym.size) - starts[ls[order]]
    codes = np.zeros(lengths.size, np.int64)
    codes[sym] = first[ls] + rank
    return codes


def _build_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths (<= 58 bits) for nonzero-frequency symbols.

    The exact tree of JAX's ``heapq`` construction, whose heap orders by
    (weight, id) with leaves' ids their symbols and each merged node's id
    past every symbol, in the order it was made. Leaves sorted by (weight,
    symbol) and merged nodes in the order made are then two sorted
    queues, and every item of the current least weight ``w`` exists before
    the first of them is merged (a merge makes a weight above ``w``). So
    the items of weight ``w`` (leaves first) pair off in one array step;
    an odd one out pairs with the next least item. Lengths are the leaves'
    depths, found one tree level at a time."""
    freq = np.asarray(freq, np.int64)
    idx = np.flatnonzero(freq)
    if idx.size == 1:
        lengths = np.zeros(freq.size, np.int64)
        lengths[idx[0]] = 1
        return lengths
    n = idx.size
    order = np.lexsort((idx, freq[idx]))
    leaf_w = freq[idx][order]
    node_w = np.empty(n - 1, np.int64)  # merged nodes' weights, made order
    kids = np.empty((n - 1, 2), np.int64)  # node ids: leaf k, merged n + k
    made = li = mi = 0

    def least():
        """(weight, id) of the next item; a leaf wins a tie."""
        if li < n and (mi >= made or leaf_w[li] <= node_w[mi]):
            return int(leaf_w[li]), li
        return int(node_w[mi]), n + mi

    while made < n - 1:
        # items leave the queues in nondecreasing weight, so those of
        # weight w end where w's right insertion point is
        w = least()[0]
        le = int(np.searchsorted(leaf_w, w, "right"))
        me = mi + int(np.searchsorted(node_w[mi:made], w, "right"))
        items = np.concatenate([np.arange(li, le), n + np.arange(mi, me)])
        li, mi = le, me
        m = items.size // 2
        kids[made:made + m, 0] = items[0:2 * m:2]
        kids[made:made + m, 1] = items[1:2 * m:2]
        node_w[made:made + m] = 2 * w
        made += m
        if items.size & 1:
            wy, y = least()
            if y < n:
                li += 1
            else:
                mi += 1
            kids[made] = (items[-1], y)
            node_w[made] = w + wy
            made += 1
    depth = np.zeros(2 * n - 1, np.int64)
    level, d = np.array([2 * n - 2]), 0
    while level.size:
        depth[level] = d
        level = kids[level[level >= n] - n].ravel()
        d += 1
    lengths = np.zeros(freq.size, np.int64)
    lengths[idx[order]] = depth[:n]
    if lengths.max() > _MAX_CODE_LENGTH:
        raise ValueError("huffman code length overflow")
    return lengths


def _enc_table_tokens(lengths: np.ndarray, im: int, iM: int):
    """The packed code-length table of symbols ``im..iM`` as tokens
    ``(values, nbits)``: each length in 6 bits; zero runs of 2-5 as one
    short escape (59..62), of 6 and more as the long escape (63) and an
    8-bit count, a run longer than 261 split into runs of 261 and the
    rest."""
    seg = np.asarray(lengths[im:iM + 1], np.int64)
    nz = np.flatnonzero(seg)
    zero = np.r_[False, seg == 0, False]
    edges = np.flatnonzero(zero[1:] != zero[:-1])
    z_start, z_len = edges[0::2], edges[1::2] - edges[0::2]
    full = z_len // _LONGEST_LONG_RUN
    rest = z_len % _LONGEST_LONG_RUN
    # the full runs of 261 zeros, then each run's rest
    f_run = np.repeat(np.arange(z_start.size), full)
    f_pos = z_start[f_run] + _LONGEST_LONG_RUN * (
        np.arange(f_run.size) - np.repeat(np.cumsum(full) - full, full))
    r_sel = rest > 0
    r_pos = z_start[r_sel] + _LONGEST_LONG_RUN * full[r_sel]
    r_len = rest[r_sel]
    pos = np.concatenate([nz, f_pos, r_pos])
    run = np.concatenate([np.zeros(nz.size, np.int64),
                          np.full(f_pos.size, _LONGEST_LONG_RUN), r_len])
    lit = np.concatenate([seg[nz], np.zeros(run.size - nz.size, np.int64)])
    order = np.argsort(pos, kind="stable")
    run, lit = run[order], lit[order]
    long = run >= _SHORTEST_LONG_RUN
    v1 = np.where(long, _LONG_ZEROCODE_RUN,
                  np.where(run >= 2, _SHORT_ZEROCODE_RUN + run - 2, lit))
    v2 = run - _SHORTEST_LONG_RUN
    values = np.stack([v1, v2], 1).ravel()
    nbits = np.stack([np.full(run.size, 6), np.where(long, 8, 0)],
                     1).ravel()
    keep = nbits > 0
    return values[keep], nbits[keep]


def _pack_enc_table(lengths: np.ndarray, im: int, iM: int) -> bytes:
    """The packed code-length table, zero-padded to a byte."""
    return _pack_bits(*_enc_table_tokens(lengths, im, iM))[0]


def _unpack_enc_table(r: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = r.get(6)
        if l == _LONG_ZEROCODE_RUN:
            run = r.get(8) + _SHORTEST_LONG_RUN
            i += run
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    if i != iM + 1:
        raise IOError("corrupt PIZ huffman table")
    return lengths


def _data_tokens(vals: np.ndarray, lengths: np.ndarray, codes: np.ndarray,
                 rlc: int):
    """The Huffman data stream as tokens ``(values, nbits)``. Each run of
    equal values is coded as its first value, then in pieces of up to 255
    repeats; a piece becomes the run-length symbol ``rlc`` and an 8-bit
    count (both on the piece's first repeat) where that is shorter than
    the piece coded literally. Every sample starts as its literal code;
    only the repeats are then decided, all at once."""
    sym = vals.astype(np.intp)
    values, nbits = codes[sym], lengths[sym]
    rep = np.flatnonzero(vals[1:] == vals[:-1]) + 1
    if rep.size == 0:
        return values, nbits
    start = np.flatnonzero(np.r_[True, vals[1:] != vals[:-1]])
    run = np.searchsorted(start, rep, "right") - 1
    run_end = np.append(start[1:], vals.size)[run]
    piece_off = (rep - start[run] - 1) % 255  # position within the piece
    size = np.minimum(255, run_end - (rep - piece_off))
    rlc_l, rlc_c = int(lengths[rlc]), int(codes[rlc])
    in_rlc = size * nbits[rep] > rlc_l + 8
    head = in_rlc & (piece_off == 0)
    values[rep[in_rlc]] = rlc_c
    nbits[rep[in_rlc]] = np.where(head[in_rlc], rlc_l, 0)
    after_head = rep[head] + 1
    values = np.insert(values, after_head, size[head])
    nbits = np.insert(nbits, after_head, 8)
    keep = nbits > 0
    return values[keep], nbits[keep]


def huf_compress(data: np.ndarray) -> bytes:
    data = data.astype(np.uint16).ravel()
    if data.size == 0:
        return b""
    freq = np.bincount(data, minlength=_HUF_ENCSIZE).astype(np.int64)
    present = np.flatnonzero(freq)
    im = int(present[0])
    # run-length pseudo-symbol one past the largest data symbol
    iM = int(present[-1]) + 1
    freq[iM] = 1
    lengths = _build_lengths(freq)
    codes = _canonical_codes(lengths)
    table_bytes = _pack_enc_table(lengths, im, iM)
    body, nbits = _pack_bits(*_data_tokens(data, lengths, codes, iM))
    head = struct.pack("<IIIII", im, iM, len(table_bytes), nbits, 0)
    return head + table_bytes + body


def huf_decompress(comp: bytes, n_out: int) -> np.ndarray:
    if n_out == 0:
        return np.zeros(0, np.uint16)
    if len(comp) < 20:
        raise IOError("corrupt PIZ huffman header")
    im, iM, _table_len, nbits, _ = struct.unpack("<IIIII", comp[:20])
    if im >= _HUF_ENCSIZE or iM >= _HUF_ENCSIZE or im > iM:
        raise IOError("corrupt PIZ huffman header")
    r = _BitReader(comp, 20)
    lengths = _unpack_enc_table(r, im, iM)
    if r.n:
        r.align()
    codes = _canonical_codes(lengths)
    rlc = iM

    # decode table: direct lookup for codes <= 14 bits, dict for longer
    DEC = 14
    table_sym = np.full(1 << DEC, -1, np.int64)
    table_len = np.zeros(1 << DEC, np.int64)
    long_codes = {}
    for s in np.flatnonzero(lengths > 0):
        l = int(lengths[s])
        c = int(codes[s])
        if l <= DEC:
            base = c << (DEC - l)
            table_sym[base : base + (1 << (DEC - l))] = s
            table_len[base : base + (1 << (DEC - l))] = l
        else:
            long_codes[(l, c)] = int(s)

    out = np.zeros(n_out, np.uint16)
    oi = 0
    data = r.data
    pos = r.pos
    acc = 0
    nacc = 0
    consumed = 0
    end = len(data)
    while oi < n_out and consumed < nbits:
        while nacc < DEC and pos < end:
            acc = (acc << 8) | data[pos]
            pos += 1
            nacc += 8
        if nacc >= DEC:
            peek = (acc >> (nacc - DEC)) & ((1 << DEC) - 1)
        else:
            peek = (acc << (DEC - nacc)) & ((1 << DEC) - 1)
        s = table_sym[peek]
        if s >= 0:
            l = int(table_len[peek])
        else:
            # long code: extend bit by bit beyond DEC
            l = DEC + 1
            while True:
                while nacc < l and pos < end:
                    acc = (acc << 8) | data[pos]
                    pos += 1
                    nacc += 8
                if nacc < l:
                    raise IOError("corrupt PIZ huffman data")
                c = (acc >> (nacc - l)) & ((1 << l) - 1)
                if (l, c) in long_codes:
                    s = long_codes[(l, c)]
                    break
                l += 1
                if l > _MAX_CODE_LENGTH:
                    raise IOError("corrupt PIZ huffman data")
        if nacc < l:
            raise IOError("corrupt PIZ huffman data")
        nacc -= l
        acc &= (1 << nacc) - 1
        consumed += l
        if s == rlc:
            while nacc < 8 and pos < end:
                acc = (acc << 8) | data[pos]
                pos += 1
                nacc += 8
            if nacc < 8:
                raise IOError("corrupt PIZ huffman data")
            nacc -= 8
            cnt = (acc >> nacc) & 0xFF
            acc &= (1 << nacc) - 1
            consumed += 8
            if oi == 0 or oi + cnt > n_out:
                raise IOError("corrupt PIZ run length")
            out[oi : oi + cnt] = out[oi - 1]
            oi += cnt
        else:
            out[oi] = s
            oi += 1
    if oi != n_out:
        raise IOError("truncated PIZ huffman data")
    return out


# ---------------------------------------------------------------- PIZ chunk


def piz_compress(channels) -> bytes:
    """channels: list of ``(buf, size)`` where ``buf`` is a
    ``[ny, nx*size]`` uint16 channel buffer (FLOAT channels interleave
    their two uint16 halves, ``size``=2; HALF channels ``size``=1) in
    file channel order. The wavelet runs per interleaved sub-plane with
    stride ``size``; the Huffman stream keeps the interleaved order."""
    flat = np.concatenate([buf.ravel() for buf, _ in channels])
    bitmap = bitmap_from_data(flat)
    lut, max_value = forward_lut(bitmap)
    nz = np.flatnonzero(bitmap)
    if nz.size:
        min_nz, max_nz = int(nz[0]), int(nz[-1])
    else:
        min_nz, max_nz = BITMAP_SIZE - 1, 0  # empty bitmap convention

    pieces = []
    for buf, size in channels:
        mapped = lut[buf]
        enc = np.empty_like(mapped)
        for j in range(size):
            enc[:, j::size] = wav2_encode(
                np.ascontiguousarray(mapped[:, j::size]), max_value)
        pieces.append(enc.ravel())
    huf = huf_compress(np.concatenate(pieces))

    out = bytearray(struct.pack("<HH", min_nz, max_nz))
    if min_nz <= max_nz:
        out += bitmap[min_nz : max_nz + 1].tobytes()
    out += struct.pack("<i", len(huf))
    out += huf
    return bytes(out)


def piz_uncompress(comp: bytes, channel_shapes) -> list:
    """Inverse of :func:`piz_compress`.

    channel_shapes: list of ``(ny, nx, size)`` per channel; returns
    ``[ny, nx*size]`` uint16 buffers in the same order."""
    if len(comp) < 4:
        raise IOError("corrupt PIZ chunk")
    min_nz, max_nz = struct.unpack("<HH", comp[:4])
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        nbytes = max_nz - min_nz + 1
        if pos + nbytes > len(comp):
            raise IOError("corrupt PIZ bitmap")
        bitmap[min_nz : max_nz + 1] = np.frombuffer(
            comp[pos : pos + nbytes], np.uint8)
        pos += nbytes
    lut, max_value = reverse_lut(bitmap)
    if pos + 4 > len(comp):
        raise IOError("corrupt PIZ chunk")
    (huf_len,) = struct.unpack("<i", comp[pos : pos + 4])
    pos += 4
    if huf_len < 0 or pos + huf_len > len(comp):
        raise IOError("corrupt PIZ chunk length")
    total = sum(ny * nx * size for ny, nx, size in channel_shapes)
    data = huf_decompress(comp[pos : pos + huf_len], total)

    out = []
    off = 0
    for ny, nx, size in channel_shapes:
        buf = data[off : off + ny * nx * size].reshape(ny, nx * size)
        off += ny * nx * size
        dec = np.empty_like(buf)
        for j in range(size):
            dec[:, j::size] = wav2_decode(
                np.ascontiguousarray(buf[:, j::size]), max_value)
        out.append(lut[dec])
    return out
