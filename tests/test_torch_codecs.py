"""The port's EXR and PNG codecs (``bmfr_tpu_torch/io/piz.py``,
``exr_py.py``, ``png.py``) against the JAX package's on the CPU. The bar
is bytes: the port's encoders must write exactly the JAX package's bytes
over the cases of ``tests/test_exr_conformance.py`` (deep Huffman codes,
degenerate distributions, the code table's zero-run escapes, the
wavelet's 14/16-bit switch, every finite half pattern, chunk boundaries,
B44 and B44A block geometries), and its readers must return the JAX
readers' arrays, and the native reader's, on files from both writers."""

import struct
import zlib

import numpy as np
import pytest

from bmfr_tpu.io import exr_py as jax_exr_py
from bmfr_tpu.io import native as jax_native
from bmfr_tpu.io import piz as jax_piz
from bmfr_tpu.io import png as jax_png
from bmfr_tpu_torch.io import exr_py, native, piz, png


def jax_enc_table(lengths, im, iM):
    w = jax_piz._BitWriter()
    jax_piz._pack_enc_table(w, lengths, im, iM)
    w.flush()
    return bytes(w.out)


def fib_skewed_symbols(depth=22, seed=3):
    """Fibonacci frequencies: a maximally skewed Huffman tree, codes
    longer than the decoder's 14-bit table."""
    fibs = [1, 1]
    while len(fibs) < depth:
        fibs.append(fibs[-1] + fibs[-2])
    data = np.concatenate([np.full(f, i * 37, np.uint16)
                           for i, f in enumerate(fibs)])
    np.random.default_rng(seed).shuffle(data)
    return data


def half_img(bits_u16):
    return bits_u16.astype(np.uint16).view(np.float16).astype(np.float32)


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def both_write(tmp_path, name, write_port, write_jax):
    """Write one file with each package; assert equal bytes; return the
    port's path."""
    p, j = tmp_path / f"{name}.port.exr", tmp_path / f"{name}.jax.exr"
    write_port(str(p))
    write_jax(str(j))
    assert p.read_bytes() == j.read_bytes(), name
    return str(p)


def readers_agree(path, expect=None):
    """The port's Python reader equals JAX's and the native reader, bit
    for bit (and ``expect`` when given)."""
    got = exr_py.read_exr_py(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(bits(got),
                                  bits(jax_exr_py.read_exr_py(path)))
    np.testing.assert_array_equal(bits(got), bits(native.read_exr(path)))
    if expect is not None:
        np.testing.assert_array_equal(bits(got), bits(expect))
    return got


# ------------------------------------------------------------ Huffman


@pytest.mark.parametrize("runs", [
    [1], [2], [5], [jax_piz._SHORTEST_LONG_RUN - 1],
    [jax_piz._SHORTEST_LONG_RUN], [jax_piz._SHORTEST_LONG_RUN + 1],
    [255 + jax_piz._SHORTEST_LONG_RUN],
    [255 + jax_piz._SHORTEST_LONG_RUN + 3],
    [1, 2, 6, 300, 2, 1], [2 * 261 + 7, 261]])
def test_enc_table_zero_run_escapes_bytes(runs):
    lengths = np.zeros(piz._HUF_ENCSIZE, np.int64)
    i = 5
    lengths[i] = 12
    for run in runs:
        i += 1 + run
        lengths[i] = (i % 20) + 1
    got = piz._pack_enc_table(lengths, 5, i)
    assert got == jax_enc_table(lengths, 5, i)
    back = piz._unpack_enc_table(piz._BitReader(got), 5, i)
    np.testing.assert_array_equal(back[5:i + 1], lengths[5:i + 1])


def test_enc_table_trailing_values_and_max_length():
    lengths = np.zeros(piz._HUF_ENCSIZE, np.int64)
    lengths[0], lengths[1], lengths[-1] = 58, 1, 30
    iM = piz._HUF_ENCSIZE - 1
    assert piz._pack_enc_table(lengths, 0, iM) == jax_enc_table(lengths, 0,
                                                                  iM)


def random_freqs(seed):
    rng = np.random.default_rng(seed)
    freq = np.zeros(piz._HUF_ENCSIZE, np.int64)
    n = int(rng.integers(2, 3000))
    sym = rng.choice(piz._HUF_ENCSIZE, n, replace=False)
    kind = seed % 3
    if kind == 0:  # many ties
        freq[sym] = rng.integers(1, 5, n)
    elif kind == 1:
        freq[sym] = rng.integers(1, 1000, n)
    else:  # heavy tail
        freq[sym] = np.maximum(1, (rng.pareto(1.0, n) * 10).astype(np.int64))
    return freq


@pytest.mark.parametrize("seed", range(12))
def test_build_lengths_and_codes_equal_jax(seed):
    freq = random_freqs(seed)
    lengths = piz._build_lengths(freq)
    np.testing.assert_array_equal(lengths, jax_piz._build_lengths(freq))
    np.testing.assert_array_equal(piz._canonical_codes(lengths),
                                  jax_piz._canonical_codes(lengths))


def test_build_lengths_deep_and_overflow():
    data = fib_skewed_symbols()
    freq = np.bincount(data, minlength=piz._HUF_ENCSIZE).astype(np.int64)
    lengths = piz._build_lengths(freq)
    assert lengths.max() > 14
    np.testing.assert_array_equal(lengths, jax_piz._build_lengths(freq))
    deep = np.zeros(piz._HUF_ENCSIZE, np.int64)
    fibs = [1, 1]
    while len(fibs) < 62:
        fibs.append(fibs[-1] + fibs[-2])
    deep[:62] = fibs
    for build in (piz._build_lengths, jax_piz._build_lengths):
        with pytest.raises(ValueError, match="overflow"):
            build(deep)


HUF_CASES = {
    "deep": fib_skewed_symbols(),
    "one_symbol_run": np.full(5000, 7, np.uint16),
    "extreme_span": np.array([0, 65534], np.uint16),
    "run_splits_at_255": np.concatenate(
        [np.full(255, 3, np.uint16), np.full(256, 3, np.uint16),
         np.full(300, 9, np.uint16)]),
    "one_element": np.array([1], np.uint16),
    "zeros": np.zeros(1000, np.uint16),
    "ramp": np.arange(5000).astype(np.uint16),
    "max_value": np.full(7, 65535, np.uint16),
    "long_runs": np.repeat(np.arange(20, dtype=np.uint16), 400),
    "random_runs": np.repeat(
        np.random.default_rng(4).integers(0, 65536, 300).astype(np.uint16),
        np.random.default_rng(5).integers(1, 700, 300)),
}


@pytest.mark.parametrize("case", sorted(HUF_CASES))
def test_huf_compress_bytes_equal_jax(case):
    data = HUF_CASES[case]
    comp = piz.huf_compress(data)
    assert comp == jax_piz.huf_compress(data)
    np.testing.assert_array_equal(piz.huf_decompress(comp, data.size), data)


def test_huf_decompress_rejects_corrupt():
    comp = piz.huf_compress(np.arange(100).astype(np.uint16))
    for bad in (comp[:10], comp[:24]):
        with pytest.raises(IOError):
            piz.huf_decompress(bad, 100)


# ------------------------------------------------------------ wavelet


@pytest.mark.parametrize("mx", [(1 << 14) - 2, (1 << 14) - 1, 1 << 14,
                                (1 << 14) + 1, (1 << 16) - 1])
@pytest.mark.parametrize("shape", [(32, 32), (33, 31), (1, 7), (7, 1),
                                   (2, 2), (5, 64)])
def test_wavelet_equal_jax_at_mode_switch(mx, shape):
    rng = np.random.default_rng(mx % 97 + shape[0])
    plane = rng.integers(0, mx + 1, size=shape).astype(np.uint16)
    plane.flat[0], plane.flat[-1] = mx, 0
    enc = piz.wav2_encode(plane, mx)
    np.testing.assert_array_equal(enc, jax_piz.wav2_encode(plane, mx))
    np.testing.assert_array_equal(piz.wav2_decode(enc, mx), plane)


# ------------------------------------------------------------ PIZ chunks


def test_piz_chunk_mixed_channels_bytes():
    rng = np.random.default_rng(3)
    bufs = [(rng.random((16, 40)).astype(np.float16).view(np.uint16), 1),
            (rng.random((16, 40)).astype(np.float32).view(np.uint16), 2)]
    comp = piz.piz_compress(bufs)
    assert comp == jax_piz.piz_compress(bufs)
    out = piz.piz_uncompress(comp, [(16, 40, 1), (16, 40, 2)])
    for (b, _), o in zip(bufs, out):
        np.testing.assert_array_equal(b, o)


def test_piz_every_finite_half_pattern(tmp_path):
    """Every finite half bit pattern: the whole bitmap/LUT domain."""
    b = np.arange(1 << 16, dtype=np.uint32)
    finite = b[(b & 0x7C00) != 0x7C00]
    n = finite.size // 256 * 256
    img = np.repeat(half_img(finite[:n].reshape(-1, 256))[..., None], 3, 2)
    img[:, :, 1] = img[::-1, :, 1]
    p = both_write(
        tmp_path, "allhalf",
        lambda q: exr_py.write_exr_py(q, img, half=True, compression="piz"),
        lambda q: jax_exr_py.write_exr_py(q, img, half=True,
                                          compression="piz"))
    np.testing.assert_array_equal(bits(native.read_exr(p)), bits(img))


def test_piz_deep_codes_in_file(tmp_path):
    data = fib_skewed_symbols(depth=23, seed=11)
    n = data.size // 64 * 64
    img = np.repeat(half_img(data[:n].reshape(-1, 64))[..., None], 3, 2)
    p = both_write(
        tmp_path, "deep",
        lambda q: exr_py.write_exr_py(q, img, half=True, compression="piz"),
        lambda q: jax_exr_py.write_exr_py(q, img, half=True,
                                          compression="piz"))
    readers_agree(p, img)


# ------------------------------------------------------------ files


@pytest.mark.parametrize("compression", ["piz", "pxr24"])
@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("H", [1, 15, 16, 17, 31, 32, 33, 65])
def test_write_exr_py_bytes_at_chunk_boundaries(tmp_path, compression, half,
                                                H):
    rng = np.random.default_rng(H * 4 + 2 * half + (compression == "piz"))
    img = (rng.standard_normal((H, 29, 3)) * 100).astype(np.float32)
    img[0, 0] = 0.0
    p = both_write(
        tmp_path, f"{compression}{half}{H}",
        lambda q: exr_py.write_exr_py(q, img, half=half,
                                      compression=compression),
        lambda q: jax_exr_py.write_exr_py(q, img, half=half,
                                          compression=compression))
    readers_agree(p)


def test_write_exr_py_stores_raw_when_incompressible(tmp_path):
    """Random bit patterns do not compress: the chunk is stored raw."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 1 << 32, (5, 9, 3), dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    img[np.isnan(img)] = 1.0
    for comp in ("piz", "pxr24"):
        p = both_write(
            tmp_path, f"raw{comp}",
            lambda q: exr_py.write_exr_py(q, img, half=False,
                                          compression=comp),
            lambda q: jax_exr_py.write_exr_py(q, img, half=False,
                                              compression=comp))
        readers_agree(p)


@pytest.mark.parametrize("compression", ["zip", "zips"])
@pytest.mark.parametrize("half", [True, False])
def test_native_writer_bytes_equal_jax(tmp_path, compression, half):
    """ZIP and ZIPS go through the native library in both packages (the
    port builds the same source): equal bytes."""
    img = np.random.default_rng(2).normal(0.4, 0.3, (37, 45, 3)).astype(
        np.float32)
    p = both_write(
        tmp_path, f"{compression}{half}",
        lambda q: native.write_exr(q, img, half=half,
                                   compression=compression),
        lambda q: jax_native.write_exr(q, img, half=half,
                                       compression=compression))
    readers_agree(p)


def f24_scalar(i):
    """OpenEXR's floatToFloat24 (ImfPxr24Compressor.cpp), one value."""
    s, e, m = i & 0x80000000, i & 0x7F800000, i & 0x007FFFFF
    if e == 0x7F800000:
        if m:
            m >>= 8
            i24 = (e >> 8) | m | int(m == 0)
        else:
            i24 = e >> 8
    else:
        i24 = ((e | m) + (m & 0x80) + 0x3F) >> 8
        if i24 >= 0x7F8000:
            i24 = (e | m) >> 8
    return (s >> 8) | i24


def test_pxr24_rounding_edges_and_delta_wrap(tmp_path):
    pats = np.array([0x3F800080, 0x3F800180, 0x3F80007F, 0x3F800081,
                     0x7F800001, 0x7FC00000, 0xFF800055, 0x7F7FFFFF,
                     0xFF7FFFC0, 0x7F800000, 0xFF800000, 0x00000001,
                     0x80000000], np.uint32)
    got = exr_py._float_to_float24(pats.view(np.float32))
    np.testing.assert_array_equal(got, [f24_scalar(int(x)) for x in pats])
    np.testing.assert_array_equal(
        got, jax_exr_py._float_to_float24(pats.view(np.float32)))
    exps = np.linspace(-60, 60, 41 * 61).reshape(41, 61)
    ramp = (2.0 ** exps).astype(np.float32)
    ramp[::2, ::2] *= -1.0
    for name, img in (
            ("edges", np.resize(pats.view(np.float32), (3, 5, 3)).copy()),
            ("wrap", np.stack([ramp, np.nextafter(ramp, np.float32(np.inf)),
                               np.nextafter(ramp, np.float32(-np.inf))],
                              -1))):
        p = both_write(
            tmp_path, name,
            lambda q: exr_py.write_exr_py(q, img, half=False,
                                          compression="pxr24"),
            lambda q: jax_exr_py.write_exr_py(q, img, half=False,
                                              compression="pxr24"))
        expect = (exr_py._float_to_float24(img) << np.uint32(8)).view(
            np.float32)
        readers_agree(p, expect)


def b44_blocks(kind, n=200, seed=0):
    """Blocks of 16 transformed samples that reach every branch of the
    shift choice: exact at shift 0, exact at larger shifts, feasible but
    lossy, infeasible at every shift, flat, and near the 16-bit wrap."""
    rng = np.random.default_rng(seed + kind)
    out = []
    for _ in range(n):
        if kind == 0:
            b = rng.integers(0, 1 << 16, 16)
        elif kind == 1:
            b = rng.integers(30000, 30000 + (2 << int(rng.integers(0, 15))),
                             16)
        elif kind == 2:
            b = (rng.integers(0, 64, 16) << int(rng.integers(0, 12))) \
                + int(rng.integers(0, 60000))
        elif kind == 3:
            b = np.full(16, rng.integers(0, 1 << 16))
        elif kind == 4:
            b = rng.choice([0, 1, 32767, 32768, 65534, 65535], 16)
        else:
            b = np.cumsum(rng.integers(-3000, 3000, 16))
        out.append(np.asarray(b, np.int64) & 0xFFFF)
    return np.stack(out)


@pytest.mark.parametrize("kind", range(6))
def test_b44_block_packing_equal_jax(kind):
    t = b44_blocks(kind)
    want = np.stack([np.frombuffer(jax_exr_py._b44_pack14(
        [int(v) for v in b]), np.uint8) for b in t])
    np.testing.assert_array_equal(exr_py._b44_encode_blocks(t), want)
    np.testing.assert_array_equal(
        exr_py._b44_decode_blocks(want),
        [jax_exr_py._b44_unpack14(bytes(b)) for b in want])


@pytest.mark.parametrize("b44a", [False, True])
@pytest.mark.parametrize("shape", [(4, 4), (3, 5), (17, 18), (33, 31),
                                   (1, 1), (70, 9)])
def test_write_exr_b44_bytes(tmp_path, b44a, shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1] + b44a)
    img = half_img(rng.integers(0, 0x7C00, size=shape + (3,)))
    img[:, : shape[1] // 2, 1] = 0.25  # flat blocks beside rough ones
    p = both_write(
        tmp_path, f"b44{b44a}{shape}",
        lambda q: exr_py.write_exr_b44(q, img, b44a=b44a),
        lambda q: jax_exr_py.write_exr_b44(q, img, b44a=b44a))
    readers_agree(p)


@pytest.mark.parametrize("b44a", [False, True])
def test_write_exr_b44_smooth_flat_and_special(tmp_path, b44a):
    """Smooth blocks (exact at shift 0), a flat image with ragged edges,
    and inf/NaN (B44 stores them as 0)."""
    smooth = (0.5 + np.linspace(0, 0.002, 40 * 52 * 3)).reshape(
        40, 52, 3).astype(np.float32)
    flat = np.full((19, 27, 3), np.float32(0.25))
    flat[12:16, 20:24, 0] = 1.5
    special = np.random.default_rng(7).random((9, 10, 3)).astype(np.float32)
    special[0, :3] = [np.inf, -np.inf, np.nan]
    for name, img, exact in (("smooth", smooth, True), ("flat", flat, True),
                             ("special", special, False)):
        p = both_write(
            tmp_path, f"{name}{b44a}",
            lambda q: exr_py.write_exr_b44(q, img, b44a=b44a),
            lambda q: jax_exr_py.write_exr_b44(q, img, b44a=b44a))
        got = readers_agree(p)
        if exact:
            np.testing.assert_array_equal(
                got, img.astype(np.float16).astype(np.float32))


def test_write_exr_rejects_non_rgb(tmp_path):
    img = np.zeros((4, 4, 2), np.float32)
    with pytest.raises(ValueError, match="3 channels"):
        exr_py.write_exr_py(str(tmp_path / "a.exr"), img)
    with pytest.raises(ValueError, match="3 channels"):
        exr_py.write_exr_b44(str(tmp_path / "b.exr"), img)


# ------------------------------------------------------------ PNG


def encode_png(img, filter_type, bitdepth=8):
    """A PNG with one filter type on every row (the streams the readers
    must invert); ``filter_type`` None cycles 0-4 row by row."""
    h, w, c = img.shape
    bpp = c * bitdepth // 8
    data = np.frombuffer(img.astype(">u2" if bitdepth == 16 else np.uint8)
                         .tobytes(), np.uint8).reshape(h, w * bpp)
    raw, prev = bytearray(), np.zeros(w * bpp, np.int64)
    for y in range(h):
        ft = y % 5 if filter_type is None else filter_type
        row = data[y].astype(np.int64)
        left = np.r_[np.zeros(bpp, np.int64), row[:-bpp]]
        upleft = np.r_[np.zeros(bpp, np.int64), prev[:-bpp]]
        if ft == 0:
            pred = np.zeros_like(row)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw.append(ft)
        raw += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bitdepth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels,bitdepth", [(1, 8), (2, 8), (3, 8),
                                               (4, 8), (1, 16), (3, 16),
                                               (4, 16)])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, None])
def test_read_png_equal_jax(tmp_path, channels, bitdepth, filter_type):
    rng = np.random.default_rng(channels * 10 + bitdepth)
    maxv = 65535 if bitdepth == 16 else 255
    img = rng.integers(0, maxv + 1, (13, 11, channels)).astype(
        np.uint16 if bitdepth == 16 else np.uint8)
    p = tmp_path / "x.png"
    p.write_bytes(encode_png(img, filter_type, bitdepth))
    got = png.read_png(str(p))
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jax_png.read_png(str(p)))
    rgb = png.read_png_rgb01_py(str(p))
    np.testing.assert_array_equal(rgb, jax_png.read_png_rgb01_py(str(p)))
    np.testing.assert_array_equal(bits(rgb), bits(png.read_png_rgb01(p)))


def test_read_png_rejects_bad_input(tmp_path):
    p = tmp_path / "bad.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\nnot really a png at all")
    with pytest.raises(ValueError):
        png.read_png(str(p))
    with pytest.raises(IOError):
        png.read_png_rgb01(str(p))
    q = tmp_path / "sig.png"
    q.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="signature"):
        png.read_png_rgb01_py(str(q))
