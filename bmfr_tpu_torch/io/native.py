"""ctypes bindings to the repository's native C++ IO runtime.

``native/bmfr_io.cpp`` holds a minimal EXR reader (scanline; NONE, RLE,
ZIPS, ZIP, PIZ, PXR24, B44 and B44A; half and float channels) and writer
(NONE, RLE, ZIPS, ZIP), a zlib PNG writer and reader, and a pthread batch
loader: the counterpart of the reference's OpenImageIO IO and its
OpenMP-parallel frame loop (opencl/bmfr.cpp:252-313, :519-553). The C
entry points are those of :mod:`bmfr_tpu.io.native`.

At first use the source is compiled with ``g++ -O2 -std=c++17 -fPIC
-shared ... -lz -lpthread`` into ``bmfr_tpu_torch/_build/`` (listed in
``.gitignore``), under a name that carries a digest of the source, so an
edited source is rebuilt and the prebuilt library tracked in ``native/``
is never written. A failed build raises with the compiler's output: no
Python EXR codec stands behind this module. Every call releases the
interpreter lock while the native code runs (ctypes does), so a loader
thread decodes while the main thread launches kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "bmfr_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lz", "-lpthread")

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
#: C entry points and their argument types (buffers as c_void_p)
_SIGNATURES = {
    "bmfr_exr_read_header": (ctypes.c_char_p, _IP, _IP, _IP),
    "bmfr_exr_read": (ctypes.c_char_p, _P, _I, _I, _I),
    "bmfr_exr_write_ex": (ctypes.c_char_p, _P, _I, _I, _I, _I, _I),
    "bmfr_png_write": (ctypes.c_char_p, _P, _I, _I, _I),
    "bmfr_png_probe": (ctypes.c_char_p, _IP, _IP),
    "bmfr_png_read": (ctypes.c_char_p, _P, _I, _I),
    "bmfr_load_frames": (ctypes.POINTER(ctypes.c_char_p), _I, _P, _I, _I,
                         _I, _I),
}

EXR_COMPRESSION = {"none": 0, "rle": 1, "zips": 2, "zip": 3}

_lib = None
_lock = threading.Lock()


def library_path():
    """Where the library for the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libbmfr_io_{digest.hexdigest()[:16]}.so"


def build():
    """Compile ``native/bmfr_io.cpp`` if the library for this source is
    missing; return its path. Raises with the compiler's output on a
    failed build."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the native IO "
                           f"library cannot be built from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile under a private name, then rename: a concurrent build never
    # loads a half-written library
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", str(work / "lib.so"), str(SOURCE),
               *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native IO library failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(work / "lib.so", out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def library():
    """The loaded IO library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bmfr_last_error.argtypes = []
            lib.bmfr_last_error.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib, rc, what):
    if rc != 0:
        msg = lib.bmfr_last_error()
        raise IOError(f"{what}: "
                      f"{msg.decode() if msg else 'native IO error'}")


def check_out(out, shape, dtype=np.float32):
    """Raise unless ``out`` is a writeable C-contiguous ``dtype`` array
    of ``shape`` (native code writes through its pointer); return it."""
    if (out.dtype != dtype or tuple(out.shape) != tuple(shape)
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous "
                         f"{np.dtype(dtype)} array of shape {tuple(shape)}, "
                         f"got {out.dtype} {out.shape}")
    return out


def read_exr(path: str) -> np.ndarray:
    """An EXR as f32 ``[H, W, C]``."""
    lib = library()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.bmfr_exr_read_header(path.encode(), w, h, c), path)
    out = np.empty((h.value, w.value, c.value), np.float32)
    _check(lib, lib.bmfr_exr_read(path.encode(), out.ctypes.data, w.value,
                                  h.value, c.value), path)
    return out


def write_exr(path: str, img: np.ndarray, half: bool = False,
              compression: str = "zip"):
    """Write f32 ``[H, W, C]`` as an EXR (float or half channels)."""
    lib = library()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    _check(lib, lib.bmfr_exr_write_ex(
        path.encode(), img.ctypes.data, w, h, c, 1 if half else 0,
        EXR_COMPRESSION[compression]), path)


def write_png(path: str, img_u8: np.ndarray):
    """Write u8 ``[H, W, C]`` as a PNG."""
    lib = library()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img_u8.shape
    _check(lib, lib.bmfr_png_write(path.encode(), img_u8.ctypes.data, w, h,
                                   c), path)


def read_png_rgb01(path: str) -> np.ndarray:
    """A PNG as f32 RGB ``[H, W, 3]`` in [0, 1]."""
    lib = library()
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.bmfr_png_probe(path.encode(), w, h), path)
    out = np.empty((h.value, w.value, 3), np.float32)
    _check(lib, lib.bmfr_png_read(path.encode(), out.ctypes.data, w.value,
                                  h.value), path)
    return out


def load_frames(paths, width, height, channels=3, threads=0, out=None):
    """Threaded batch EXR load (the OpenMP parallel-for of
    opencl/bmfr.cpp:259-307): f32 ``[N, H, W, C]``, decoded into ``out``
    when given (e.g. a pinned host buffer)."""
    lib = library()
    n = len(paths)
    shape = (n, height, width, channels)
    out = np.empty(shape, np.float32) if out is None else check_out(out,
                                                                    shape)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    _check(lib, lib.bmfr_load_frames(arr, n, out.ctypes.data, width, height,
                                     channels, threads), "load_frames")
    return out
