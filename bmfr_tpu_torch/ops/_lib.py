"""Build and load the port's CUDA kernels (``bmfr_tpu_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into
``bmfr_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. The file name carries a digest of the sources, so an edited
kernel is rebuilt. A missing ``nvcc`` or a failed build raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("warp_blend.cu", "fitter_chol.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points and their argument types (pointers and the stream as
#: c_void_p, so ctypes never cuts them to 32 bits)
_SIGNATURES = {
    # src8, positions, normals, pfx, pfy, out, H, W, pos_lim, nrm_lim, stream
    "bmfr_warp_blend": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
    # normals, positions, accum, noise, out, weights, H, W, blocks_x,
    # blocks_y, ox, oy, stream
    "bmfr_fit_reconstruct_cholesky": (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _P),
}

_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path():
    """Where the library for the current sources lives."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libbmfr_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose=False):
    """Compile the kernels if the library for these sources is missing.
    Returns the library path. ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's report (registers, shared memory, spills)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *[str(CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name, *args):
    """Call C entry point ``name`` on the current stream; raise if the
    launch reported a CUDA error."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_tensor(t, name, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
