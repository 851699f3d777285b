"""Build and load the port's CUDA kernels (``bmfr_tpu_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c``
per source, all started together) and linked into one shared library
with a plain C interface, at first use, into ``bmfr_tpu_torch/_build/``
(listed in ``.gitignore``), and loaded with ``ctypes``. The file name
carries a digest of the sources and headers, so an edited kernel is
rebuilt. A missing ``nvcc`` or a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("warp_blend.cu", "fitter_chol.cu", "fitter_chol_basis.cu",
           "householder_blocks.cu", "householder_blocks_smem.cu",
           "householder_direct.cu", "householder_direct_basis.cu",
           "warp_rows.cu", "reproject.cu", "noisy_tail.cu",
           "filtered_tail.cu", "warp_taps.cu", "feature_blocks.cu",
           "block_reconstruct.cu")
HEADERS = ("fitter_front.cuh", "householder.cuh", "basis_front.cuh",
           "torch_ops.cuh", "feature_table.cuh", "tap_blend.cuh")
#: the device kernels the sources define (``__global__`` names), as a
#: profiler trace names them
KERNELS = ("warp_blend_kernel", "fit_chol_kernel", "fit_chol_basis_kernel",
           "fit_blocks_regs_kernel", "fit_blocks_smem_kernel",
           "fit_direct_kernel", "fit_direct_basis_kernel", "warp_rows_kernel",
           "reproject_kernel", "noisy_tail_kernel", "filtered_tail_kernel",
           "filtered_tail_k4_kernel", "warp_taps_kernel",
           "feature_blocks_kernel", "block_reconstruct_kernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U64 = ctypes.c_ulonglong
#: C entry points and their argument types (pointers and the stream as
#: c_void_p, so ctypes never cuts them to 32 bits)
_SIGNATURES = {
    # src8, positions, normals, pfx, pfy, out, H, W, pos_lim, nrm_lim, stream
    "bmfr_warp_blend": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
    # normals, positions, accum, out, weights, H, W, blocks_x, blocks_y,
    # frame (a device int), mode, noise_amp, stream
    "bmfr_fit_reconstruct_cholesky": (_P,) * 5 + (_I,) * 4 + (_P, _I, _F,
                                                              _P),
    # normals, positions, accum, out, weights, mins_maxs, H, W, blocks_x,
    # blocks_y, frame, mode, noise_amp, stream
    "bmfr_fit_direct_householder": (_P,) * 6 + (_I,) * 4 + (_P, _I, _F,
                                                            _P),
    # accum, planes (a host array of F plane addresses), ops_lo, ops_hi,
    # out, weights, H, W, blocks_x, blocks_y, F, lo, frame, mode,
    # noise_amp, stream (any basis: fitter_direct.plane_table)
    "bmfr_fit_reconstruct_cholesky_basis": (_P, _P, _U64, _U64, _P, _P) + (
        _I,) * 6 + (_P, _I, _F, _P),
    # accum, planes, ops_lo, ops_hi, out, weights, mins_maxs, H, W,
    # blocks_x, blocks_y, F, lo, frame, mode, noise_amp, stream
    "bmfr_fit_direct_householder_basis": (_P, _P, _U64, _U64, _P, _P, _P) + (
        _I,) * 6 + (_P, _I, _F, _P),
    # tmp, weights, mins_maxs, nb, B, lo, bp, mode, group, blocks_per_cta,
    # smem, frame, noise_amp, stream
    "bmfr_fit_blocks_registers": (_P,) * 3 + (_I,) * 8 + (_P, _F, _P),
    # tmp, weights, mins_maxs, nb, B, lo, bp, mode, reg_columns, smem,
    # frame, noise_amp, stream
    "bmfr_fit_blocks_shared": (_P,) * 3 + (_I,) * 7 + (_P, _F, _P),
    # src, iy, ix, row0, row1, C, H, W, stream
    "bmfr_warp_rows": (_P,) * 5 + (_I,) * 3 + (_P,),
    # positions, cam, offset, out, H, W, history, stream
    "bmfr_reproject": (_P,) * 4 + (_I,) * 3 + (_P,),
    # planes, noisy, positions, normals, accum, spp, accept, pack (or
    # null), H, W, blend_alpha, history, stream
    "bmfr_noisy_tail": (_P,) * 8 + (_I, _I, _F, _I, _P),
    # filtered, planes, albedo, spp, prev_pixels, out, tone, result, pack
    # (or null), H, W, second_alpha, taa_alpha, taa_keep, residual_bf16,
    # accum_prev, variant (0 K4 only, 1 thread loads, 2 TMA), stream
    "bmfr_filtered_tail": (_P,) * 9 + (_I, _I, _F, _F, _F, _I, _I, _I, _P),
    # state positions, normals, noisy, spp, out, result; positions,
    # normals, pfx, pfy, out, H, W, pos_lim, nrm_lim, mode, stream
    "bmfr_warp_taps": (_P,) * 11 + (_I, _I, _F, _F, _I, _P),
    # planes, ops (host arrays: fitter_direct.feature_table), F, accum,
    # out, frame, H, W, block_edge, blocks_x, n_blocks, mode, stream
    "bmfr_feature_blocks": (_P, _P, _I, _P, _P, _P) + (_I,) * 6 + (_P,),
    # planes, ops, F, lo, weights, mins_maxs, out, frame, H, W,
    # block_edge, blocks_x, sanitize, default_basis, tiles_x, tiles_y,
    # smem, stream
    "bmfr_block_reconstruct": (_P, _P, _I, _I) + (_P,) * 4 + (_I,) * 9 + (
        _P,),
}

#: an entry point's return codes below 0: a TMA tensor map could not be
#: encoded (``csrc/filtered_tail.cu``); -1 libcuda lacks the encoder,
#: ENCODE_FAILED - r the encoder returned CUresult r
ENCODE_FAILED = -1000

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
    for name in SOURCES + HEADERS:
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
    # compile and link under private names, then rename: a concurrent
    # build never loads a half-written library
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    objs = [work / (Path(s).stem + ".o") for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", str(work / "lib.so"),
                 *map(str, objs)])
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        logs = [p.communicate()[0] for p in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{' '.join(cmds[-1])}\n{link.stdout}"
                               f"{link.stderr}")
        if verbose:
            print("".join(logs))
        os.replace(work / "lib.so", out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
    """Call C entry point ``name`` on the current stream, inside a
    profiler range of its name while a profiler records; raise if the
    launch reported a CUDA error."""
    import torch

    from ..profiling import launch_range

    stream = torch.cuda.current_stream().cuda_stream
    with launch_range(name):
        err = getattr(library(), name)(*args, stream)
    if err <= ENCODE_FAILED:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed (CUresult "
                           f"{ENCODE_FAILED - err})")
    if err < 0:
        raise RuntimeError(f"{name}: libcuda has no "
                           "cuTensorMapEncodeTiled")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def count_launch(fn, n=1):
    """Add ``n`` launches to kernel wrapper ``fn``'s count (``fn.launches``;
    under a lock: several threads launch at once). Inside
    :func:`tally_launches` on this thread the launches go to the tally
    instead: a captured launch runs at each replay, not now."""
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        tally[fn] = tally.get(fn, 0) + n
        return
    with _COUNT_LOCK:
        fn.launches += n


@contextlib.contextmanager
def tally_launches():
    """Count this thread's launches into a dict of their own, by wrapper,
    for the duration of the block (the compiled step's capture)."""
    prev = getattr(_TALLY, "counts", None)
    _TALLY.counts = counts = {}
    try:
        yield counts
    finally:
        _TALLY.counts = prev


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
