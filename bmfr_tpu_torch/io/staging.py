"""Stage a scene to disk in the TUNI dataset layout, one EXR codec per file.

Port of :mod:`bmfr_tpu.io.staging`. The reference's whole external data
contract is a directory of per-frame EXR series
``color``/``shading_normal``/``world_position``/``albedo`` + ``NN.exr``
(opencl/bmfr.cpp:49-52) plus a generated C header ``camera_matrices.h``
(opencl/bmfr.cpp:46-47) holding the per-frame view-projection matrices,
sub-pixel jitters and the scene's reprojection discard thresholds (used
at opencl/bmfr.cpp:226-227, :440-444).

:func:`stage_scene` writes that layout from an in-memory scene dict (a
:func:`~bmfr_tpu_torch.io.fixtures.synthetic_sequence` render), cycling
the EXR compression codec per file, so that every codec the native reader
implements (ZIP/ZIPS/PIZ/PXR24/B44) is read by the real dataset loader
inside a pipeline run. ZIP and ZIPS are written by the native library
(:mod:`.native`), PIZ, PXR24 and B44 by :mod:`.exr_py`; the files are
written by a thread pool (the native writer, zlib and numpy release the
interpreter lock), and are the JAX package's bytes for the same scene.

The lossy codecs make staging a *quantizing* write: PXR24 stores FLOAT
channels as float24 (low mantissa byte dropped) and B44 stores HALF with
block quantization. ``stage_scene`` returns the per-buffer expected
arrays (what a reader must get back bit-for-bit), so callers can assert
the loader's output exactly rather than approximately.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import native
from .dataset import BUFFER_NAMES
from .exr_py import (_float_to_float24, read_exr_py, write_exr_b44,
                     write_exr_py)

#: the codecs :func:`stage_scene` cycles through, one per file
STAGE_CODECS = ("zip", "zips", "piz", "pxr24", "b44")


def write_camera_matrices_header(path, camera_matrices, pixel_offsets,
                                 position_limit_squared,
                                 normal_limit_squared):
    """Write ``camera_matrices.h`` in the dataset's generated-C format
    (the exact shape the reference #includes, opencl/bmfr.cpp:46-47, and
    :func:`~bmfr_tpu_torch.io.camera.parse_camera_matrices_header`
    parses). Its text, the first comment line included, is the JAX
    package's, so both packages stage byte-identical scenes."""
    cams = np.asarray(camera_matrices, np.float32)
    offs = np.asarray(pixel_offsets, np.float32)
    T = cams.shape[0]
    if cams.shape != (T, 4, 4) or offs.shape != (T, 2):
        raise ValueError(f"camera_matrices {cams.shape} and pixel_offsets "
                         f"{offs.shape}: want [T, 4, 4] and [T, 2]")

    def f(x):
        # shortest f64 repr of the f32 value: exact on re-parse
        return repr(float(np.float32(x))) + "f"

    lines = ["// generated by bmfr_tpu.io.staging (TUNI layout)",
             f"const float camera_matrices[{T}][4][4] = {{"]
    for t in range(T):
        lines.append("    {")
        for r in range(4):
            row = ", ".join(f(v) for v in cams[t, r])
            lines.append(f"        {{ {row} }},")
        lines.append("    },")
    lines.append("};")
    lines.append(f"const float pixel_offsets[{T}][2] = {{")
    for t in range(T):
        lines.append(f"    {{ {f(offs[t, 0])}, {f(offs[t, 1])} }},")
    lines.append("};")
    lines.append("const float position_limit_squared = "
                 f"{f(position_limit_squared)};")
    lines.append("const float normal_limit_squared = "
                 f"{f(normal_limit_squared)};")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _write_one(path, img, codec):
    """Write one EXR with the requested codec; returns the array a
    bit-exact reader must produce for it."""
    img = np.ascontiguousarray(img, np.float32)
    if codec in ("zip", "zips"):
        native.write_exr(path, img, half=False, compression=codec)
        return img
    if codec == "piz":
        # PIZ FLOAT channels are lossless (wavelet+huffman on the raw
        # bit pattern halves)
        write_exr_py(path, img, half=False, compression="piz")
        return img
    if codec == "pxr24":
        write_exr_py(path, img, half=False, compression="pxr24")
        return (_float_to_float24(img) << np.uint32(8)).view(np.float32)
    if codec == "b44":
        # HALF-only block codec; lossy on textured blocks — expected
        # values come from a decode round-trip of the written file
        write_exr_b44(path, img)
        return read_exr_py(path)
    raise ValueError(f"unknown staging codec {codec!r}")


def stage_scene(path, scene, codecs=STAGE_CODECS, frames=None,
                threads=0):
    """Write ``scene`` (a dict like :func:`synthetic_sequence` returns)
    into directory ``path`` in TUNI layout with codecs cycled per file:
    file ``k`` of the buffers in :data:`BUFFER_NAMES` order, frames in
    order, takes ``codecs[k % len(codecs)]``. ``threads``: writer threads
    (0: one per core).

    Returns ``{buffer_name: f32[T,H,W,3]}`` of *expected* loader outputs
    (identical to the inputs for lossless codecs; codec-rounded for
    PXR24/B44). The scene's pipeline-facing keys (noisy/normals/
    positions) map back to the on-disk series names (color/
    shading_normal/world_position, opencl/bmfr.cpp:49-52). A scene with
    a ``clean`` render also gets ``reference<t>.exr`` (ZIP).
    """
    for codec in codecs:
        if codec not in STAGE_CODECS:
            raise ValueError(f"unknown staging codec {codec!r}")
    os.makedirs(path, exist_ok=True)
    series = {
        "color": scene["noisy"],
        "shading_normal": scene["normals"],
        "world_position": scene["positions"],
        "albedo": scene["albedo"],
    }
    T = scene["noisy"].shape[0] if frames is None else frames
    jobs = [(os.path.join(path, f"{buf}{t}.exr"), series[buf][t],
             codecs[(i * T + t) % len(codecs)])
            for i, buf in enumerate(BUFFER_NAMES) for t in range(T)]
    if "clean" in scene:
        jobs += [(os.path.join(path, f"reference{t}.exr"), scene["clean"][t],
                  "zip") for t in range(T)]
    with ThreadPoolExecutor(max_workers=threads or os.cpu_count() or 8) as ex:
        done = [ex.submit(_write_one, *job) for job in jobs]
        written = [d.result() for d in done]
    expected = {buf: np.stack(written[i * T:(i + 1) * T])
                for i, buf in enumerate(BUFFER_NAMES)}
    write_camera_matrices_header(
        os.path.join(path, "camera_matrices.h"),
        scene["camera_matrices"][:T], scene["pixel_offsets"][:T],
        scene.get("position_limit_squared", 0.03),
        scene.get("normal_limit_squared", 0.5))
    return expected
