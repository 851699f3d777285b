"""Export a scene to the TUNI dataset directory layout.

Port of :mod:`bmfr_tpu.io.export`: the four EXR series (``color``/
``shading_normal``/``world_position``/``albedo`` + ``N.exr``,
opencl/bmfr.cpp:49-52, ZIP-compressed f32 or half) and a
``camera_matrices.h`` in the dataset generator's C-initializer form
(consumed at opencl/bmfr.cpp:46-47, :226-227, :440-444). The files are
written by a thread pool: the native writer releases the interpreter lock
while it compresses.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .exr import write_exr


def export_scene(scene: dict, path: str,
                 position_limit_squared=0.03, normal_limit_squared=0.5,
                 half: bool = False):
    """Write ``scene`` (a dict like
    :func:`~bmfr_tpu_torch.io.fixtures.synthetic_sequence` returns:
    channels-last ``[T, H, W, 3]`` arrays, ``camera_matrices``,
    ``pixel_offsets``) into directory ``path``."""
    os.makedirs(path, exist_ok=True)
    T = scene["noisy"].shape[0]
    series = {
        "color": scene["noisy"],
        "shading_normal": scene["normals"],
        "world_position": scene["positions"],
        "albedo": scene["albedo"],
    }
    jobs = [(os.path.join(path, f"{name}{t}.exr"), arr[t])
            for name, arr in series.items() for t in range(T)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as ex:
        for done in [ex.submit(write_exr, p, img, half) for p, img in jobs]:
            done.result()
    write_camera_header(os.path.join(path, "camera_matrices.h"),
                        scene["camera_matrices"], scene["pixel_offsets"],
                        position_limit_squared, normal_limit_squared)


def write_camera_header(path, camera_matrices, pixel_offsets,
                        position_limit_squared, normal_limit_squared):
    """Write ``camera_matrices.h``: the per-frame matrices and jitter
    offsets (9 significant digits, exact for f32) and the discard
    limits."""
    cams = np.asarray(camera_matrices, np.float64)
    offs = np.asarray(pixel_offsets, np.float64)
    T = cams.shape[0]
    lines = [f"const float camera_matrices[{T}][4][4] = {{"]
    for t in range(T):
        rows = ",\n        ".join(
            "{" + ", ".join(f"{v:.9g}f" for v in cams[t, r]) + "}"
            for r in range(4))
        lines.append("    {\n        " + rows + "\n    },")
    lines.append("};")
    lines.append(f"const float pixel_offsets[{T}][2] = {{")
    for t in range(T):
        lines.append(
            "    {" + ", ".join(f"{v:.9g}f" for v in offs[t]) + "},")
    lines.append("};")
    lines.append(
        f"const float position_limit_squared = {position_limit_squared}f;")
    lines.append(
        f"const float normal_limit_squared = {normal_limit_squared}f;")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
