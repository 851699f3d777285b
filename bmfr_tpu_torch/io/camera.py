"""Parser for the dataset's generated ``camera_matrices.h``.

The reference ``#include``s this C header at compile time
(opencl/bmfr.cpp:46-47) to get ``camera_matrices[frame][4][4]``,
``pixel_offsets[frame][2]`` and the per-scene reprojection thresholds
``position_limit_squared`` / ``normal_limit_squared`` (used at
opencl/bmfr.cpp:226-227, :440-444). Here the same file is parsed at runtime
— the header is plain C initializer syntax, so a float-literal scan of each
declaration suffices.

A copy of :mod:`bmfr_tpu.io.camera` (the port imports nothing of the JAX
package); ``tests/test_torch_io.py`` pins it to the original.
"""

from __future__ import annotations

import re

import numpy as np

_FLOAT_RE = re.compile(
    r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _extract_initializer(text: str, name: str) -> str:
    """Return the brace-balanced initializer after ``name ... = {``."""
    m = re.search(rf"\b{name}\b[^=]*=\s*\{{", text)
    if not m:
        raise ValueError(f"declaration '{name}' not found")
    start = m.end() - 1
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return text[start : i + 1]
    raise ValueError(f"unbalanced braces in initializer of '{name}'")


def _extract_scalar(text: str, name: str) -> float:
    m = re.search(rf"\b{name}\b[^=]*=\s*([^;]+);", text)
    if not m:
        raise ValueError(f"declaration '{name}' not found")
    fm = _FLOAT_RE.search(m.group(1))
    if not fm:
        raise ValueError(f"no float literal in '{name}' initializer")
    return float(fm.group(0))


def parse_camera_matrices_header(path_or_text):
    """Parse a ``camera_matrices.h`` file (path or literal text).

    Returns dict with ``camera_matrices f32[T,4,4]``,
    ``pixel_offsets f32[T,2]``, ``position_limit_squared``,
    ``normal_limit_squared``.
    """
    text = path_or_text
    if "\n" not in text and text.endswith(".h"):
        with open(path_or_text) as f:
            text = f.read()

    cam_txt = _extract_initializer(text, "camera_matrices")
    cams = np.array([float(x) for x in _FLOAT_RE.findall(cam_txt)],
                    np.float32)
    if cams.size % 16 != 0:
        raise ValueError(f"camera_matrices has {cams.size} floats, not /16")
    cams = cams.reshape(-1, 4, 4)

    off_txt = _extract_initializer(text, "pixel_offsets")
    offs = np.array([float(x) for x in _FLOAT_RE.findall(off_txt)],
                    np.float32)
    if offs.size % 2 != 0:
        raise ValueError(f"pixel_offsets has {offs.size} floats, not /2")
    offs = offs.reshape(-1, 2)

    return dict(
        camera_matrices=cams,
        pixel_offsets=offs,
        position_limit_squared=_extract_scalar(text, "position_limit_squared"),
        normal_limit_squared=_extract_scalar(text, "normal_limit_squared"),
    )
