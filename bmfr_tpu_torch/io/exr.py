"""EXR input and PNG output through the native IO library.

Port of :mod:`bmfr_tpu.io.exr`: the reference's OpenImageIO loaders and
writers (``read_image_file``/``load_image`` at opencl/bmfr.cpp:145-172,
the PNG writer loop at :519-553) with the same shape and channel
validation. Every function goes through :mod:`.native`; without the
library (a failed build) they raise, naming the build. All images are f32
channels-last ``[H, W, C]`` numpy arrays.
"""

from __future__ import annotations

import numpy as np

from . import native


class OperationResult:
    """``Operation_result`` equivalent (opencl/bmfr.cpp:137-143)."""

    def __init__(self, success: bool, error_message: str = ""):
        self.success = success
        self.error_message = error_message

    def __bool__(self):
        return self.success


def read_exr(path: str) -> np.ndarray:
    """Read an EXR into f32 ``[H, W, C]`` (RGB order)."""
    return native.read_exr(path)


def read_image_file(file_name: str, frame: int, expect_shape=None):
    """Open ``<file_name><frame>.exr`` with validation
    (opencl/bmfr.cpp:145-163). Returns ``(OperationResult, array or
    None)``."""
    path = f"{file_name}{frame}.exr"
    try:
        img = read_exr(path)
    except OSError as e:
        return OperationResult(False, f"Can't open image file or it has "
                               f"wrong type: {file_name} ({e})"), None
    if img.ndim != 3 or img.shape[2] != 3 or (
            expect_shape is not None
            and img.shape[:2] != tuple(expect_shape)):
        return OperationResult(False, f"Can't open image file or it has "
                               f"wrong type: {file_name}"), None
    return OperationResult(True), np.ascontiguousarray(img, np.float32)


def write_png(path: str, img_hwc: np.ndarray):
    """Write an f32 ``[H, W, 3]`` image in [0, 1] as an 8-bit PNG
    (opencl/bmfr.cpp:527-539)."""
    arr8 = np.clip(np.asarray(img_hwc, np.float32), 0.0, 1.0)
    native.write_png(path, (arr8 * 255.0 + 0.5).astype(np.uint8))


def write_exr(path: str, img_hwc: np.ndarray, half: bool = False):
    """Write an f32 ``[H, W, C]`` EXR (ZIP compression)."""
    native.write_exr(path, np.asarray(img_hwc, np.float32), half=half)
