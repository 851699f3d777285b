"""Scene descriptor and loading for the TUNI BMFR scene layout.

Port of :mod:`bmfr_tpu.io.dataset`. A scene is one directory of four EXR
series, ``color``/``shading_normal``/``world_position``/``albedo`` +
``N.exr`` (opencl/bmfr.cpp:49-52), and a generated ``camera_matrices.h``
(opencl/bmfr.cpp:46-47). The reference hard-codes one scene per build;
here a scene is a runtime object, found by :func:`discover_scenes` and
loaded by the native threaded loader (:mod:`.native`), the counterpart of
the reference's OpenMP parallel-for (opencl/bmfr.cpp:259-307). The
golden references (``load_references``) are not ported yet (ROADMAP
Queue 1 #11).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import native
from .camera import parse_camera_matrices_header
from .exr import read_exr

BUFFER_NAMES = ("color", "shading_normal", "world_position", "albedo")


@dataclass
class SceneDescriptor:
    """One scene directory: EXR series + camera header."""

    path: str
    frame_count: int = 60
    width: int = 1280
    height: int = 720

    def buffer_path(self, buffer: str) -> str:
        return os.path.join(self.path, buffer)

    def camera_header_path(self) -> str:
        return os.path.join(self.path, "camera_matrices.h")

    def load_camera(self):
        return parse_camera_matrices_header(self.camera_header_path())

    def load_frames(self, frames=None, threads=0, out=None):
        """Load the four buffer series of ``frames`` (default all) in one
        parallel native batch. Returns a dict of f32 ``[T, H, W, 3]``
        (``noisy``, ``normals``, ``positions``, ``albedo``) with the camera
        data merged in. ``out``: an f32 ``[4, T, H, W, 3]`` array to decode
        into (a pinned host buffer, for the streaming upload); the
        returned arrays are views of it."""
        frames = (list(range(self.frame_count)) if frames is None
                  else list(frames))
        shape = (4, len(frames), self.height, self.width, 3)
        paths = [f"{self.buffer_path(buf)}{f}.exr" for buf in BUFFER_NAMES
                 for f in frames]
        flat = None if out is None else native.check_out(out, shape).reshape(
            (-1,) + shape[2:])
        arr = native.load_frames(paths, self.width, self.height, 3,
                                 threads or (os.cpu_count() or 8), out=flat)
        arr = arr.reshape(shape)
        data = dict(zip(("noisy", "normals", "positions", "albedo"), arr))
        cam = self.load_camera()
        data["camera_matrices"] = cam["camera_matrices"][frames]
        data["pixel_offsets"] = cam["pixel_offsets"][frames]
        data["position_limit_squared"] = cam["position_limit_squared"]
        data["normal_limit_squared"] = cam["normal_limit_squared"]
        return data


def probe_scene(path: str) -> SceneDescriptor:
    """A descriptor with the size and frame count read from the files
    (the reference hard-codes 1280x720x60, opencl/bmfr.cpp:39-42)."""
    img = read_exr(os.path.join(path, "color0.exr"))
    n = 0
    while os.path.exists(os.path.join(path, f"color{n}.exr")):
        n += 1
    return SceneDescriptor(path=path, frame_count=n, width=img.shape[1],
                           height=img.shape[0])


def discover_scenes(root: str):
    """The scene directories under ``root`` (each holding a
    ``camera_matrices.h`` and a ``color0.exr``), sorted by name, with
    their size and frame count read from the files."""
    scenes = []
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if (os.path.isdir(p)
                and os.path.exists(os.path.join(p, "camera_matrices.h"))
                and os.path.exists(os.path.join(p, "color0.exr"))):
            scenes.append(probe_scene(p))
    return scenes
