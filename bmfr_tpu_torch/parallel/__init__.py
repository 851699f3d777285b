"""Scene-parallel denoising over a mesh of devices (port of
:mod:`bmfr_tpu.parallel`)."""

from .sharding import (denoise_scenes_jit, denoise_scenes_sharded,
                       make_scene_mesh)

__all__ = ["denoise_scenes_jit", "denoise_scenes_sharded", "make_scene_mesh"]
