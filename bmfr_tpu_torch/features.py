"""Feature specification: the regression basis as data.

Port of :mod:`bmfr_tpu.features` on torch tensors. A feature is a named
function ``(normals[3, ...], positions[3, ...]) -> f32[...]``
(opencl/bmfr.cl:448-453 and :727-729); users add their own with
:func:`register_feature`. Every fitter path evaluates this registry: the
plain versions, kernel D's blocks and the direct kernels B and C
(:mod:`~bmfr_tpu_torch.ops.fitter_direct`), which compute a name that
still holds its built-in function (``_BUILTIN_FEATURES``) in their own
code from the raw planes and stage every other feature as a plane the
wrapper evaluates here.
"""

from __future__ import annotations

import torch

#: the built-in features; the direct kernels compute these in their own
#: code, bit for bit as evaluated here, while the registry holds them
_BUILTIN_FEATURES = {
    "const": lambda n, p: torch.ones_like(n[0]),
    "normal_x": lambda n, p: n[0],
    "normal_y": lambda n, p: n[1],
    "normal_z": lambda n, p: n[2],
    "world_position_x": lambda n, p: p[0],
    "world_position_y": lambda n, p: p[1],
    "world_position_z": lambda n, p: p[2],
    "world_position_x2": lambda n, p: p[0] * p[0],
    "world_position_y2": lambda n, p: p[1] * p[1],
    "world_position_z2": lambda n, p: p[2] * p[2],
}
FEATURE_REGISTRY = dict(_BUILTIN_FEATURES)


def register_feature(name: str, fn):
    """Register a feature ``fn(normals, positions) -> [H, W]`` under a
    name (``bmfr_tpu/features.py:23-26``). ``fn`` must be a per-pixel
    function of the pixel's own normal and position: the direct kernels
    evaluate it on the image and address the result as they address the
    raw planes."""
    FEATURE_REGISTRY[name] = fn
    return fn


def evaluate_features(names, normals, positions):
    """Evaluate named features -> ``f32[len(names), ...]``."""
    return torch.stack(
        [FEATURE_REGISTRY[name](normals, positions) for name in names])
