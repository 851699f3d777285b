"""Feature specification: the regression basis as data.

Port of :mod:`bmfr_tpu.features` on torch tensors. A feature is a named
function ``(normals[3, ...], positions[3, ...]) -> f32[...]``
(opencl/bmfr.cl:448-453 and :727-729). The fitter kernel evaluates the
default basis in its own code; this registry is what its plain version
evaluates.
"""

from __future__ import annotations

import torch

FEATURE_REGISTRY = {
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


def evaluate_features(names, normals, positions):
    """Evaluate named features -> ``f32[len(names), ...]``."""
    return torch.stack(
        [FEATURE_REGISTRY[name](normals, positions) for name in names])
