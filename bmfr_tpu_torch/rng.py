"""Deterministic hash RNG used to regularize the per-block fit.

Bit-exact port of :mod:`bmfr_tpu.rng` (``opencl/bmfr.cl:162-182``).
torch has no usable uint32 arithmetic and its int32 ``>>`` is
arithmetic, so the hash runs in int64 with every step masked to the
low 32 bits: sums, left shifts and xors keep their low 32 bits exactly,
and right shifts of a masked (non-negative) value are logical.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def hash_uniform(a):
    """uint32 hash -> float32 uniform in [0, 1]. ``a``: integer tensor
    (taken mod 2**32). opencl/bmfr.cl:162-171."""
    a = a.to(torch.int64) & _M32
    a = ((a + 0x7ED55D16) + (a << 12)) & _M32
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & _M32
    a = ((a + 0x165667B1) + (a << 5)) & _M32
    a = ((a + 0xD3A2646C) ^ (a << 9)) & _M32
    a = ((a + 0xFD7046C5) + (a << 3)) & _M32
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & _M32
    # convert_float(a) / convert_float(UINT_MAX): both rounded to f32
    return a.to(torch.float32) / float(np.float32(_M32))


def feature_noise(frame_number: int, feature_count: int, block_pixels: int,
                  buffer_count: int, noise_amount: float, device="cpu"):
    """Noise field added to the feature columns of every block at one
    frame: ``f32[feature_count, block_pixels]``, row 0 (the constant
    feature) zero. Seed ``e + f*block_pixels + frame*buffer_count*
    block_pixels`` (opencl/bmfr.cl:173-182, :625-627)."""
    e = torch.arange(block_pixels, dtype=torch.int64, device=device)[None]
    f = torch.arange(feature_count, dtype=torch.int64, device=device)[:, None]
    frame_term = (int(frame_number) & _M32) * (buffer_count * block_pixels)
    seed = e + f * block_pixels + (frame_term & _M32)
    amp = float(np.float32(noise_amount) * np.float32(2.0))
    noise = amp * (hash_uniform(seed) - 0.5)
    noise[0] = 0.0
    return noise
