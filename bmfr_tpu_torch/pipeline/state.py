"""The raw-plane temporal state (port of :mod:`bmfr_tpu.pipeline.state`).

The reference keeps six double-buffered device buffers swapped after
every frame (``Double_buffer`` at opencl/bmfr.cpp:122-135, the swap at
:482-484). Every configuration whose warp is not the fused kernel carries
them as a :class:`TemporalState`; the next frame's state is a new tuple
whose planes are the frame's own outputs (no copy, no in-place update).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TemporalState(NamedTuple):
    """Previous-frame buffers read by the next frame (opencl/bmfr.cpp:
    345-347): normals/positions/noisy feed K1's reprojection tests and
    accumulation, spp the blend caps, out the second accumulation,
    result the TAA history."""

    normals: torch.Tensor    # f32[3, H, W]
    positions: torch.Tensor  # f32[3, H, W]
    noisy: torch.Tensor      # f32[3, H, W] accumulated noisy colour
    spp: torch.Tensor        # u8[H, W]
    out: torch.Tensor        # f32[3, H, W] accumulated filtered colour
    result: torch.Tensor     # f32[3, H, W] TAA history

    @classmethod
    def initial(cls, cfg, device="cuda"):
        """An all-zero state (frame 0 never reads it), on the card unless
        ``device`` says otherwise."""
        H, W = cfg.image_height, cfg.image_width
        z3 = torch.zeros((3, H, W), dtype=torch.float32, device=device)
        return cls(normals=z3, positions=z3, noisy=z3,
                   spp=torch.zeros((H, W), dtype=torch.uint8, device=device),
                   out=z3, result=z3)

    def stacked(self):
        """The 16 recurrent channels in the tap order of the temporal
        stages: positions 0:3, normals 3:6, noisy 6:9, spp 9, out 10:13,
        result 13:16 (``pipeline/denoise.py:115-119``) -> f32
        ``[16, H, W]``."""
        return torch.cat([self.positions, self.normals, self.noisy,
                          self.spp.float()[None], self.out, self.result])


def temporal_state_from_jax(state, device="cuda"):
    """The port's state from a JAX ``TemporalState`` (fields any
    array-like), field by field, on the card unless ``device`` says
    otherwise."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a, dtype=dtype), device=device)

    return TemporalState(
        normals=t(state.normals, np.float32),
        positions=t(state.positions, np.float32),
        noisy=t(state.noisy, np.float32), spp=t(state.spp, np.uint8),
        out=t(state.out, np.float32), result=t(state.result, np.float32))
