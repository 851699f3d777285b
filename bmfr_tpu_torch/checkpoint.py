"""Checkpoint and resume of the temporal recurrence.

Port of :mod:`bmfr_tpu.checkpoint`. The reference keeps its recurrent
state only in device buffers; here the whole state is a
:class:`~bmfr_tpu_torch.pipeline.state.TemporalState` plus the next frame
number, saved in the JAX package's npz format: the keys ``frame`` (int64)
and the six fields (``spp`` as uint8, the rest f32 ``[3, H, W]``), so a
file written by either package loads in the other. Every configuration
carries a ``TemporalState`` when asked to (the fused warp reads it through
bf16 taps, kernel I); a :class:`~bmfr_tpu_torch.pipeline.denoise.PackedState` is not
saved, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline.state import TemporalState


def save_state(path: str, state: TemporalState, frame: int):
    """Save the recurrent state and the next frame number to ``path``
    (a compressed ``.npz``)."""
    if not isinstance(state, TemporalState):
        raise TypeError(f"save_state takes a TemporalState, got "
                        f"{type(state).__name__} (a PackedState is not "
                        "saved; carry a TemporalState to checkpoint)")
    np.savez_compressed(
        path, frame=np.int64(frame),
        **{f: getattr(state, f).cpu().numpy() for f in TemporalState._fields})


def load_state(path: str, device="cuda"):
    """``(TemporalState, next_frame)`` saved by :func:`save_state` (of
    either package), on the card unless ``device`` says otherwise
    (without a card this raises)."""
    with np.load(path) as d:
        state = TemporalState(**{f: torch.from_numpy(d[f]).to(device)
                                 for f in TemporalState._fields})
        return state, int(d["frame"])
