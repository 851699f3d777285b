"""The frame number as the ops take it: a host int or a 0-d int32 tensor.

The JAX step takes a traced ``frame``, so one compiled program serves
every frame. Here the ops take either a host int (the eager step) or a
0-d int32 tensor on the step's device (the compiled step of
:mod:`~bmfr_tpu_torch.pipeline.graph`, which reads the frame from a
buffer each replay): the fitter kernels read it through a device pointer
and derive the noise and the jitter themselves, and the torch-side
jitter builds its indices from it.

Whether a frame reads history stays a host decision, as JAX's static
``history="never"|"always"`` (``bmfr_tpu/pipeline/denoise.py:100-107``):
a branch on a device tensor would synchronize the host with the card, and
a CUDA graph cannot capture it.
"""

from __future__ import annotations

import torch

#: the values of ``history``: frame 0 reads none, every later frame reads
#: the previous state
HISTORY = ("never", "always")


def has_history(frame, history=None) -> bool:
    """Whether the frame reads the previous state. ``history`` (one of
    :data:`HISTORY`) decides; without it a host int decides (frames > 0
    have history, as JAX's ``history="dynamic"`` gates them), and a
    tensor frame raises."""
    if history is not None:
        if history not in HISTORY:
            raise ValueError(f"history must be one of {HISTORY}, got "
                             f"{history!r}")
        return history == "always"
    if isinstance(frame, torch.Tensor):
        raise ValueError("a frame given as a tensor needs history='never' "
                         "or 'always' (the host does not read the card)")
    return int(frame) > 0


def frame_tensor(frame, device):
    """``frame`` as the kernels read it: a 0-d int32 tensor on ``device``
    (a host int is written there by a fill, never a host-to-device copy,
    which would wait for the card)."""
    if isinstance(frame, torch.Tensor):
        if (frame.dtype != torch.int32 or frame.dim() != 0
                or frame.device != torch.device(device)):
            raise ValueError(f"frame must be a 0-d int32 tensor on {device}, "
                             f"got {frame.dtype} {tuple(frame.shape)} on "
                             f"{frame.device}")
        return frame
    return torch.full((), int(frame), dtype=torch.int32, device=device)
