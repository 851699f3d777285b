"""Image fidelity metric (PSNR), a copy of :func:`bmfr_tpu.metrics.psnr`."""

from __future__ import annotations

import numpy as np


def psnr(img, ref, peak=1.0):
    """PSNR in dB over all channels. Inputs any matching-shape arrays
    (numpy, or torch tensors already on the host)."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    mse = np.mean((img - ref) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
