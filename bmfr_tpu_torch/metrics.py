"""Image fidelity metrics (PSNR / SSIM), the counterparts of
:mod:`bmfr_tpu.metrics`.

``psnr`` and ``ssim`` take numpy arrays or torch tensors on any device.
Given a tensor, they compute in f64 on its device (the fidelity sweep
scores 1280x720 frames on the card, where they are made), and only the
number reaches the host. ``psnr`` of two numpy arrays is the numpy code
of :func:`bmfr_tpu.metrics.psnr`, bit for bit. :func:`psnr_frames` and
:func:`ssim_frames` score a ``[T, H, W, C]`` series at once, one value
per frame, on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def psnr(img, ref, peak=1.0):
    """PSNR in dB over all channels. Inputs any matching-shape arrays."""
    if isinstance(img, torch.Tensor) or isinstance(ref, torch.Tensor):
        x, y = _tensors(img, ref)
        return float(psnr_frames(x[None], y[None], peak)[0])
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    mse = np.mean((img - ref) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def psnr_frames(x, y, peak=1.0):
    """Per-frame PSNR in dB (f64 ``[T]``, on the tensors' device) of two
    ``[T, ...]`` tensors."""
    d = x.to(torch.float64) - y.to(torch.float64)
    mse = (d * d).flatten(1).mean(dim=1)
    return 10.0 * torch.log10(peak * peak / mse)


def _tensors(img, ref):
    """Both inputs as f64 tensors, on the device of the first of them
    that is a tensor (the CPU for two arrays)."""
    dev = next((a.device for a in (img, ref)
                if isinstance(a, torch.Tensor)), torch.device("cpu"))
    return tuple(torch.as_tensor(a, device=dev).to(torch.float64)
                 for a in (img, ref))


def _gaussian_kernel(size=11, sigma=1.5):
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(r * r) / (2.0 * sigma * sigma))
    return k / k.sum()


def ssim(img, ref, peak=1.0, win_size=11, sigma=1.5):
    """Standard Gaussian-windowed SSIM (Wang et al. 2004): 11x11 window,
    sigma 1.5, K1=0.01, K2=0.03, per channel, averaged, as
    :func:`bmfr_tpu.metrics.ssim`. Takes HWC, CHW or 2-D images."""
    x, y = _tensors(img, ref)
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    elif x.shape[0] in (1, 3, 4) and x.shape[-1] not in (1, 3, 4):
        x, y = x.movedim(0, -1), y.movedim(0, -1)    # accept CHW
    return float(ssim_frames(x[None], y[None], peak, win_size, sigma)[0])


def _conv_valid(a, k):
    """Separable 'valid' convolution of the last two axes with the 1-D
    kernel ``k`` (host floats), as shifted sums in the order of
    :func:`bmfr_tpu.metrics._conv_valid`."""
    n = len(k)
    h, w = a.shape[-2] - n + 1, a.shape[-1] - n + 1
    a = sum(k[i] * a[..., i:i + h, :] for i in range(n))
    return sum(k[i] * a[..., i:i + w] for i in range(n))


def ssim_frames(x, y, peak=1.0, win_size=11, sigma=1.5):
    """Per-frame SSIM (f64 ``[T]``, on the tensors' device) of two
    channels-last ``[T, H, W, C]`` tensors: each channel's SSIM map by a
    separable 'valid' Gaussian convolution, its mean, and the mean over
    channels."""
    k = _gaussian_kernel(win_size, sigma).tolist()
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2
    # every (frame, channel) plane at once, channels first
    xc = x.to(torch.float64).movedim(-1, 1)
    yc = y.to(torch.float64).movedim(-1, 1)
    mx, my = _conv_valid(xc, k), _conv_valid(yc, k)
    mxx, myy = _conv_valid(xc * xc, k), _conv_valid(yc * yc, k)
    mxy = _conv_valid(xc * yc, k)
    vx, vy, cxy = mxx - mx * mx, myy - my * my, mxy - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2))
    return s.flatten(2).mean(dim=2).mean(dim=1)
