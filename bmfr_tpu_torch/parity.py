"""The port held to the NumPy oracle, frame by frame.

:func:`port_frames` runs the port's per-frame step over a synthetic
scene (on the card, or with the plain versions on the CPU);
:func:`oracle_frames` runs the port's copy of the vectorized oracle
(:mod:`bmfr_tpu_torch.oracle`) over the same frames. :func:`compare`
scores one frame of the port against the oracle's, and
:func:`default_faults` / :func:`flagship_faults` name what misses its
tolerance:

- the default ``BMFRConfig()`` path, at the tolerances that
  ``tests/test_nonaligned_width.py`` holds the JAX package to: accept
  bits equal on more than 99.5 % of pixels, the weights within rtol/atol
  5e-3, ``filtered`` within 1e-3/2e-3 and ``result`` within 2e-3/3e-3
  on the pixels whose accept bits agree;
- the flagships (the bf16 state, the direct fitters, bf16 residual), in
  the JAX flagship's regime (61.9-66.2 dB against the oracle in
  ``PARITY_FULLRES.json``): ``result`` at least 58 dB from the oracle's,
  and accept bits equal to the oracle's on at least 96 % of each frame's
  pixels and to those of the oracle run on the bf16-rounded state on
  more than 99.5 % (:func:`flagship_faults`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .metrics import psnr
from .oracle import OracleState
from .oracle.reference_vec import oracle_denoise_frame_vec
from .pipeline.denoise import (denoise_frame, frame_inputs_from_numpy,
                               zero_state)

ACCEPT_SHARE = 0.995
#: (rtol, atol); filtered and result on the pixels whose accept bits agree
TOL = dict(weights=(5e-3, 5e-3), filtered=(1e-3, 2e-3), result=(2e-3, 3e-3))
FLAGSHIP_DB = 58.0
#: the flagship's floor of equal accept bits against the f32 oracle, per
#: frame: under the lowest sound reading at 72x48x4 (96.30 %, corridor
#: frame 1, the JAX flagship's too), above the state truncated to bf16 in
#: place of rounded (93.03 % there; :func:`bf16_truncate`)
FLAGSHIP_ACCEPT_SHARE = 0.96


def bf16_round(a):
    """f32 values rounded to bf16 (to nearest even), as f32: the
    flagship's packed state."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def bf16_truncate(a):
    """f32 values truncated to bf16 (toward zero), as f32: a state
    rounded the wrong way, the control that the flagship's floor of
    equal accept bits must reject."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def oracle_frames(cfg, sc, round_state=None):
    """The vectorized oracle's outputs for every frame of the scene dict.
    ``round_state`` (:func:`bf16_round` or :func:`bf16_truncate`), when
    given, maps the carried f32 state after each frame: with
    :func:`bf16_round` it is stored as the flagship's packed state stores
    it, the reference for the flagship's accept bits."""
    state, outs = OracleState.initial(cfg.image_height, cfg.image_width), []
    for t in range(sc["noisy"].shape[0]):
        state, o = oracle_denoise_frame_vec(
            cfg, state, sc["normals"][t], sc["positions"][t],
            sc["noisy"][t], sc["albedo"][t],
            sc["camera_matrices"][max(t - 1, 0)], sc["pixel_offsets"][t], t)
        if round_state is not None:
            state = dataclasses.replace(state, **{
                f.name: round_state(getattr(state, f.name))
                for f in dataclasses.fields(state)
                if getattr(state, f.name).dtype == np.float32})
        outs.append(o)
    return outs


def port_frames(cfg, sc, device):
    """The port's per-frame outputs (``accept``, ``weights``,
    ``filtered``, ``result``) for every frame of the scene dict, through
    :func:`~bmfr_tpu_torch.pipeline.denoise.denoise_frame` on ``device``,
    as channels-last numpy arrays like the oracle's."""
    inputs = frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                     sc["noisy"], sc["albedo"], device)
    cams = torch.from_numpy(sc["camera_matrices"]).to(device)
    offs = torch.from_numpy(sc["pixel_offsets"]).to(device)
    state, outs = zero_state(cfg, device), []
    for t in range(sc["noisy"].shape[0]):
        state, o = denoise_frame(cfg, state, type(inputs)(
            *(x[t] for x in inputs)), cams[max(t - 1, 0)], offs[t], t)
        rec = dict(accept=o["accept"].cpu().numpy(),
                   weights=o["weights"].cpu().numpy())
        for k in ("filtered", "result"):
            rec[k] = np.moveaxis(o[k].cpu().numpy(), 0, -1)
        outs.append(rec)
    return outs


def _off(got, want, rtol, atol):
    """Values outside ``|got - want| <= atol + rtol |want|`` (the
    ``np.testing.assert_allclose`` bound)."""
    return int((np.abs(got - want) > atol + rtol * np.abs(want)).sum())


def compare(port, oracle):
    """One frame of the port against the oracle's: the share of equal
    accept bits, the result's PSNR and max |diff|, and the values off
    :data:`TOL` of the weights, and of ``filtered`` and ``result`` on
    the pixels whose accept bits agree."""
    ok = port["accept"] == oracle["accept"]
    rec = dict(accept_share=float(ok.mean()),
               psnr_db=psnr(port["result"], oracle["result"]),
               max_abs=float(np.abs(port["result"] - oracle["result"]).max()),
               off_weights=_off(port["weights"], oracle["weights"],
                                *TOL["weights"]))
    for k in ("filtered", "result"):
        rec[f"off_{k}"] = _off(port[k][ok], oracle[k][ok], *TOL[k])
    return rec


def default_faults(rec):
    """What misses the default path's tolerances in one frame's
    :func:`compare` record (empty when nothing does)."""
    faults = [f"{k} {rec[k]} values off tolerance" for k in
              ("off_weights", "off_filtered", "off_result") if rec[k]]
    if rec["accept_share"] <= ACCEPT_SHARE:
        faults.append(f"accept bits {rec['accept_share']:.4%} equal")
    return faults


def flagship_faults(recs, recs_bf16):
    """What misses the flagship's floors over one run (empty when nothing
    does), from the :func:`compare` records of its frames against the
    oracle (``recs``) and against the oracle on the bf16-rounded state
    (``recs_bf16``, :func:`oracle_frames` with :func:`bf16_round`), each
    frame on its own:

    - the result at least 58 dB from the oracle's;
    - the accept bits equal to the oracle's on at least 96 % of pixels
      (:data:`FLAGSHIP_ACCEPT_SHARE`; the bf16 state moves positions and
      normals across the discard limits, as on the JAX flagship);
    - the accept bits equal to those of the oracle on the bf16 state on
      more than 99.5 % of pixels (the default path's bar): the flips
      against the oracle are those the bf16 state explains.
    """
    faults = [f"frame {t}: result at {r['psnr_db']:.2f} dB"
              for t, r in enumerate(recs) if r["psnr_db"] < FLAGSHIP_DB]
    faults += [f"frame {t}: accept bits {r['accept_share']:.4%} equal"
               for t, r in enumerate(recs)
               if r["accept_share"] < FLAGSHIP_ACCEPT_SHARE]
    faults += [f"frame {t}: accept bits {r['accept_share']:.4%} equal to "
               "the bf16-state oracle's" for t, r in enumerate(recs_bf16)
               if r["accept_share"] <= ACCEPT_SHARE]
    return faults
