"""Whether the timed path's outputs are correct: the program's results and
its carried state against the plain reference (:mod:`.reference.bmfr`).

What is compared: the results of ``sampled`` frames drawn from the seed
among the last ``ring`` frames of the window, and the state the program
carries out of its last frame. The reference works the state out again
from the same rendered inputs: it starts from the zero state ``lead``
frames before the first sampled frame (or at frame 0, where the run
started there) and runs every frame up to the last one. Every blend of
the recurrence keeps at most 0.9 of the frame before (K1 and K5 0.8, K4
0.9, opencl/bmfr.cl:421-429, :836-839, :964), so what the zero state
leaves after 320 frames is below 1e-14 of a value, and the spp count
saturates at 255 after 254 frames of history.

The numbers (each with its limit from the configuration's file, key
``correct``): the relative RMS gap of the sampled results, and of the
carried ``out`` (K4's accumulation, the second half of the state the
next frame reads), both downstream of every stage: the reprojection and
the warp of the carried state, K1 and its accept tests, the fit, the
reconstruction, K4 and K5.

A configuration whose entry is the scene runner (``denoise_scenes_jit``)
is checked on the results of the window's last completed call
(:func:`compare_clips`): for each scene, ``sampled`` frames drawn from
``(seed, scene)`` with its frame 0 and its last frame, against the
reference's replay of that scene's clip from the zero state at frame 0,
as the runner starts every call. Compared: ``result_rel_rms``, the
largest over the scenes. There is no ``out_rel_rms``: the runner hands
back the results only, no carried state.
"""

from __future__ import annotations

import math
import random

import torch

from . import scenes
from .reference import bmfr


def carried(config, state):
    """The program's carried state as float32 ``{field: tensor}``, as the
    next frame reads it: a ``PackedState``'s words (two bf16 a word,
    channel 2k low and 2k+1 high; positions 0:3, normals 3:6, noisy 6:9,
    spp 9, out 10:13, result 13:16) or a ``TemporalState``'s six tensors.
    A ``TemporalState`` stores float32 planes; where the configuration
    states ``state_dtype: "bfloat16"`` the next frame reads them through
    bf16 taps (kernel I in ``packed_bf16`` rounds each tap to bf16,
    nearest-even), and the reference stores them so rounded, so they are
    rounded here too. ``spp`` (u8, whole numbers to 255, which bf16 holds
    exactly) is left as it is, and so is a ``TemporalState`` at
    ``state_dtype: "float32"``."""
    if config["carry"] == "PackedState":
        words = state.src8
        P, H, W = words.shape
        halves = words.contiguous().view(torch.bfloat16).view(P, H, W, 2)
        ch = halves.permute(0, 3, 1, 2).reshape(2 * P, H, W).float()
        return {"positions": ch[0:3], "normals": ch[3:6], "noisy": ch[6:9],
                "spp": ch[9], "out": ch[10:13], "result": ch[13:16]}
    planes = {k: getattr(state, k).float() for k in bmfr.STATE_FIELDS}
    if config["state_dtype"] == "bfloat16":
        planes = {k: v if k == "spp" else v.to(torch.bfloat16).float()
                  for k, v in planes.items()}
    return planes


def rel_rms(got, want):
    """sqrt(sum (got - want)^2 / sum want^2), in float64; NaN where
    ``got`` holds a NaN."""
    got, want = got.double(), want.double()
    return float(torch.sqrt(((got - want) ** 2).sum() / (want ** 2).sum()))


def replay(s, clip, t_from, t_to, keep, precision="highest"):
    """The reference over frames ``t_from..t_to`` from the zero state
    (frame ``t_from`` reads no history): ``(state after t_to, {t: result
    for t in keep})``."""
    state = bmfr.zero_state(s, clip.cams[0].device)
    results = {}
    with torch.no_grad(), bmfr.tf32_off():
        for t in range(t_from, t_to + 1):
            inputs, cam, off = clip.args(t)
            state, out = bmfr.frame_step(
                s, state, inputs.positions, inputs.normals, inputs.noisy,
                inputs.albedo, cam, off, t, history=t > t_from,
                precision=precision)
            if t in keep:
                results[t] = out["result"]
    return state, results


def pick(seed, frames, sampled):
    """``sampled`` of ``frames`` drawn from the seed, in order."""
    return sorted(random.Random(seed).sample(sorted(frames),
                                             min(sampled, len(frames))))


def worst(values):
    """The largest of ``values``, NaN where one is NaN (``max`` keeps
    whichever comes first where a NaN is compared)."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def result_numbers(results, ref_results):
    """The results' numbers of :func:`numbers`: the largest relative RMS
    gap and widest gap of a frame, and the most values 1e-4 off in one."""
    diffs = [(results[t].double() - ref_results[t].double()).abs()
             for t in ref_results]
    return {
        "result_rel_rms": worst(rel_rms(results[t], ref_results[t])
                                for t in ref_results),
        "result_gap": worst(float(d.max()) for d in diffs),
        "result_values_off": max(int((d > 1e-4).sum()) for d in diffs),
    }


def numbers(results, carry, ref_results, ref_state):
    """Every number the comparison can read, by name: the compared ones
    and what the limits' readings look at beside them (the widest gaps,
    how many values lie more than 1e-4 off, the other state planes)."""
    out = (carry["out"].double() - ref_state["out"].double()).abs()
    return {
        **result_numbers(results, ref_results),
        "out_rel_rms": rel_rms(carry["out"], ref_state["out"]),
        "out_gap": float(out.max()),
        "out_values_off": int((out > 1e-4).sum()),
        "noisy_rel_rms": rel_rms(carry["noisy"], ref_state["noisy"]),
        "spp_differ_pct": float((carry["spp"] != ref_state["spp"])
                                .double().mean() * 100),
    }


def compare(s, clip, kept, carry, last_t, seed, check):
    """``(all numbers, {name: (number, limit)} of those compared)``.
    ``kept``: ``{t: result}`` of the window's last frames; ``carry``: the
    program's state after frame ``last_t``; ``check``: the traffic's
    ``check`` (``sampled``, ``lead``) with the configuration's ``limits``
    (a number with its limit for each number compared)."""
    picks = pick(seed, kept, check["sampled"])
    t_from = max(0, picks[0] - check["lead"])
    ref_state, ref_results = replay(s, clip, t_from, last_t, set(picks))
    got = numbers({t: kept[t] for t in picks}, carry, ref_results,
                  ref_state)
    return got, {k: (got[k], lim) for k, lim in check["limits"].items()}


def clip_picks(seed, scene, T, sampled):
    """Scene ``scene``'s compared frames: ``sampled`` of its ``T`` drawn
    from ``(seed, scene)``, with frame 0 and frame ``T - 1``."""
    drawn = pick(scenes.scene_seed(seed, scene), range(T), sampled)
    return sorted(set(drawn) | {0, T - 1})


def clip_numbers(s, batch, results, seed, sampled, control=None):
    """``(numbers, control's numbers)`` of a scene runner's call: each of
    :func:`result_numbers`, the largest over the scenes, and
    ``scene_result_rel_rms``, each scene's. ``batch``: the
    :class:`~benchmark.window.Scenes` handed to the runner; ``results``:
    ``[S, T, 3, H, W]``. ``control``: a precision (``"tf32"``) in which
    the reference also takes the program's place, read against the same
    reference; without it the second item is None."""
    mine, ctl = [], []
    for sc in range(batch.S):
        clip = batch.clip(sc)
        picks = clip_picks(seed, sc, batch.T, sampled)
        _, ref = replay(s, clip, 0, batch.T - 1, set(picks))
        mine.append(result_numbers({t: results[sc, t] for t in picks}, ref))
        if control is not None:
            _, got = replay(s, clip, 0, batch.T - 1, set(picks), control)
            ctl.append(result_numbers(got, ref))
            del got
        del ref

    def merged(per_scene):
        out = {k: worst(n[k] for n in per_scene) for k in per_scene[0]}
        out["scene_result_rel_rms"] = [n["result_rel_rms"]
                                       for n in per_scene]
        return out
    return merged(mine), (merged(ctl) if ctl else None)


def compare_clips(s, batch, results, seed, check):
    """``(all numbers, {name: (number, limit)} of those compared)`` of a
    scene runner's call: ``results`` ``[S, T, 3, H, W]`` of the
    :class:`~benchmark.window.Scenes` ``batch``; ``check``: the traffic's
    ``check`` (``sampled``) with the configuration's ``limits``."""
    got, _ = clip_numbers(s, batch, results, seed, check["sampled"])
    return got, {k: (got[k], lim) for k, lim in check["limits"].items()}


def passed(compared):
    """Each number within its limit (a NaN never is)."""
    return all(v <= lim for v, lim in compared.values())
