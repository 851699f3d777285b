"""The renderer's loop: frames handed to the step one after another, with
at most ``in_flight`` of them not yet completed (:func:`drive`); or, for
the scene runner, whole clips of S scenes handed to it call after call,
with at most ``in_flight`` calls not yet completed (:func:`drive_calls`).

Frame ``t`` is clip frame ``t mod T``: its planes, the camera of the
frame before it (the reference's one-frame lag, opencl/bmfr.cpp:440-444)
and its pixel offset. The frame number handed to the step keeps growing.
Before frame ``t`` goes in, the loop waits for the completion event of
frame ``t - in_flight``; a frame's latency runs from the call of the step
to the return from its completion event. A call of the scene runner is
waited for in the same way, and counts S x T scene-frames.
"""

from __future__ import annotations

import collections
import sys
import time
import traceback


class Clip:
    """The clip's frames as the step takes them, built once."""

    def __init__(self, frame_inputs, planes, cams, offs):
        self.T = cams.shape[0]
        self.inputs = [frame_inputs(planes["normals"][k],
                                    planes["positions"][k],
                                    planes["noisy"][k], planes["albedo"][k])
                       for k in range(self.T)]
        self.cams = [cams[k] for k in range(self.T)]
        self.offs = [offs[k] for k in range(self.T)]

    def args(self, t):
        """``(inputs, prev_cam, pixel_offset)`` of frame ``t``."""
        k = t % self.T
        return self.inputs[k], self.cams[(t - 1) % self.T], self.offs[k]


class Scenes:
    """S clips stacked as the scene runner takes them: ``inputs`` the
    frame inputs of ``[S, T, 3, H, W]``, ``cams`` ``[S, T, 4, 4]``,
    ``offs`` ``[S, T, 2]``."""

    def __init__(self, frame_inputs, planes, cams, offs):
        self.frame_inputs = frame_inputs
        self.S, self.T = cams.shape[:2]
        self.inputs = frame_inputs(planes["normals"], planes["positions"],
                                   planes["noisy"], planes["albedo"])
        self.cams, self.offs = cams, offs

    def clip(self, s):
        """Scene ``s`` as a :class:`Clip` (views, no copy)."""
        planes = dict(zip(("normals", "positions", "noisy", "albedo"),
                          (x[s] for x in self.inputs)))
        return Clip(self.frame_inputs, planes, self.cams[s], self.offs[s])


class _Done:
    """A completion event on the CPU, where every frame has completed
    when the step returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


def events(device, n):
    import torch

    if device.type == "cuda":
        return [torch.cuda.Event() for _ in range(n)]
    return [_Done() for _ in range(n)]


class Run:
    """What a stretch of the loop did: frames handed in and completed,
    frames whose step raised, and, where asked for, each frame's latency
    and host span (s)."""

    def __init__(self):
        self.frames = 0
        self.failed = 0
        self.latencies = []
        self.host_spans = []


def drive(step, state, clip, t, in_flight, fences, *, frames=None,
          deadline=None, keep=None, run=None, spans=False, annotate=None):
    """Hand frames ``t, t+1, ...`` to ``step`` until ``frames`` were
    handed in or the host clock passed ``deadline``, then wait for all.
    ``fences``: ``in_flight`` completion events. ``keep``: a deque that
    takes ``(t, result)`` of every frame. ``run``: the :class:`Run` that
    counts them (its latencies always, host spans with ``spans``).
    ``annotate``: a context factory for the profiler's host ranges
    (``annotate(name)``). Returns ``(state, next t)``; a step that raises
    ends the stretch."""
    perf = time.perf_counter
    pending = collections.deque()
    lat = run.latencies
    host = run.host_spans if spans else None
    n = 0
    while (frames is None or n < frames) and (deadline is None
                                               or perf() < deadline):
        if len(pending) >= in_flight:
            tc, ev = pending.popleft()
            if annotate is None:
                ev.synchronize()
            else:
                with annotate("bench.wait"):
                    ev.synchronize()
            lat.append(perf() - tc)
        inputs, cam, off = clip.args(t)
        tc = perf()
        try:
            if annotate is None:
                state, result = step(state, inputs, cam, off, t)
            else:
                with annotate("bench.step"):
                    state, result = step(state, inputs, cam, off, t)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            run.failed += 1
            break
        if host is not None:
            host.append(perf() - tc)
        ev = fences[t % in_flight]
        ev.record()
        pending.append((tc, ev))
        if keep is not None:
            keep.append((t, result))
        t += 1
        n += 1
    while pending:
        tc, ev = pending.popleft()
        ev.synchronize()
        lat.append(perf() - tc)
    run.frames += n
    return state, t


def drive_calls(runner, scenes, in_flight, fences, *, calls=None,
                deadline=None, keep=None, run=None, annotate=None):
    """Hand the :class:`Scenes` ``scenes`` to ``runner`` call after call
    until ``calls`` calls were handed in or the host clock passed
    ``deadline``, then wait for all. ``fences``: ``in_flight`` completion
    events. ``keep``: a deque that takes the results of every call.
    ``run``: the :class:`Run` that counts scene-frames, S x T a call (its
    latencies are the calls'). ``annotate``: as in :func:`drive`.
    Returns the number of calls handed in; a runner that raises counts
    the call's scene-frames as failed and ends the stretch."""
    perf = time.perf_counter
    pending = collections.deque()
    per_call = scenes.S * scenes.T
    n = 0
    while (calls is None or n < calls) and (deadline is None
                                             or perf() < deadline):
        if len(pending) >= in_flight:
            tc, ev = pending.popleft()
            if annotate is None:
                ev.synchronize()
            else:
                with annotate("bench.wait"):
                    ev.synchronize()
            run.latencies.append(perf() - tc)
        tc = perf()
        try:
            if annotate is None:
                results = runner(scenes.inputs, scenes.cams, scenes.offs)
            else:
                with annotate("bench.call"):
                    results = runner(scenes.inputs, scenes.cams, scenes.offs)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            run.failed += per_call
            break
        ev = fences[n % in_flight]
        ev.record()
        pending.append((tc, ev))
        if keep is not None:
            keep.append(results)
        n += 1
        run.frames += per_call
    while pending:
        tc, ev = pending.popleft()
        ev.synchronize()
        run.latencies.append(perf() - tc)
    return n
