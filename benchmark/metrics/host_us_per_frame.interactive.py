"""The host's time in the step call, from the call to its return and
before the wait, in us: the mean over the untraced frames before the
traced range (no profiler's cost in it). What the entry
(``make_denoise_frame``'s step, ``CompiledStep.run``, ``_Slot.load``'s
checks and copies, the replay's launch, the result's copy) costs the
host each frame."""


def read(reading):
    if not reading.host_spans_s:
        return None
    return sum(reading.host_spans_s) / len(reading.host_spans_s) * 1e6
