"""The card's ms a call of the scene runner outside its steady graph
replays, idle included: from the end of one call's last replay to the
start of the next call's first, averaged over the traced calls. A replay
is the device events that carry one ``cudaGraphLaunch``'s correlation id
(``Reading.replay_of``); an edge is a stretch between two replays in
which a port kernel that no replay ran starts (a frame 0, run eagerly).
It holds the S eager frame 0s, the S zero states, the copy of the last
frame's results and the gather of the call's results."""

import bisect


def read(reading):
    from bmfr_tpu_torch.ops._lib import KERNELS

    spans, eager = {}, []
    for (name, start, dur), rid in zip(reading.device, reading.replay_of):
        if rid is None:
            if any(k in name for k in KERNELS):
                eager.append(start)
        else:
            lo, hi = spans.get(rid, (start, start + dur))
            spans[rid] = (min(lo, start), max(hi, start + dur))
    replays = sorted(spans.values())
    eager.sort()
    edges = []
    for (_, end), (start, _) in zip(replays, replays[1:]):
        i = bisect.bisect_left(eager, end)
        if i < len(eager) and eager[i] < start:
            edges.append(start - end)
    if not edges:
        return None
    return sum(edges) / len(edges) / 1e3
