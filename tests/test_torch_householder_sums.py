"""The warp reduction of the Householder core's reflections, on the CPU.

``csrc/householder.cuh::group_sum`` sums each of a reflection's N live
values over a warp by a transpose reduction over P values (P the power of
two from N up: log2 P steps at lane offsets 16, 8, ..), then a butterfly
over the offsets left down to 1. This file replays that reduction lane by
lane in f32 numpy and holds the totals of every P that can carry N values
to each other bit for bit: whatever the count of live values, each total
is summed over the offsets 16, 8, 4, 2, 1 in that order, so the
reflections give the same sums as when every reflection carried 16.
"""

import numpy as np
import pytest

LANES = 32


def transpose_halves(a, steps):
    """``fitter_front.cuh::transpose_halves`` with the sum over the 32
    lanes' rows of ``a`` ``[32, P]``: at step S each lane keeps one half
    of the values it carries and adds its partner's (lane ^ o, o = 16 >>
    S) copy of that half."""
    a = a.copy()
    P = a.shape[1]
    for s in range(steps):
        half, o = P >> (s + 1), 16 >> s
        out = a.copy()
        for lane in range(LANES):
            upper = lane & o
            partner = lane ^ o
            for i in range(half):
                keep = a[lane, i + half] if upper else a[lane, i]
                give = a[partner, i] if partner & o else a[partner, i + half]
                out[lane, i] = np.float32(keep + give)
        a = out
    return a


def warp_totals(v, P):
    """The warp totals of the values ``v`` ``[32, N]`` as ``group_sum``
    leaves them for the cross-warp sum: value c's from lane c * 32 / P."""
    n = v.shape[1]
    steps = P.bit_length() - 1
    a = np.zeros((LANES, P), np.float32)
    a[:, :n] = v
    a = transpose_halves(a, steps)[:, 0]
    span = LANES // P
    o = span // 2
    while o:
        a = np.array([np.float32(a[lane] + a[lane ^ o])
                      for lane in range(LANES)], np.float32)
        o //= 2
    return np.array([a[c * span] for c in range(n)], np.float32)


@pytest.mark.parametrize("n", range(1, 17))
def test_live_values_keep_their_summation_tree(n):
    rng = np.random.default_rng(n)
    # magnitudes over many octaves, so a different tree rounds differently
    v = (rng.standard_normal((LANES, n))
         * 2.0 ** rng.integers(-12, 12, (LANES, n))).astype(np.float32)
    want = warp_totals(v, 16)
    # each total is the butterfly's over the offsets 16, 8, 4, 2, 1
    tree = v.copy()
    for o in (16, 8, 4, 2, 1):
        tree = (tree + tree[np.arange(LANES) ^ o]).astype(np.float32)
    assert want.view(np.uint32).tolist() == tree[0].view(np.uint32).tolist()
    for P in (1, 2, 4, 8):
        if P >= n:
            got = warp_totals(v, P)
            assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    # the replay tells trees apart: a plain sum in lane order rounds
    # differently on some value
    if n == 16:
        plain = np.array([np.float32(0)] * n, np.float32)
        for lane in range(LANES):
            plain = (plain + v[lane]).astype(np.float32)
        assert not np.array_equal(plain, want)
