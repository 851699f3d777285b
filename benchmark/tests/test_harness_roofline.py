"""The roofline counts at 1280x720, recomputed from the shapes: the
kernel table's compulsory bytes (``chip_smoke.py``'s counts) and the
frame's."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import yardstick  # noqa: E402
from benchmark.reference.bmfr import Settings  # noqa: E402

S = Settings(1280, 720)


@pytest.mark.parametrize("kernel, carry, mb, ms", [
    ("B", "PackedState", 44.4, 0.0132),
    ("C", "TemporalState", 44.4, 0.0132),
    ("D", "TemporalState", 52.6, 0.0157),
    ("F", "PackedState", 104.1, 0.0311),
    ("F", "TemporalState", 93.1, 0.0278),
    ("I", "TemporalState", 133.6, 0.0399),
    ("frame", "PackedState", 114.3, 0.0341),
    ("frame", "TemporalState", 156.7, 0.0468),
])
def test_bytes_at_1280x720(kernel, carry, mb, ms):
    nbytes, flops = yardstick.load("roofline", kernel).count(
        S, {"carry": carry})
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.05)
    bound, by = yardstick.bound_ms(nbytes, flops)
    assert by == "bytes"
    assert bound == pytest.approx(ms, abs=5e-5)


def test_bound_takes_the_larger_time():
    assert yardstick.bound_ms(0, 67e9) == (pytest.approx(1.0), "operations")
    assert yardstick.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")


class _Reading:
    settings = S
    config = {"carry": "PackedState"}
    device = [("fit_chol_kernel<...>", 0.0, 50.0),
              ("fit_chol_kernel<...>", 300.0, 52.0),
              ("Memcpy DtoD (Device -> Device)", 60.0, 5.0)]


def test_kernel_share_reads_the_trace():
    share = yardstick.kernel_share(_Reading, "B")
    bound, _ = yardstick.bound_ms(*yardstick.load("roofline", "B").count(
        S, _Reading.config))
    assert share == pytest.approx(100 * bound / 0.051)
    assert yardstick.kernel_share(_Reading, "D") is None
