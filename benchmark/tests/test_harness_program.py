"""The readers of the program's spans, copy counter and the trace's shared
clock (``benchmark/program.py``) on synthetic readings."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import program  # noqa: E402
from benchmark.reference.bmfr import Settings  # noqa: E402
from benchmark.trace import Reading  # noqa: E402

US = 1000      # ns in a us


def frame_records(t, base):
    """One waited-for frame's spans (us from ``base``): entry.step 0-100
    around step.run 10-80 (step.load 15-45, step.replay 50-75) and
    entry.clone 82-95."""
    i = 5 * t
    spans = [("entry.step", 0, 100, None), ("step.run", 10, 80, i),
             ("step.load", 15, 45, i + 1), ("step.replay", 50, 75, i + 1),
             ("entry.clone", 82, 95, i)]
    return [(n, (base + s) * US, (base + e) * US, p, t)
            for n, s, e, p in spans]


class _Reading:
    """Two frames 1000 us apart: the program's records, the trace's host
    spans (the same, in us) and each frame's two port kernels launched at
    the replay's start + ``lead`` and a copy."""

    frames = 2
    window_us = 2000.0

    def __init__(self, lead=5.0, copies=16):
        recs = frame_records(0, 0) + frame_records(1, 1000)
        self.program = {"records": recs, "frames": 2,
                        "counters": {"copies": copies}}
        self.program_trace = [(n, s / US, e / US) for n, s, e, _, _ in recs]
        self.device = []
        for base in (0, 1000):
            k0 = base + 50 + lead
            self.device += [("fit_chol_kernel<0>", k0, 100.0),
                            ("filtered_tail_kernel", k0 + 100, 50.0),
                            ("Memcpy DtoD (Device -> Device)", base + 20,
                             10.0)]
        spans = sorted((s, s + d) for _, s, d in self.device)
        self.busy_us = sum(e - s for s, e in spans)


def test_each_reader_reads_its_spans_and_counter():
    r = _Reading()
    assert program.entry_us_per_frame(r) == pytest.approx(30.0)
    assert program.load_us_per_frame(r) == pytest.approx(30.0)
    assert program.replay_us_per_frame(r) == pytest.approx(25.0)
    assert program.step_copies_per_frame(r) == pytest.approx(8.0)
    table = program.span_table(r.program["records"])
    assert table["entry.step"] == (2, pytest.approx(100.0),
                                   pytest.approx(17.0))
    assert table["step.run"] == (2, pytest.approx(70.0), pytest.approx(15.0))
    # the entry's self time with the clone, the step's, the load and the
    # replay add up to the whole step call
    assert (program.entry_us_per_frame(r) + table["step.run"][2]
            + program.load_us_per_frame(r) + program.replay_us_per_frame(r)
            == pytest.approx(table["entry.step"][1]))


def test_idle_in_the_program_is_within_the_device_idle():
    r = _Reading()
    # entry.step 0-100: the copy 20-30 and the first kernel 55-100 run
    # inside it: 45 us idle a frame
    assert program.idle_in_program_us(r) == pytest.approx(90.0)
    idle = program.idle_in_program_pct(r)
    assert idle == pytest.approx(4.5)
    device_idle = 100.0 * (1 - r.busy_us / r.window_us)
    assert idle <= device_idle


def test_the_clock_pairing_finds_a_negative_lead_and_shifts_by_it():
    good = _Reading(lead=5.0)
    assert program.clock_lead(good) == (pytest.approx(5.0),
                                        [pytest.approx(5.0)] * 2)
    bad = _Reading(lead=5.0)
    bad.device = [(n, s - 40.0, d) for n, s, d in bad.device]
    lead, leads = program.clock_lead(bad)
    assert lead == pytest.approx(-35.0)
    # the device's events moved back by 35 us: the idle time read is that
    # of events 5 us late, not that of the trace as it stood
    shifted = _Reading(lead=5.0)
    shifted.device = [(n, s - 5.0, d) for n, s, d in shifted.device]
    assert program.idle_in_program_us(bad) == pytest.approx(
        program.idle_in_program_us(shifted))
    assert program.idle_in_program_us(bad) != pytest.approx(
        program.idle_in_program_us(good))


def test_readers_of_a_reading_without_the_program_read_nothing():
    bare = Reading(settings=Settings(64, 48), config={"carry":
                                                      "PackedState"},
                   frames=10, window_us=1000.0, busy_us=500.0,
                   device=[("fit_chol_kernel", 0.0, 500.0)],
                   host_spans_s=[1e-4], gaps=[])
    for name, read in program.READERS.items():
        assert read(bare) is None, name
    assert program.clock_lead(bare) is None
    r = _Reading()
    r.device = r.device[1:]     # 3 port kernels for 2 replays
    assert program.clock_lead(r) is None
