"""The port's spans and named counters (``bmfr_tpu_torch/profiling.py``)
on the CPU:

- a span that is off is the shared no-op and records nothing;
- inside ``recording()`` spans keep their nesting (``parent``), the root's
  frame and their self time, and past the limit are dropped and counted;
- inside a profiler a span is a host event of its name;
- ``make_denoise_frame``'s step records ``entry.step`` around
  ``entry.eager``; ``_Slot.load`` records ``step.load`` and counts its
  copies (the six inputs before the capture, none after it, where they
  count in ``inputs_in_place``), with the carry's only when it loads
  another state;
- the ``copies`` counter never enters ``tally_launches()``, and a
  replay's one ``count_launches`` call counts as ``count_launch`` did;
- counters and spans stay exact with threads stepping at once.

The compiled step's spans and copies on the card: tests/test_torch_gpu.py
(``test_compiled_step_spans_and_copies``).
"""

import sys
import threading

import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu_torch import profiling
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.ops import _lib
from bmfr_tpu_torch.pipeline.graph import _Slot

from torch_binding import binding
from torch_threads import one_intra_op_thread  # noqa: F401

H, W = 48, 64
CPU = torch.device("cpu")


def cfg_of(**kw):
    return bt.BMFRConfig(image_width=W, image_height=H,
                         position_limit_squared=0.03,
                         normal_limit_squared=0.5, **kw)


def frame_inputs(t=0):
    g = torch.Generator().manual_seed(t)
    return bt.FrameInputs(*(torch.rand((3, H, W), generator=g)
                            for _ in bt.FrameInputs._fields))


def test_span_off_is_the_shared_noop():
    assert profiling._ACTIVE is None
    assert profiling.span("entry.step", 3) is profiling._NO_RANGE
    with profiling.span("step.load"):
        pass
    with profiling.recording() as rec:
        pass
    assert rec.records == [] and rec.dropped == 0


def test_recording_keeps_nesting_frame_and_self_time():
    with profiling.recording() as rec:
        with profiling.span("entry.step", 7):
            with profiling.span("step.run"):
                with profiling.span("step.load"):
                    pass
                with profiling.span("step.replay"):
                    pass
            with profiling.span("entry.clone"):
                pass
        with profiling.span("entry.step", 8):
            pass
    names = [r[0] for r in rec.records]
    assert names == ["entry.step", "step.run", "step.load", "step.replay",
                     "entry.clone", "entry.step"]
    assert [r[3] for r in rec.records] == [None, 0, 1, 1, 0, None]
    assert [r[4] for r in rec.records] == [7, 7, 7, 7, 7, 8]
    for name, start, end, parent, _ in rec.records:
        assert start <= end
        if parent is not None:
            p = rec.records[parent]
            assert p[1] <= start and end <= p[2]
    dur = [r[2] - r[1] for r in rec.records]
    own = profiling.self_ns(rec.records)
    assert own[0] == dur[0] - dur[1] - dur[4]
    assert own[1] == dur[1] - dur[2] - dur[3]
    assert own[2:] == dur[2:4] + [dur[4], dur[5]]
    assert profiling.span("entry.step") is profiling._NO_RANGE


def test_recording_drops_spans_past_its_limit():
    with profiling.recording(limit=2) as rec:
        for _ in range(5):
            with profiling.span("step.load"):
                pass
    assert len(rec.records) == 2 and rec.dropped == 3
    with pytest.raises(RuntimeError, match="already"):
        with profiling.recording(), profiling.recording():
            pass


def test_span_in_a_cpu_profiler_is_a_host_event():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("step.replay"):
            torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "step.replay" in names
    assert profiling.span("step.replay") is profiling._NO_RANGE


def test_make_denoise_frame_records_entry_step_around_eager():
    sc = synthetic_sequence(width=W, height=H, frames=2, seed=0)
    inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                        sc["noisy"], sc["albedo"], "cpu")
    cams = torch.from_numpy(sc["camera_matrices"])
    offs = torch.from_numpy(sc["pixel_offsets"])
    cfg = cfg_of(**bt.FLAGSHIP)
    step = bt.make_denoise_frame(cfg)
    state = bt.zero_state(cfg, "cpu")
    with profiling.recording() as rec:
        for t in range(2):
            state, _ = step(state, bt.FrameInputs(*(x[t] for x in inputs)),
                            cams[max(t - 1, 0)], offs[t], t)
    assert [(r[0], r[3], r[4]) for r in rec.records] == [
        ("entry.step", None, 0), ("entry.eager", 0, 0),
        ("entry.step", None, 1), ("entry.eager", 2, 1)]
    for outer, inner in ((0, 1), (2, 3)):
        o, i = rec.records[outer], rec.records[inner]
        assert o[2] - o[1] > i[2] - i[1] > 0


@pytest.mark.parametrize("carry, carried", [("packed", 1), ("temporal", 6)])
def test_slot_load_counts_its_copies(carry, carried, monkeypatch):
    """Before the capture a load copies the six inputs and fills the
    frame; after it (the library's graph calls stood in for,
    ``tests/torch_binding.py``) it fills the frame only and counts the six
    inputs in ``inputs_in_place``; a state from elsewhere adds the carry's
    copies, as does a returned copy of the carry."""
    cfg = cfg_of(**bt.FLAGSHIP)
    state_type = bt.PackedState if carry == "packed" else bt.TemporalState
    slot = _Slot(cfg, state_type, CPU)
    state = state_type.initial(cfg, CPU)
    cam, off = torch.eye(4), torch.zeros(2)
    before = profiling.counters().get("copies", 0)
    read = profiling.counters().get("inputs_in_place", 0)
    with profiling.recording() as rec:
        slot.load(state, frame_inputs(1), cam, off, 1)
        first = profiling.counters()["copies"] - before
        outputs = dict(result=torch.zeros(3, H, W),
                       tone=torch.zeros(3, H, W))
        slot.bind(binding(monkeypatch, slot.placeholders)[0], outputs)
        held = slot.hand_out(True)
        slot.load(held, frame_inputs(2), cam, off,
                  torch.tensor(2, dtype=torch.int32))
        second = profiling.counters()["copies"] - before - first
        slot.load(state, frame_inputs(3), cam, off, 3)
        third = profiling.counters()["copies"] - before - first - second
    assert first == 7 + carried
    assert second == 1
    assert third == 1 + carried
    assert profiling.counters()["inputs_in_place"] - read == 12
    assert [r[0] for r in rec.records] == ["step.load"] * 3
    assert torch.equal(slot.frame, torch.tensor(3, dtype=torch.int32))
    assert torch.equal(slot.inputs.noisy, frame_inputs(1).noisy)
    slot.hand_out(False)
    assert profiling.counters()["copies"] - before == (9 + carried * 3)


def test_copies_never_enter_the_tally():
    class Wrapper:
        launches = 0

    before = profiling.counters().get("copies", 0)
    with _lib.tally_launches() as tally:
        profiling.count("copies", 3)
        _lib.count_launch(Wrapper, 2)
    assert tally == {Wrapper: 2}
    assert profiling.counters()["copies"] == before + 3
    assert Wrapper.launches == 0


def test_count_launches_counts_as_count_launch():
    class A:
        launches = 0

    class B:
        launches = 5

    _lib.count_launches([(A, 2), (B, 3)])
    assert (A.launches, B.launches) == (2, 8)
    with _lib.tally_launches() as tally:
        _lib.count_launches([(A, 2), (B, 3)])
        _lib.count_launches([(A, 1)])
    assert tally == {A: 3, B: 3}
    assert (A.launches, B.launches) == (2, 8)


def test_counters_and_spans_stay_exact_under_threads():
    """More threads than cores, each nesting spans with a frame of its own
    and counting, with a short switch interval: no count lost, every
    child's parent its own thread's span."""
    threads_n, rounds = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    before = profiling.counters().get("copies", 0)

    def work(k):
        for _ in range(rounds):
            with profiling.span("entry.step", k):
                with profiling.span("step.load"):
                    profiling.count("copies")

    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counters()["copies"] == before + threads_n * rounds
    assert len(rec.records) == 2 * threads_n * rounds
    for name, _, _, parent, frame in rec.records:
        if name == "step.load":
            assert rec.records[parent][0] == "entry.step"
            assert rec.records[parent][4] == frame
        else:
            assert parent is None
