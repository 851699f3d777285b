"""The compiled step's bind-or-copy rule on the CPU
(``bmfr_tpu_torch/pipeline/bind.py``, ``_Slot.load`` in
``pipeline/graph.py``), the library's graph calls stood in for by
``tests/torch_binding.py``:

- the alignment each kind of captured reader asks of an input: F's TMA
  instance 16 B, the port's other kernels 4, a kernel outside the port
  256, a copy or an unknown node none (always copied);
- after the capture a load reads a contiguous slice of a ``[T, 3, H, W]``
  clip in place and makes one apply call with the frame's addresses;
  it copies a permuted (channels-last) view, an input whose storage
  offset breaks the alignment its readers ask, and one inside the
  step's carry or outputs, pointing those nodes back at the placeholder;
- the same tensors twice in a row make no second apply call;
- a wrong dtype, shape or device raises as before, before any apply.

The replay against the eager step on the card:
tests/test_torch_gpu.py (``test_compiled_step_reads_inputs_in_place``).
"""

import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu_torch import profiling
from bmfr_tpu_torch.pipeline import bind
from bmfr_tpu_torch.pipeline.graph import _Slot

from torch_binding import F_TMA, F_THREADS, G, TORCH, binding
from torch_threads import one_intra_op_thread  # noqa: F401

H, W, T = 48, 64, 4
CPU = torch.device("cpu")


def flagship_cfg():
    return bt.BMFRConfig(image_width=W, image_height=H,
                         position_limit_squared=0.03,
                         normal_limit_squared=0.5, **bt.FLAGSHIP)


def clip(seed=0):
    """A ``[T, 3, H, W]`` plane of each input, the cameras, the offsets."""
    g = torch.Generator().manual_seed(seed)
    planes = [torch.rand((T, 3, H, W), generator=g)
              for _ in bt.FrameInputs._fields]
    return planes, torch.rand((T, 4, 4), generator=g), torch.rand(
        (T, 2), generator=g)


def frame(planes, cams, offs, t):
    return (bt.FrameInputs(*(p[t] for p in planes)), cams[t], offs[t])


def captured_slot(monkeypatch, carry=bt.PackedState, nodes=None):
    """A flagship slot as the capture leaves it: loaded once (every input
    copied), then bound, with outputs of its own."""
    slot = _Slot(flagship_cfg(), carry, CPU)
    planes, cams, offs = clip(99)
    state = carry.initial(flagship_cfg(), CPU)
    slot.load(state, *frame(planes, cams, offs, 0), 1)
    b, lib = binding(monkeypatch, slot.placeholders, nodes)
    outputs = dict(result=torch.zeros((3, H, W)),
                   tone=torch.zeros((3, H, W)))
    slot.bind(b, outputs)
    return slot, slot.hand_out(True), lib, outputs


@pytest.mark.parametrize("kind,name,need", [
    (bind.KERNEL, F_TMA, 16), (bind.KERNEL, F_THREADS, 4),
    (bind.KERNEL, G, 4), (bind.KERNEL, "block_reconstruct_kernel", 4),
    (bind.KERNEL, TORCH, 256), (bind.COPY, "", None),
    (bind.OPAQUE, "", None)])
def test_reader_alignment(kind, name, need):
    assert bind.reader_alignment(kind, name) == need


def test_input_alignment_is_the_strictest_reader():
    assert bind.input_alignment([]) == 4
    assert bind.input_alignment([(bind.KERNEL, G),
                                 (bind.KERNEL, F_TMA)]) == 16
    assert bind.input_alignment([(bind.KERNEL, TORCH),
                                 (bind.KERNEL, F_TMA)]) == 256
    assert bind.input_alignment([(bind.KERNEL, F_TMA),
                                 (bind.COPY, "")]) is None


def test_binding_reads_its_nodes(monkeypatch):
    slot = _Slot(flagship_cfg(), bt.PackedState, CPU)
    b, lib = binding(monkeypatch, slot.placeholders)
    assert lib.lo == [t.data_ptr() for t in slot.placeholders]
    assert lib.size == [3 * H * W * 4] * 4 + [64, 8]
    assert b.alignment == (4, 4, 4, 16, 4, 4)
    assert b.bound == slot.homes
    assert [len(r) for r in b.readers] == [3, 4, 1, 1, 1, 1]
    del b
    assert lib.freed == 1


def test_load_reads_a_clip_slice_in_place(monkeypatch):
    slot, held, lib, _ = captured_slot(monkeypatch)
    planes, cams, offs = clip(1)
    copies = profiling.counters().get("copies", 0)
    inplace = profiling.counters().get("inputs_in_place", 0)
    before = [t.clone() for t in slot.placeholders]
    slot.load(held, *frame(planes, cams, offs, 2), 2)
    inputs, cam, off = frame(planes, cams, offs, 2)
    assert lib.applied == [tuple(t.data_ptr()
                                 for t in (*inputs, cam, off))]
    assert profiling.counters()["copies"] - copies == 1
    assert profiling.counters()["inputs_in_place"] - inplace == 6
    # the placeholders were not written
    for a, b in zip(before, slot.placeholders):
        assert torch.equal(a, b)
    assert int(slot.frame) == 2


def test_same_tensors_twice_make_one_call(monkeypatch):
    slot, held, lib, _ = captured_slot(monkeypatch)
    planes, cams, offs = clip(2)
    for _ in range(2):
        slot.load(held, *frame(planes, cams, offs, 1), 3)
    slot.load(held, *frame(planes, cams, offs, 3), 4)
    assert len(lib.applied) == 2
    assert lib.applied[0] != lib.applied[1]


def test_channels_last_view_is_copied(monkeypatch):
    slot, held, lib, _ = captured_slot(monkeypatch)
    planes, cams, offs = clip(3)
    inputs, cam, off = frame(planes, cams, offs, 1)
    noisy = inputs.noisy.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    assert not noisy.is_contiguous()
    inplace = profiling.counters().get("inputs_in_place", 0)
    copies = profiling.counters().get("copies", 0)
    slot.load(held, inputs._replace(noisy=noisy), cam, off, 5)
    (bases,) = lib.applied
    assert bases[2] == slot.homes[2]
    assert torch.equal(slot.inputs.noisy, noisy)
    assert bases[:2] == (inputs.normals.data_ptr(),
                         inputs.positions.data_ptr())
    assert profiling.counters()["inputs_in_place"] - inplace == 5
    assert profiling.counters()["copies"] - copies == 2


def test_misaligned_input_is_copied_where_its_readers_ask(monkeypatch):
    """One float past a 64 B boundary: albedo, which F's TMA instance
    reads on 16 B, is copied; noisy, read by 4-byte words, is read in
    place."""
    slot, held, lib, _ = captured_slot(monkeypatch)
    planes, cams, offs = clip(4)
    inputs, cam, off = frame(planes, cams, offs, 1)
    n = 3 * H * W
    flat = torch.empty(2 * n + 1)
    albedo = flat[1:n + 1].view(3, H, W)
    albedo.copy_(inputs.albedo)
    noisy = flat[n + 1:].view(3, H, W)
    noisy.copy_(inputs.noisy)
    assert albedo.is_contiguous() and albedo.data_ptr() % 16 == 4
    slot.load(held, inputs._replace(albedo=albedo, noisy=noisy), cam, off,
              6)
    (bases,) = lib.applied
    assert bases[3] == slot.homes[3] and bases[2] == noisy.data_ptr()
    assert torch.equal(slot.inputs.albedo, albedo)


def at(t, residue):
    """A contiguous copy of ``t`` whose address is ``residue`` past a
    256 B boundary."""
    flat = torch.empty(t.numel() + 64)
    k = (residue - flat.data_ptr() % 256) % 256 // 4
    out = flat[k:k + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 256 == residue
    return out


@pytest.mark.parametrize("residue,read", [(0, True), (64, False)])
def test_foreign_reader_and_copy_node(monkeypatch, residue, read):
    """An input a kernel outside the port reads is read in place only on
    256 B; one a copy node reads is always copied."""
    nodes = [(bind.KERNEL, TORCH, 0b000001), (bind.COPY, "", 0b000010)]
    slot, held, lib, _ = captured_slot(monkeypatch, nodes=nodes)
    assert slot.binding.alignment == (256, None, 4, 4, 4, 4)
    planes, cams, offs = clip(5)
    inputs, cam, off = frame(planes, cams, offs, 1)
    normals = at(inputs.normals, residue)
    slot.load(held, inputs._replace(normals=normals), cam, off, 7)
    (bases,) = lib.applied
    assert bases[0] == (normals.data_ptr() if read else slot.homes[0])
    assert bases[1] == slot.homes[1]
    assert bases[2:] == tuple(t.data_ptr() for t in (inputs.noisy,
                                                     inputs.albedo, cam, off))


def test_input_the_step_writes_is_copied(monkeypatch):
    """A plane of the carry, or the step's own result, handed in as an
    input: the step writes it while its kernels read it, so it is
    copied."""
    slot, held, lib, outputs = captured_slot(monkeypatch,
                                             carry=bt.TemporalState)
    planes, cams, offs = clip(6)
    inputs, cam, off = frame(planes, cams, offs, 1)
    slot.load(held, inputs._replace(positions=held.positions,
                                    albedo=outputs["tone"][:, :, :]), cam,
              off, 8)
    (bases,) = lib.applied
    assert bases[1] == slot.homes[1] and bases[3] == slot.homes[3]
    assert bases[0] == inputs.normals.data_ptr()


@pytest.mark.parametrize("field,bad,match", [
    ("noisy", torch.zeros((3, H, W), dtype=torch.float64), "noisy"),
    ("albedo", torch.zeros((3, H, W + 1)), "albedo"),
    ("normals", torch.zeros((3, H, W), device="meta"), "normals")])
def test_wrong_input_still_raises(monkeypatch, field, bad, match):
    slot, held, lib, _ = captured_slot(monkeypatch)
    planes, cams, offs = clip(7)
    inputs, cam, off = frame(planes, cams, offs, 1)
    with pytest.raises(ValueError, match=match):
        slot.load(held, inputs._replace(**{field: bad}), cam, off, 9)
    with pytest.raises(ValueError, match="prev_cam"):
        slot.load(held, inputs, cam[:3], off, 9)
    with pytest.raises(ValueError, match="pixel_offset"):
        slot.load(held, inputs, cam, off.double(), 9)
    assert lib.applied == []
