"""The compiled step reads the caller's frame where it lies.

The step's CUDA graph (:mod:`~bmfr_tpu_torch.pipeline.graph`) is
captured on placeholders: a slot's static input buffers, the four
``[3, H, W]`` planes, the ``[4, 4]`` camera and the ``[2]`` offset, whose
addresses the capture wrote into the kernel nodes' arguments. Right
after the capture a :class:`NodeBinding` walks the graph once
(``csrc/graph_bind.cu``) and records every argument word that points
into a placeholder, struct arguments included (kernels J's and K's
``FeatureTable``, F's ``Params``); kernel F's TMA maps are encoded again
by F's own encoder, never patched. Before a replay one C call points
those words at the frame's own tensors (``cuGraphExecKernelNodeSetParams``:
the launches that follow change, none already enqueued), and a frame at
the last frame's addresses makes no call.

Input by input, :func:`in_place` decides: a tensor is read where it lies
when it is contiguous, at the alignment its captured readers ask
(:func:`reader_alignment`) and in no storage the step writes; any other
is copied into its placeholder, which its nodes then read, as before.
The kernels run the same instructions on the same values either way.
"""

from __future__ import annotations

import ctypes

from ..ops import _lib
from ..ops.tail import TMA_ALIGN

#: the kinds of node ``bmfr_bind_node`` reports: a kernel whose
#: arguments were read, a copy or fill, a node whose reads are not known
KERNEL, COPY, OPAQUE = 0, 1, 2
#: what an f32 input's address always is: the port's kernels but F's TMA
#: instance read inputs by 4-byte words
WORD = 4
#: the alignment asked of an input that a kernel outside the port reads
#: (a user's feature function, say): such a kernel may have chosen a
#: vector width from the placeholder's address at capture, and none can
#: assume more of a tensor than the allocator's 256 B
FOREIGN_ALIGN = 256


def reader_alignment(kind, name):
    """The byte alignment a node (``kind``, and a kernel's function
    ``name``) asks of an input it reads, or None where the input must stay
    in its placeholder (a copy or fill reads it there, or what the node
    reads is not known). Kernel F's TMA instance was chosen at capture for
    inputs on :data:`TMA_ALIGN` bytes (:func:`~bmfr_tpu_torch.ops.tail.
    filtered_tail_loader`); the port's other kernels read 4-byte words."""
    if kind != KERNEL:
        return None
    if not any(k in name for k in _lib.KERNELS):
        return FOREIGN_ALIGN
    if "filtered_tail_kernel" in name and "TmaLoads" in name:
        return TMA_ALIGN
    return WORD


def input_alignment(readers):
    """The alignment an input's captured ``readers`` (``(kind, name)``
    pairs) ask together: the largest, or None where one forbids it."""
    need = WORD
    for kind, name in readers:
        a = reader_alignment(kind, name)
        if a is None:
            return None
        need = max(need, a)
    return need


def storage_start(t):
    """The address where ``t``'s storage starts (two tensors share memory
    only inside one storage)."""
    return t.data_ptr() - t.storage_offset() * t.element_size()


def in_place(t, need, written):
    """Whether the replay reads ``t`` (already checked for dtype, shape
    and device) where it lies: ``need`` (:func:`input_alignment`) is not
    None, ``t`` is contiguous at an address on ``need`` bytes, and its
    storage is none of ``written`` (the storage starts of what the step
    writes: a kernel would read the input while the step writes it)."""
    return (need is not None and t.is_contiguous()
            and t.data_ptr() % need == 0
            and storage_start(t) not in written)


def _check(rc, what):
    if rc == -2:
        raise RuntimeError(f"{what}: libcuda lacks a graph call "
                           "(cuFuncGetParamInfo needs CUDA 12.4)")
    if rc <= _lib.ENCODE_FAILED:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed "
                           f"(CUresult {_lib.ENCODE_FAILED - rc})")
    if rc == -1:
        raise RuntimeError(f"{what}: libcuda has no cuTensorMapEncodeTiled")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


class NodeBinding:
    """The argument words of ``graph`` (a captured, instantiated
    ``torch.cuda.CUDAGraph(keep_graph=True)``) that point into
    ``placeholders`` (contiguous tensors, at most 64), and the one C call
    that points them elsewhere.

    ``readers``: per placeholder, the ``(kind, name)`` of each node that
    reaches it; ``alignment``: what :func:`input_alignment` asks of a
    tensor read in its place. ``bind(bases)`` points each placeholder's
    words at ``bases[r]`` (the placeholder's own address points them
    back)."""

    def __init__(self, graph, placeholders):
        lib = _lib.library()
        n = len(placeholders)
        lo = (ctypes.c_ulonglong * n)(*(t.data_ptr() for t in placeholders))
        size = (ctypes.c_ulonglong * n)(
            *(t.numel() * t.element_size() for t in placeholders))
        handle = ctypes.c_void_p()
        _check(lib.bmfr_bind_scan(graph.raw_cuda_graph(), n, lo, size,
                                  ctypes.byref(handle)),
               "bmfr_bind_scan")
        self._lib, self._handle = lib, handle
        self._exec = graph.raw_cuda_graph_exec()
        self._n = n
        readers = [[] for _ in range(n)]
        name = ctypes.create_string_buffer(512)
        mask = ctypes.c_ulonglong()
        for i in range(lib.bmfr_bind_nodes(handle)):
            kind = lib.bmfr_bind_node(handle, i, name, len(name),
                                      ctypes.byref(mask))
            for r in range(n):
                if mask.value >> r & 1:
                    readers[r].append((kind, name.value.decode()))
        self.readers = tuple(map(tuple, readers))
        self.alignment = tuple(map(input_alignment, readers))
        self.bound = tuple(lo)

    def bind(self, bases):
        """Point the captured nodes at ``bases`` (one address per
        placeholder); no call where they point there already."""
        if bases == self.bound:
            return
        arr = (ctypes.c_ulonglong * self._n)(*bases)
        _check(self._lib.bmfr_bind_apply(self._handle, self._exec, arr),
               "bmfr_bind_apply")
        self.bound = bases

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.bmfr_bind_free(handle)
