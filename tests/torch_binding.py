"""A stand-in for the kernel library's graph calls, so the compiled
step's bind-or-copy rule (``bmfr_tpu_torch/pipeline/bind.py``) runs on the
CPU: :class:`FakeLib` answers ``bmfr_bind_scan``, ``bmfr_bind_nodes``,
``bmfr_bind_node``, ``bmfr_bind_apply`` and ``bmfr_bind_free`` from a
list of nodes and records each apply; :func:`binding` makes a
``NodeBinding`` on it."""

from bmfr_tpu_torch.ops import _lib
from bmfr_tpu_torch.pipeline import bind

#: kernel names as the driver gives them (mangled), one per kind of reader
F_TMA = ("_ZN12_GLOBAL__N_120filtered_tail_kernelINS_8TmaLoadsEfEEvNS_6Params"
         "ENS_4MapsE")
F_THREADS = ("_ZN12_GLOBAL__N_120filtered_tail_kernelINS_11ThreadLoadsEfEEvN"
             "S_6ParamsENS_4MapsE")
G = "_ZN12_GLOBAL__N_117noisy_tail_kernelEPKfS1_S1_S1_S1_PfPhS3_Pi"
H = "_ZN12_GLOBAL__N_116reproject_kernelEPKfS1_S1_Pfiii"
TORCH = ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctor"
         "IfEESt5arrayIPcLm1EEEEviT0_T1_")


def flagship_nodes():
    """The flagship's readers of the six placeholders (normals, positions,
    noisy, albedo, camera, offset): H, A, B, G as 4-byte readers, F's TMA
    instance of albedo."""
    return [(bind.KERNEL, H, 0b110010), (bind.KERNEL, "warp_blend_kernel",
                                         0b000011),
            (bind.KERNEL, "fit_chol_kernel", 0b000011), (bind.KERNEL, G,
                                                         0b000111),
            (bind.KERNEL, F_TMA, 0b001000)]


class FakeGraph:
    def raw_cuda_graph(self):
        return 1

    def raw_cuda_graph_exec(self):
        return 2


class FakeLib:
    """The library's ``bmfr_bind_*`` calls over ``nodes``: ``(kind, name,
    mask)`` each. ``applied`` holds the bases of each apply."""

    def __init__(self, nodes):
        self.nodes, self.applied, self.freed = nodes, [], 0

    def bmfr_bind_scan(self, graph, n, lo, size, handle):
        self.lo, self.size = list(lo), list(size)
        handle._obj.value = 7
        return 0

    def bmfr_bind_nodes(self, handle):
        return len(self.nodes)

    def bmfr_bind_node(self, handle, i, name, cap, mask):
        kind, text, bits = self.nodes[i]
        name.value = text.encode()
        mask._obj.value = bits
        return kind

    def bmfr_bind_apply(self, handle, exec_, bases):
        self.applied.append(tuple(bases))
        return 0

    def bmfr_bind_free(self, handle):
        self.freed += 1
        return 0


def binding(monkeypatch, placeholders, nodes=None):
    """A ``NodeBinding`` of ``placeholders`` on :class:`FakeLib` (the
    flagship's nodes by default); returns ``(binding, lib)``."""
    lib = FakeLib(flagship_nodes() if nodes is None else nodes)
    monkeypatch.setattr(_lib, "library", lambda: lib)
    return bind.NodeBinding(FakeGraph(), placeholders), lib
