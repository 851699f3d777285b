"""The yardstick: the card's peaks and the least time a piece of work
can take on it, and the roofline counts found by name.

The peaks are the data sheet's for one NVIDIA H100 SXM at its full
700 W: 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor
cores. A kernel's count lives in ``benchmark/roofline/<kernel>.py``
(``TRACE_NAME``, the substring of its name in a profiler trace, and
``count(settings, config) -> (bytes, flops)``), the frame's compulsory
bytes in ``benchmark/roofline/frame.py``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

ROOT = Path(__file__).resolve().parent


def bound_ms(nbytes, flops):
    """``(ms, what bounds it)``: the least time the card could take to
    move ``nbytes`` and do ``flops`` float32 operations."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def load(kind, name):
    """The module ``benchmark/<kind>/<name>.py``, loaded by its path (a
    name may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_share(reading, kernel):
    """A kernel's share of its roofline in a traced run, in %: its bound
    at the cell's shapes over its device ms per launch in the trace, or
    None where the trace holds no launch of it."""
    spec = load("roofline", kernel)
    times = [dur for name, _, dur in reading.device if spec.TRACE_NAME in name]
    if not times:
        return None
    ms_per_launch = sum(times) / len(times) / 1e3
    ms, _ = bound_ms(*spec.count(reading.settings, reading.config))
    return 100.0 * ms / ms_per_launch
