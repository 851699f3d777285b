"""The port's copy of the NumPy oracle of :mod:`bmfr_tpu.oracle` (the
literal restatement of ``opencl/bmfr.cl``, and its vectorized twin as
:mod:`.reference_vec`)."""

from .reference import OracleState, oracle_denoise_frame, oracle_denoise_sequence

__all__ = ["OracleState", "oracle_denoise_frame", "oracle_denoise_sequence"]
