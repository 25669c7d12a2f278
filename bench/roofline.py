"""Operations, bytes and the least time of a kernel call, against the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates).

The peaks are constants: no probe is measured in a run, so every run and
every later change is divided by the same numbers.  They assume the card's
full 700 W power limit; a run prints the card's own limit beside them.
"""
from __future__ import annotations

#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: int8 tensor-core operations/s, dense
INT8_TENSOR_OPS_PER_S = 1979e12
#: DPX int32 min-plus operations/s: 64 int32 operations per clock per SM
#: (the integer pipes a ``__viaddmin_s32`` issues on), 132 SMs, the SXM
#: part's maximum SM clock of 1980 MHz
SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_CLOCK_PER_SM = 64
MIN_PLUS_OPS_PER_S = INT32_OPS_PER_CLOCK_PER_SM * SM_COUNT * SM_CLOCK_HZ

PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S,
         "int8_tensor_ops_per_s": INT8_TENSOR_OPS_PER_S,
         "min_plus_ops_per_s": MIN_PLUS_OPS_PER_S}


def bound_s(ops: float, ops_per_s: float, nbytes: float) -> float:
    """The least time the card could take: ``ops`` at ``ops_per_s``, or
    ``nbytes`` moved once at the HBM bandwidth, whichever is longer."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)


def or_and_s(m: int, k: int, n: int, transpose: bool = False) -> float:
    """One or-and product ``[m, k] x [k, n]`` on 1-byte operands: 2mkn int8
    tensor-core operations; each operand read once, the output (and its
    transpose, when written too) written once."""
    return bound_s(2.0 * m * k * n, INT8_TENSOR_OPS_PER_S,
                   m * k + k * n + m * n * (2 if transpose else 1))


def min_plus_s(m: int, k: int, n: int, floor: bool = False) -> float:
    """One min-plus product ``[m, k] x [k, n]`` on int32: mkn DPX
    operations; each operand read once, the output written once, and an
    [m, n] floor read once when there is one."""
    return bound_s(float(m) * k * n, MIN_PLUS_OPS_PER_S,
                   4.0 * (m * k + k * n + m * n * (2 if floor else 1)))
