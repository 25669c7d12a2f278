from .ops import (ALIGN, is_kmajor, kmajor, kmajor_copy, or_and_fixpoint,
                  or_and_floor_pair, or_and_matmul, or_and_matmul_nt, padded,
                  padded_zeros, pitch, rows_aligned, rows_copy)
from .ref import (or_and_fixpoint_ref, or_and_floor_pair_ref,
                  or_and_matmul_nt_ref, or_and_matmul_ref)

__all__ = ["ALIGN", "is_kmajor", "kmajor", "kmajor_copy", "or_and_fixpoint",
           "or_and_fixpoint_ref", "or_and_floor_pair", "or_and_floor_pair_ref",
           "or_and_matmul", "or_and_matmul_nt", "or_and_matmul_nt_ref",
           "or_and_matmul_ref", "padded", "padded_zeros", "pitch",
           "rows_aligned", "rows_copy"]
