from .ops import (bitpack_bool_matmul, bitpack_matmul, pack_cols,
                  pack_payload, pack_rows, packed_bits, unpack_payload,
                  unpack_rows)
from .ref import bitpack_matmul_ref, pack_rows_ref

__all__ = ["bitpack_bool_matmul", "bitpack_matmul", "pack_cols",
           "pack_payload", "pack_rows", "packed_bits", "unpack_payload",
           "unpack_rows", "bitpack_matmul_ref", "pack_rows_ref"]
