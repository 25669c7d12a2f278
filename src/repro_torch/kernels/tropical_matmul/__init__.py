from .ops import (ROW_CAP, RowLists, min_plus_matmul, min_plus_settle,
                  min_plus_settle_lists, row_lists, write_row_lists)
from .ref import (INF, min_plus_fixpoint_ref, min_plus_matmul_ref,
                  min_plus_settle_lists_ref, min_plus_settle_ref)

__all__ = ["INF", "ROW_CAP", "RowLists", "min_plus_fixpoint_ref",
           "min_plus_matmul", "min_plus_matmul_ref", "min_plus_settle",
           "min_plus_settle_lists", "min_plus_settle_lists_ref",
           "min_plus_settle_ref", "row_lists", "write_row_lists"]
