from .ops import min_plus_matmul, min_plus_settle
from .ref import (INF, min_plus_fixpoint_ref, min_plus_matmul_ref,
                  min_plus_settle_ref)

__all__ = ["INF", "min_plus_fixpoint_ref", "min_plus_matmul",
           "min_plus_matmul_ref", "min_plus_settle", "min_plus_settle_ref"]
