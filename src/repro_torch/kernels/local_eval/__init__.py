from .ops import (check_args, local_eval_dist_into, local_eval_dist_lists,
                  local_eval_reach_into)

__all__ = ["check_args", "local_eval_dist_into", "local_eval_dist_lists",
           "local_eval_reach_into"]
