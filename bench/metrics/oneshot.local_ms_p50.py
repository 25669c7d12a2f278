"""oneshot.local_ms_p50: the median time, in ms, of a one-shot query's
local stage (``engine.local_eval_reach`` / ``local_eval_dist`` on every
fragment, or a regular path query's ``engine.regular_rvset``, the product
localEval of every fragment written into D, to its last kernel)."""
import statistics


def read(run):
    if run.layers is None or not run.layers.local_ms:
        return None
    return statistics.median(run.layers.local_ms)
