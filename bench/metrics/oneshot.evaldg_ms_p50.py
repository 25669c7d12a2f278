"""oneshot.evaldg_ms_p50: the median time, in ms, of a one-shot query's
evalDG (``engine.evaldg_reach`` / ``evaldg_dist``, a regular path query's
``evaldg_reach`` on the product D: one fixpoint launch, its answer back on
the host)."""
import statistics


def read(run):
    if run.layers is None or not run.layers.evaldg_ms:
        return None
    return statistics.median(run.layers.evaldg_ms)
