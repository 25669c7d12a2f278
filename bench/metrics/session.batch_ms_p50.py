"""session.batch_ms_p50: the median host time, in ms, of each
``QuerySession.run`` the server made in the window (planner, per-query
phase, composes, answers back on the host)."""
import statistics


def read(run):
    if run.layers is None or not run.layers.session_ms:
        return None
    return statistics.median(run.layers.session_ms)
