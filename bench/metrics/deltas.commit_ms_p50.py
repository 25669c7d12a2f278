"""deltas.commit_ms_p50: the median, in ms, over the window's deltas, of
the time from when a delta was due to when its commit resolved (its
version readable); a delta that failed or never committed counts until
the run stopped waiting for it."""
import statistics


def read(run):
    if not run.deltas:
        return None
    return statistics.median(d.latency_s(run.give_up)
                             for d in run.deltas) * 1e3
