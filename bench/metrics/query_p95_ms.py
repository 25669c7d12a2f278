"""query_p95_ms: the 95th percentile of every read of the window, in ms.
Open loop: from when the read was due to when its answer was resolved on
the host; closed loop: from the call to its return.  A read that failed,
was refused or never came counts until the run stopped waiting for it."""
import numpy as np


def read(run):
    if not run.reads:
        return None
    lat = [r.latency_s(run.give_up) for r in run.reads]
    return float(np.percentile(lat, 95)) * 1e3
