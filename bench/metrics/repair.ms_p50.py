"""repair.ms_p50: the median host time, in ms, of the window's repairs:
each ``QuerySession.repair_on`` the server's repair worker made (the
delta applied to the clone and both closures repaired), synchronized
with the card at its end."""
import statistics


def read(run):
    if run.layers is None or not run.layers.repair_ms:
        return None
    return statistics.median(run.layers.repair_ms)
