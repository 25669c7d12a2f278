"""or_and_compose_roofline: the or-and compose's share of its roofline,
in %: the least time of every batch's compose, ``[M, nb] x [nb, nb]``
with M the batch's reach count (``bench/roofline.py``), summed over the
window, over the device time of the or-and tile kernel in the trace.
Read where every or-and launch of the window is a compose (no deltas)."""
from bench import roofline

KERNEL = "or_and_wgmma_kernel"


def read(run):
    if run.trace is None or run.layers is None or not run.layers.nb:
        return None
    spent = run.trace.kernel_s(KERNEL)
    nb = run.layers.nb
    least = sum(roofline.or_and_s(b["reach"], nb, nb)
                for b in run.layers.batch_m if b["reach"])
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
