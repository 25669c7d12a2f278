"""min_plus_compose_roofline: the min-plus compose's share of its
roofline, in %: the least time of every batch's compose, ``[M, nb] x
[nb, nb]`` int32 with M the batch's dist and bounded count
(``bench/roofline.py``), summed over the window, over the device time of
the min-plus kernels (skinny and tile routes) in the trace.  Read where
every min-plus launch of the window is a compose (no deltas)."""
from bench import roofline

KERNELS = ("min_plus_skinny_kernel", "min_plus_tile_kernel")


def read(run):
    if run.trace is None or run.layers is None or not run.layers.nb:
        return None
    spent = sum(run.trace.kernel_s(k) for k in KERNELS)
    nb = run.layers.nb
    least = sum(roofline.min_plus_s(b["dist"], nb, nb)
                for b in run.layers.batch_m if b["dist"])
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
