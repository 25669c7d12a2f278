"""deltas.reads_per_s: reads the server answered inside the window, over
the window's length, in the cell whose delta stream commits MVCC versions
beside the read backlog: the served capacity left beside the repairs.
Per layer, as ``serve.reads_per_s`` is: the served path is bound by host
time, which spreads from one process to the next."""


def read(run):
    if run.window_s <= 0 or not run.batch_size:
        return None
    done = sum(1 for r in run.reads
               if r.ok and run.t0 <= r.done <= run.t_end)
    return done / run.window_s
