"""serve.reads_per_s: reads a server answered inside the window, over the
window's length: with a backlog of reads in flight, the served path's
capacity.  Per layer, not end to end: the served path is bound by host
time, which spreads from one process to the next by more than an
end-to-end bound may allow."""


def read(run):
    if run.window_s <= 0 or not run.batch_size:
        return None
    done = sum(1 for r in run.reads
               if r.ok and run.t0 <= r.done <= run.t_end)
    return done / run.window_s
