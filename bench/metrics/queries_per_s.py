"""queries_per_s: reads answered inside the window over the window's
length."""


def read(run):
    if run.window_s <= 0:
        return None
    done = sum(1 for r in run.reads
               if r.ok and run.t0 <= r.done <= run.t_end)
    return done / run.window_s
