"""serve.batch_fill: reads answered over the seats the server's batches
offered in the window (``batches_run`` x ``batch_size``), in %."""


def read(run):
    if not run.batches_run or not run.batch_size:
        return None
    done = sum(1 for r in run.reads if r.ok)
    return 100.0 * done / (run.batches_run * run.batch_size)
