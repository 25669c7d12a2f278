"""setup_s: seconds from the process's start to the window's first
request: importing and starting CUDA, loading (or, in a checkout's first
run, building) the kernel libraries, the graph, the fragments, the cache
build and the warm-up."""


def read(run):
    return run.setup_s
