"""setup_s: host seconds from the process's start to the window's first
call (imports, CUDA start, the kernels' build on a checkout's first run,
the weights, the voice's conditionals, the runtime layout, the warm call)."""


def read(run):
    return run.setup_s
