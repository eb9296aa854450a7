"""setup_s: from the process's start to the window's start: imports, the
kernels' build or load, the frames and weights drawn from the seed, the
program's models, and the warm-up steps."""


def read(run):
    return run.setup_s
