"""Process start to the window's start: imports, CUDA start-up, loading
the kernels (building them on a checkout's first run), the seeded
content and the warm-up texture."""


def read(run):
    return run.setup_s
