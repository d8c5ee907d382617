"""Start of the process to the start of the window (host clock): imports,
CUDA set-up, making the rows, the program's build, warm-up, and in the
first run of a checkout the kernels' nvcc build."""


def read(run):
    return run.setup_s
