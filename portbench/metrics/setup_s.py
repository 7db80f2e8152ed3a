"""Set-up: process start to the window's start (imports, CUDA init,
weights and state made on the device, the kernels built or loaded, the
warm-up steps)."""


def read(run):
    return run.setup_s
