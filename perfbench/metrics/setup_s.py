"""setup_s (host clock): from the process's start to the first timed call:
imports, the CUDA context, the load (or first build) of the port's nvcc
libraries, the inputs of the warm-up call and that call."""


def read(run):
    return run.setup_s
