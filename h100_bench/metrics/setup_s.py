"""Process start to the first timed request: the CUDA context, the
library (and nvcc on a checkout's first run), the weights, the capture
and warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
