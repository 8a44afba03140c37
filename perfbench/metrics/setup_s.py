"""Process start to the window's opening: imports, the kernels' build (the
first run of a checkout only), weights, engine, warm-up."""


def read(run):
    return run.setup_s
