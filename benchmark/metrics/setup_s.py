"""setup_s: from the process's start to the window's: imports, the data, the
CUDA context and kernel loads (an nvcc build on a checkout's first run), the
device data and a warm solve. What runs after the window (the Gram race's
f*, the check) is not in it."""


def read(ctx):
    return ctx.setup_s
