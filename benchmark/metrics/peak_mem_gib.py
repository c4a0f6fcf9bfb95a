"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the measured
window (the peak is reset as the window opens), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
