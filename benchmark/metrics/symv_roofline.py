"""symv_roofline: the SYMV kernel's share of its roofline in the traced
solve: the bytes one call needs (``peaks.symv_bytes`` at the call's n_pad)
at 3.35 TB/s, over the mean device time of a call. A call is one launch of
each kernel in KERNELS; calls are counted by the first."""

from benchmark import peaks

KERNELS = ("symv_upper_tiles", "symv_reduce")


def read(ctx):
    if not ctx.profile or not ctx.solves:
        return None
    got = peaks.kernel_time(ctx.profile["kernels"], KERNELS[0], KERNELS)
    if got is None:
        return None
    _, seconds = got
    return peaks.roofline_share(0.0, peaks.symv_bytes(ctx.solves[0]["n_pad"]),
                                seconds)
