"""eigh_roofline: the dense eigh kernel's share of its roofline in the
traced solve: 9 n^3 operations for the call's n (the traffic's subspace
dimension) at 67 TFLOP/s fp32, over the mean device time of a launch of
the kernels in KERNELS."""

from benchmark import peaks

KERNELS = ("sym_eigh_kernel",)


def read(ctx):
    if not ctx.profile:
        return None
    got = peaks.kernel_time(ctx.profile["kernels"], KERNELS[0], KERNELS)
    if got is None:
        return None
    _, seconds = got
    return peaks.roofline_share(
        peaks.eigh_flops(int(ctx.traffic["subspace_dim"])), 0.0, seconds)
