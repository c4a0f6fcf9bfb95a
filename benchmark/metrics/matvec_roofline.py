"""matvec_roofline: the matvec kernel's share of its roofline in the traced
solve: the bytes one call needs (``matvec_bytes`` of the dense copies the
products read, A and A^T, whose bytes lie within 0.01% of each other) at
3.35 TB/s, over the mean device time of a launch of the kernels in
KERNELS."""

from benchmark import peaks

KERNELS = ("matvec_stream",)


def matvec_bytes(rows: int, cols: int, ld: int, itemsize: int = 4) -> int:
    """Bytes one y = K x needs from device memory, each once: the rows of K
    at their leading dimension ``ld``, x in and y out (59.9 MB for w8a's A,
    49,749 x 300, and for its A^T, 300 x 49,749 at ld 49,752)."""
    return rows * ld * itemsize + (rows + cols) * 4


def read(ctx):
    shapes = getattr(ctx, "matvec_shapes", None)
    if not ctx.profile or not shapes:
        return None
    got = peaks.kernel_time(ctx.profile["kernels"], KERNELS[0], KERNELS)
    if got is None:
        return None
    _, seconds = got
    nbytes = sum(matvec_bytes(*s) for s in shapes) / len(shapes)
    return peaks.roofline_share(0.0, nbytes, seconds)
