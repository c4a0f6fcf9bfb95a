"""step_ms.gram: the first chunk's replayed Gram steps over their wall (the
program's ``trace.ts`` at the first chunk boundary, from ``run_fused``'s
start, over the chunk's iterations), in ms; the mean over the window's
solves."""


def read(ctx):
    vals = [1e3 * s["first_chunk_s"] / s["first_chunk_its"]
            for s in ctx.solves if "first_chunk_s" in s]
    return sum(vals) / len(vals) if vals else None
