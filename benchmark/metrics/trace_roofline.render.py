"""trace_roofline.render: the trace kernels' least time over their device
time, in %, over the profiled requests. Least time: the bytes their
queries need (harness/queries.py: each ray read once, each hit written
once, the scene's triangles read once a launch) over the card's HBM rate
(harness/peaks.json). Device time: the profiler's, summed over the
kernels the entries name (benchmark/kernels/*.json). Nothing where no
trace kernel ran or the card has no row in the table. Moves
samples_per_s."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or ctx.tally is None:
        return None
    device_s = ctx.trace.kernel_seconds(ctx.tally.kernels)
    if device_s <= 0 or ctx.tally.bytes == 0:
        return None
    return 100.0 * (ctx.tally.bytes / ctx.peaks["hbm_bytes_per_s"]) / device_s
