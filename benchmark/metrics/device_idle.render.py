"""device_idle.render: the share of the profiled window, in %, in which no
operation ran on the card: 1 less the union of the device operations'
intervals over the window (harness/profile.py). Moves samples_per_s."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.trace.idle_share
