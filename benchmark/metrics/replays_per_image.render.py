"""replays_per_image.render: CUDA graphs replayed per image over the
window (utils/graphs.STATS["replays"]; the driver refuses a capture inside
the window). Moves samples_per_s."""


def read(ctx):
    n = ctx.counters.get("requests", 0)
    if "replays" not in ctx.counters or n == 0:
        return None
    return ctx.counters["replays"] / n
