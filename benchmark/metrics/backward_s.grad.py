"""backward_s.grad: the mean seconds of autograd's backward a step over the
window, from a host span that synchronises before and after it (only in a
traced run: the untraced window does not synchronise there). Moves
grad_step_s."""


def read(ctx):
    return ctx.counters.get("backward_s")
