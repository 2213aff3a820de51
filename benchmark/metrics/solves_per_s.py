"""Solves per second: B scenarios times the steps completed, over the whole
window (host clock; the window's every step, state generation included)."""


def read(ctx):
    return ctx.batch * ctx.steps / ctx.window_s
