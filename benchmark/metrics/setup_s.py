"""Set-up seconds: from the process's start (the kernel's record of it) to
the first timed step, imports, builds, warm start and warm-up included."""


def read(ctx):
    return ctx.setup_s
