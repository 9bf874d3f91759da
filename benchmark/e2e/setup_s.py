"""setup_s: seconds from the start of the process to the first timed
request (imports, data, load, first search, training wait, warm-up)."""


def read(ctx):
    return ctx.setup_s
