"""setup_s: process start to the first timed call (imports, instance
generation, the port's builds on a checkout's first run, uploads, warm-up)."""


def read(ctx):
    return ctx["setup_s"]
