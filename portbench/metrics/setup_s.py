"""Seconds from the process's start to the window's: importing torch,
the CUDA context, loading (on a checkout's first run: building) the
kernel library, generating the pool and one warm request."""


def read(ctx):
    return ctx.setup_s
