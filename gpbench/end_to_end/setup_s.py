"""setup_s (s): from the start of the process to the first timed request:
imports, the data from the seed, construction, the structure pass, the
warm-up requests and the kernel library's load."""


def read(ctx):
    return ctx.setup_s
