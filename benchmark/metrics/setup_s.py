"""setup_s: seconds from the start of the process to the first measured
frame: imports, the card's initialisation, the kernel library's build or
load, the scene, the program's set-up and the warm-up."""


def read(ctx):
    return ctx.setup_s
