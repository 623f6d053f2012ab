"""colony_throughput: colony steps completed in the window × cells ÷ the
window's seconds (cell-steps/s)."""


def read(ctx):
    return ctx.steps * ctx.units / ctx.window_s
