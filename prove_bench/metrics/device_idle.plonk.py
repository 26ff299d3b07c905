"""Share of the traced window in which no operation ran on the device,
from the profiler's trace (plonk cells)."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
