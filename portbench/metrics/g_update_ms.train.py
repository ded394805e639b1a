"""Host ms per step of the G update (`train.g_update`: G's loss, its gradient
through the plain twins, Adam) in the traced steps, under the profiler,
over the program's own `train.steps`."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit("train.g_update", "total_ms", counter="train.steps")
