"""Host ms per step of the D update (`train.d_update`: G's no-grad forward,
D's loss, its gradient, Adam) in the traced steps, under the profiler, over
the program's own `train.steps`."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit("train.d_update", "total_ms", counter="train.steps")
