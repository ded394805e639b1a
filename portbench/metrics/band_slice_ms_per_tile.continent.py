"""Host ms per tile of the band loop's slicing (`continent.slice`: the row
slice, the edge bands' vertical `np.pad`, the contiguous copy) in the traced
pass, over the program's own `continent.tiles`."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit("continent.slice", "total_ms", counter="continent.tiles")
