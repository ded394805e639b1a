"""Host ms per tile of the band uploads (`continent.upload`: each raster's
`.to(device)`, the host's staging and its wait on the stream) in the traced
pass, over the program's own `continent.tiles`."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit("continent.upload", "total_ms", counter="continent.tiles")
