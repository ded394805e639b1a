"""Host ms per tile of the band loop's blocking fetch (`continent.fetch`:
`strip.cpu()`, the wait for the band's forward and its copy back) in the
traced pass, over the program's own `continent.tiles`."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit("continent.fetch", "total_ms", counter="continent.tiles")
