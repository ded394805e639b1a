"""Device ms per forward of the tail's two offset convs with their float32
copies (`tail.offset_convs`, CUDA events), over the forwards of the traced
pass: the calls of `tail.deform64`, once a forward."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit("tail.offset_convs", "device_ms", calls_of="tail.deform64")
