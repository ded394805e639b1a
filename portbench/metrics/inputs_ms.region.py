"""Host ms per request of `get_model_inputs` (`predict.inputs`: five
`selective_tile` cuts, uploads and samples, the surface's NaN check) in the
traced requests, over the program's own `predict.requests`."""

from portbench.spans import per_unit


def read(ctx):
    return per_unit("predict.inputs", "total_ms", counter="predict.requests")
