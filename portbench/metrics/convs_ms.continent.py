"""Device ms per forward of `models.blocks`' plain convs: CUDA events around
`Generator.head` (input block, pre-residual conv) and `Generator.upsample`
(post-residual conv, two nearest x2 + conv), at the cell's batch."""

from portbench.readers import stage_ms


def read(ctx):
    head, up = stage_ms(ctx, "head"), stage_ms(ctx, "upsample")
    return None if head is None or up is None else head + up
