"""The median wait of the window's `DeepBedMap.predict` requests, each timed
to its host result, in ms."""


def read(ctx):
    return ctx["window"]["metrics"].get("region_p50_ms")
