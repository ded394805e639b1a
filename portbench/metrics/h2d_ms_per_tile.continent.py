"""Device ms of host-to-device copies per tile in the traced pass: the band
uploads of `inference.continent`'s band loop."""


def read(ctx):
    trace = ctx.get("trace")
    return None if trace is None else 1e3 * trace["htod_s"] / ctx["tiles_per_pass"]
