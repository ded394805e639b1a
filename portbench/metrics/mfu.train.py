"""FLOPs per second of the window's training steps over the configuration's
peak, in %: `train_step_flops` (D and G updates, both Adams) per step of the
configuration's batch."""

from portbench.counts import model, peaks


def read(ctx):
    rate = ctx["window"]["metrics"].get("train_tiles_per_s")
    if not rate:
        return None
    cfg = ctx["cell"].config
    batch = cfg["train"]["batch_size"]
    flops = model.train_step_flops(cfg["generator"], batch=batch)["total"]
    return 100.0 * rate / batch * flops / peaks.TENSOR_CORE_FLOPS[cfg["peak"]]
