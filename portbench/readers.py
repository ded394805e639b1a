"""What the per-layer readers under `metrics/` share. A reader takes the
traced run's context (the driver's `trace()` result, plus `window` and
`cell`) and returns its number, or None where it finds nothing to read."""

from __future__ import annotations

from typing import Optional

from portbench.counts import layers, model, peaks


def idle_share_pct(ctx) -> Optional[float]:
    """The device's idle share of the traced slice, in %: one minus the
    union of its kernels, copies and sets over the first-to-last device
    event."""
    trace = ctx.get("trace")
    return None if trace is None else 100.0 * trace["idle_share"]


def stage_ms(ctx, name: str) -> Optional[float]:
    """Device ms of one call of the generator's stage ``name`` (CUDA events
    around it), averaged over the slice's calls."""
    total, calls = ctx.get("stages_ms", {}).get(name, (0.0, 0))
    return total / calls if calls else None


def roofline_pct(bound_s: float, ms: Optional[float]) -> Optional[float]:
    return None if not ms else 100.0 * 1e3 * bound_s / ms


def generator_sizes(ctx):
    g = ctx["cell"].config["generator"]
    return g["num_residual_blocks"], g["base_channels"], g["growth_channels"]


def trunk_roofline_pct(ctx) -> Optional[float]:
    blocks, base, growth = generator_sizes(ctx)
    side = ctx["crop_lr"] - 2
    b = layers.trunk(ctx["batch"], side, blocks, base, growth,
                     ctx["cell"].config["precision"]["trunk"])
    return roofline_pct(b["s"], stage_ms(ctx, "trunk"))


def tail_roofline_pct(ctx) -> Optional[float]:
    _, base, _ = generator_sizes(ctx)
    b = layers.tail(ctx["batch"], 4 * (ctx["crop_lr"] - 2), base)
    return roofline_pct(b["s"], stage_ms(ctx, "tail"))


def generator_mfu_pct(ctx, rate_metric: str, tile_out: int) -> Optional[float]:
    """Useful FLOPs per second over the configuration's peak, in %: each
    tile's kept output alone (lr = tile_out / 4 + 2), at the window's rate."""
    rate = ctx["window"]["metrics"].get(rate_metric)
    if not rate:
        return None
    cfg = ctx["cell"].config
    flops = model.generator_tile_flops(cfg["generator"], tile_out // 4 + 2)["total"]
    return 100.0 * rate * flops / peaks.TENSOR_CORE_FLOPS[cfg["peak"]]
