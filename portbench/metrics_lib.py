"""Arithmetic the per-layer readers share."""
from __future__ import annotations

from portbench.peaks import PEAK_FLOPS


def roofline(ctx) -> float | None:
    """100 x the summed least time of the kernel groups whose launches
    match their count, over those launches' device time."""
    tr = ctx.trace
    bound = spent = 0.0
    for g in ctx.groups():
        idx = tr.kernel_idx(g["kernels"])
        if len(idx) != g["launches"] * tr.units:
            continue
        bound += g["bound_s"] * tr.units
        spent += tr.seconds(idx)
    return 100.0 * bound / spent if spent > 0 else None


def mfu(ctx) -> float:
    """100 x the time the window's work takes at peak over the window."""
    at_peak = sum(flops / PEAK_FLOPS[prec] for _, flops, prec in ctx.terms())
    return 100.0 * at_peak * ctx.window_units / ctx.window_s
