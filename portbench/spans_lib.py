"""Arithmetic the span readers share: the port's own span records
(``gpvae_tpu_torch.utils.profiling.spans``) of the profiled stretch,
summed and divided by the count of the stretch's unit spans,
``gpvae.step`` in training and ``gpvae.impute`` in imputation.

The port records spans only while the profiler collects, so the buffer
holds the stretch's records alone: set-up and the window leave none, and
a retaken stretch adds whole units.  A port without spans, a run without
a profiled stretch, and a stretch without a unit span give nothing to
read."""
from __future__ import annotations

import importlib

from portbench.harness import PACKAGE

UNIT = {"train": "gpvae.step", "impute": "gpvae.impute"}


def records(ctx, kind: str) -> list | None:
    """The port's span records of the stretch, in a cell of ``kind``
    with a profiled stretch; None otherwise, or where the port has no
    spans."""
    if ctx.trace is None or ctx.kind != kind:
        return None
    try:
        profiling = importlib.import_module(f"{PACKAGE}.utils.profiling")
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def host_self_ms(recs: list, name: str, less=()) -> float:
    """Summed host milliseconds of the spans ``name``, each less those of
    its direct children whose names are in ``less``."""
    taken: dict[int, float] = {}
    for r in recs:
        if r.name in less and r.parent is not None:
            taken[r.parent] = taken.get(r.parent, 0.0) + r.host_ms
    return sum(r.host_ms - taken.get(r.id, 0.0)
               for r in recs if r.name == name)


def _stretch(ctx, kind: str, name: str):
    """``(records, the spans name, units)``, or None where there is
    nothing to read."""
    recs = records(ctx, kind)
    if not recs:
        return None
    units = sum(r.name == UNIT[kind] for r in recs)
    mine = [r for r in recs if r.name == name]
    return (recs, mine, units) if units and mine else None


def host_ms_per_unit(ctx, kind: str, name: str, less=()) -> float | None:
    """Host milliseconds per unit in the spans ``name``, less their
    children named in ``less``."""
    got = _stretch(ctx, kind, name)
    if got is None:
        return None
    recs, _, units = got
    return host_self_ms(recs, name, less) / units


def device_ms_per_unit(ctx, kind: str, name: str) -> float | None:
    """Device milliseconds per unit between the spans ``name``'s two
    events; None where any of them has no device interval."""
    got = _stretch(ctx, kind, name)
    if got is None:
        return None
    _, mine, units = got
    if any(r.device_ms is None for r in mine):
        return None
    return sum(r.device_ms for r in mine) / units
