"""Utilities of the port: PNG artifacts (:mod:`.plotting`), profiling
(:mod:`.profiling`) and numerical guards (:mod:`.debug`)."""
from gpvae_tpu_torch.utils.debug import (
    assert_finite,
    check_finite,
    enable_nan_debugging,
)
from gpvae_tpu_torch.utils.profiling import (
    StepTimer,
    clear_spans,
    device_memory_stats,
    span,
    spanned,
    spans,
    trace,
)

__all__ = [
    "trace",
    "span",
    "spanned",
    "spans",
    "clear_spans",
    "StepTimer",
    "device_memory_stats",
    "assert_finite",
    "check_finite",
    "enable_nan_debugging",
]
